"""Train-time augmentation of the sensor streams inside the train step.
The port's own copy of gaitpd/data/augment.py:108-226 (the sensor branch).

Each stream's augmentation is split in two: ``draw_augment`` takes the
random numbers from an explicit ``torch.Generator`` (on the stream's
device), and ``apply_augment`` is a pure function of the stream, the
strengths and those draws, so a test can feed gaitpd's own draws to it.
The draws of one stream, in this order:

* ``gate_u`` (B,) uniform in [0, 1): the per-sample axis-mask gate is
  ``gate_u < axis_p``, which is how ``jax.random.bernoulli`` draws;
* ``channel`` (B,) in [0, C): the channel each gated sample loses;
* ``noise``: N(0, 1) of the stream's shape and dtype.

The strengths (``make_aug_params``) are 0-dim float32 tensors on the device,
so no step reads a number back from it; every transform is the identity at
strength 0. The skeleton transforms (``spec.joints``, mirror, rotation) and
the reader-level ``augment_reader`` serve the FBG/FoG path, not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

SKELETON_ITEM = "the FBG/FoG path (ROADMAP Queue 1, item 11)"


@dataclasses.dataclass(frozen=True)
class AugmentSpec:
    """Which transforms exist for one input stream (gaitpd/data/augment.py:
    149-164); their strengths ride in the step's ctx."""

    joints: Optional[int] = None  # a skeleton stream's joint count
    mirror: bool = False  # per-sample horizontal flip (joints only)
    rotation: bool = False  # per-sample random 3-D rotation (joints only)
    noise: bool = False  # additive gaussian jitter
    axis_mask: bool = False  # zero one random channel of a gated sample


def _check_sensor(spec: AugmentSpec) -> None:
    if spec.joints or spec.mirror or spec.rotation:
        raise NotImplementedError(
            f"skeleton augmentation (joints, mirror, rotation) serves {SKELETON_ITEM}")


def mask_channel(x: torch.Tensor, channel: torch.Tensor) -> torch.Tensor:
    """Multiply the last-axis entry ``channel[n]`` of each sample n by 0 (so
    a NaN stays NaN), as gaitpd's ``axis_mask`` does (:115-123)."""
    c = x.shape[-1]
    keep = 1.0 - torch.nn.functional.one_hot(channel, c).to(x.dtype)
    return x * keep.reshape((x.shape[0],) + (1,) * (x.dim() - 2) + (c,))


def axis_mask(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Zero one random last-axis entry per sample (gaitpd/data/augment.py:115)."""
    channel = torch.randint(0, x.shape[-1], (x.shape[0],), generator=generator,
                            device=x.device)
    return mask_channel(x, channel)


def random_noise(x: torch.Tensor, generator: torch.Generator, mean: float = 0.0,
                 std: float = 0.01) -> torch.Tensor:
    """Additive gaussian jitter (gaitpd/data/augment.py:108)."""
    return x + mean + std * torch.randn(x.shape, generator=generator, dtype=x.dtype,
                                        device=x.device)


def draw_augment(x: torch.Tensor, spec: AugmentSpec,
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The random numbers one stream's augmentation takes, in the module
    docstring's order; only those of the transforms ``spec`` has."""
    _check_sensor(spec)
    if generator is None:
        raise ValueError("augmentation draws from the step's generator: pass one")
    b, dev = x.shape[0], x.device
    draws = {}
    if spec.axis_mask:
        draws["gate_u"] = torch.rand((b,), generator=generator, device=dev)
        draws["channel"] = torch.randint(0, x.shape[-1], (b,), generator=generator,
                                         device=dev)
    if spec.noise:
        draws["noise"] = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=dev)
    return draws


def apply_augment(x: torch.Tensor, spec: AugmentSpec, params: Dict[str, torch.Tensor],
                  draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The sensor branch of gaitpd's ``augment_stream`` (:201-209) on given
    draws: the gated channel mask, then ``noise_std`` times the noise. The
    result keeps ``x``'s dtype."""
    _check_sensor(spec)
    in_dtype = x.dtype
    if spec.axis_mask:
        gate = draws["gate_u"] < params["axis_p"]
        x = torch.where(gate[:, None, None], mask_channel(x, draws["channel"]), x)
    if spec.noise:
        x = x + params["noise_std"] * draws["noise"]
    return x.to(in_dtype)


def augment_stream(x: torch.Tensor, generator: torch.Generator, spec: AugmentSpec,
                   params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Batched train-time augmentation of one (B, T, C) sensor stream."""
    return apply_augment(x, spec, params, draw_augment(x, spec, generator))


def make_aug_params(mirror_p=0.0, rot_deg=0.0, noise_std=0.0, axis_p=0.0,
                    device=None) -> Dict[str, torch.Tensor]:
    """The strengths ``augment_stream`` reads, as 0-dim float32 tensors."""
    return {k: torch.tensor(float(v), dtype=torch.float32, device=device)
            for k, v in (("mirror_p", mirror_p), ("rot_deg", rot_deg),
                         ("noise_std", noise_std), ("axis_p", axis_p))}


def augment_reader(*args, **kwargs):
    """gaitpd/data/augment.py:237: augmented copies of a skeleton reader."""
    raise NotImplementedError(f"augment_reader serves {SKELETON_ITEM}")
