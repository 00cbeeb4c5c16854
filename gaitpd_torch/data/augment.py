"""Skeleton topology and train-time augmentation inside the train step.
The port's own copy of gaitpd/data/augment.py:22-283 (reference
train/data_processing/common.py:7-385): the batched transforms of pose
stacks, the in-step augmentation of skeleton and sensor streams, and the
reader-level ``augment_reader``.

Each stream's in-step augmentation is split in two: ``draw_augment`` takes
the random numbers from an explicit ``torch.Generator`` (on the stream's
device), and ``apply_augment`` is a pure function of the stream, the
strengths and those draws, so a test can feed gaitpd's own draws to it.
The draws of one stream, in this order, each only where ``spec`` has its
transform:

* ``mirror_u`` (B,) uniform in [0, 1): the per-sample mirror gate is
  ``mirror_u < mirror_p``, which is how ``jax.random.bernoulli`` draws
  (skeleton streams);
* ``rot_axis`` (B,) in [0, 3), ``rot_main_u`` (B,) and ``rot_rest_u``
  (B, 3) uniform in [0, 1): the rotation's main axis, its angle, and the
  other axes' tenth-strength angles, as ``jax.random.uniform`` scales its
  unit draws (skeleton streams);
* ``gate_u`` (B,) uniform in [0, 1): the axis-mask gate, ``gate_u < axis_p``;
* ``channel`` (B,): the coordinate axis (in [0, 3)) of a skeleton stream,
  the channel (in [0, C)) of a sensor stream, that a gated sample loses;
* ``noise``: N(0, 1) of the stream's shape and dtype.

A sensor stream's draws (gate, channel, noise) are those of the WearGait
recipe, unchanged. The strengths (``make_aug_params``) are 0-dim float32
tensors on the device, so no step reads a number back from it; every
transform is the identity at strength 0.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gaitpd_torch.runtime import fold_draws

# H36M 17-joint topology (reference common.py:7-44)
H36M_FULL = {
    "B.TORSO": 0, "L.HIP": 1, "L.KNEE": 2, "L.FOOT": 3,
    "R.HIP": 4, "R.KNEE": 5, "R.FOOT": 6,
    "C.TORSO": 7, "U.TORSO": 8, "NECK": 9, "HEAD": 10,
    "R.SHOULDER": 11, "R.ELBOW": 12, "R.HAND": 13,
    "L.SHOULDER": 14, "L.ELBOW": 15, "L.HAND": 16,
}

H36M_CONNECTIONS_FULL = {
    (0, 1), (0, 4), (4, 5), (5, 6), (1, 2), (2, 3), (0, 7), (7, 8),
    (8, 14), (14, 15), (15, 16), (8, 11), (11, 12), (12, 13), (8, 9), (9, 10),
}

# mirror pairs in H36M order (reference common.py:103-104)
H36M_LEFT = (14, 15, 16, 1, 2, 3)
H36M_RIGHT = (11, 12, 13, 4, 5, 6)


@dataclasses.dataclass(frozen=True)
class AugmentSpec:
    """Which transforms exist for one input stream (gaitpd/data/augment.py:
    149-164); their strengths ride in the step's ctx."""

    joints: Optional[int] = None  # a skeleton stream's joint count
    mirror: bool = False  # per-sample horizontal flip (joints only)
    rotation: bool = False  # per-sample random 3-D rotation (joints only)
    noise: bool = False  # additive gaussian jitter
    axis_mask: bool = False  # zero one random coordinate axis / channel of a gated sample


# ---------------------------------------------------------------------------
# Batched transforms of pose stacks (reference common.py:93-273)
# ---------------------------------------------------------------------------


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim tensor on ``like``'s device: CUDA divides by a Python number
    through its reciprocal, and filling needs no host copy."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _permute_joints(x: torch.Tensor, perm: np.ndarray) -> torch.Tensor:
    """``x[..., perm, :]`` as a concatenation of slices, one a run of
    consecutive indices: no index tensor is copied to the device."""
    runs, start = [], 0
    for i in range(1, len(perm) + 1):
        if i == len(perm) or perm[i] != perm[i - 1] + 1:
            runs.append(x[..., int(perm[start]):int(perm[i - 1]) + 1, :])
            start = i
    return torch.cat(runs, dim=-2)


def mirror_reflection(x: torch.Tensor, left=H36M_LEFT, right=H36M_RIGHT) -> torch.Tensor:
    """Horizontal flip: negate the x coordinate and swap the left and right
    joints (reference MirrorReflection, common.py:93-129). x: (..., J, C).
    A skeleton with fewer joints than the pairs name (the 7-keypoint FoG
    poses) gets the flip alone."""
    first = torch.arange(x.shape[-1], device=x.device) == 0
    x = x * torch.where(first, _const(-1.0, x), _const(1.0, x))
    j = x.shape[-2]
    if max(max(left), max(right)) >= j:
        return x
    perm = np.arange(j)
    perm[list(left)] = right
    perm[list(right)] = left
    return _permute_joints(x, perm)


def rotation_matrix_3d(angles_deg: torch.Tensor) -> torch.Tensor:
    """Rz @ Ry @ Rx from degree angles (..., 3) -> (..., 3, 3)
    (reference common.py:371-385)."""
    rad = angles_deg * _const(math.pi / 180.0, angles_deg)
    a, b, g = rad[..., 0], rad[..., 1], rad[..., 2]
    one, zero = torch.ones_like(a), torch.zeros_like(a)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    rx = mat([[one, zero, zero], [zero, a.cos(), -a.sin()], [zero, a.sin(), a.cos()]])
    ry = mat([[b.cos(), zero, b.sin()], [zero, one, zero], [-b.sin(), zero, b.cos()]])
    rz = mat([[g.cos(), -g.sin(), zero], [g.sin(), g.cos(), zero], [zero, zero, one]])
    return rz @ ry @ rx


def rotation_angles(axis: torch.Tensor, main_u: torch.Tensor, rest_u: torch.Tensor,
                    min_deg: torch.Tensor, max_deg: torch.Tensor) -> torch.Tensor:
    """(n, 3) angles: ``max(lo, u * (hi - lo) + lo)`` as jax.random.uniform
    scales a unit draw, full strength [min_deg, max_deg) on the main axis,
    a tenth of it on the others (reference RandomRotation,
    common.py:183-201). The multiply-add rounds once, as XLA's fused one
    does: it runs in float64, where u * (hi - lo) is exact."""
    ten = _const(10.0, min_deg)

    def scale(u, lo, hi):
        fused = (u.double() * (hi - lo).double() + lo.double()).to(u.dtype)
        return torch.maximum(lo, fused)

    full = scale(main_u, min_deg, max_deg)
    rest = scale(rest_u, min_deg / ten, max_deg / ten)
    main = torch.nn.functional.one_hot(axis.long(), 3).to(torch.bool)
    return torch.where(main, full[:, None], rest)


def rotate(x: torch.Tensor, rots: torch.Tensor) -> torch.Tensor:
    """x (N, T, J, 3) times each sample's (3, 3) matrix, row vectors on the
    left."""
    return torch.einsum("ntjc,ncd->ntjd", x, rots)


def random_rotation(x: torch.Tensor, generator: torch.Generator, min_deg: float,
                    max_deg: float, per_sample: bool = True) -> torch.Tensor:
    """Random 3-D rotation of (N, T, J, 3): a full-strength angle on one
    random main axis, a tenth of it on the others."""
    n = x.shape[0] if per_sample else 1
    dev = x.device
    axis = torch.randint(0, 3, (n,), generator=generator, device=dev)
    main_u = torch.rand((n,), generator=generator, device=dev)
    rest_u = torch.rand((n, 3), generator=generator, device=dev)
    angles = rotation_angles(axis, main_u, rest_u, _const(min_deg, main_u),
                             _const(max_deg, main_u))
    rots = rotation_matrix_3d(angles)
    if not per_sample:
        rots = rots.expand(x.shape[0], 3, 3)
    return rotate(x, rots.to(x.dtype))


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


def joint_dropout(x: torch.Tensor, generator: torch.Generator,
                  dropout_prob: float) -> torch.Tensor:
    """Zero whole joints of (N, T, J, C), each with probability
    ``dropout_prob`` a sample (reference common.py:338-342)."""
    keep = torch.rand((x.shape[0], x.shape[2]), generator=generator,
                      device=x.device) < 1.0 - dropout_prob
    return x * keep[:, None, :, None].to(x.dtype)


def random_translation(x: torch.Tensor, generator: torch.Generator,
                       translation_range: Tuple[float, float]) -> torch.Tensor:
    """One translation a sample of (N, T, J, C), uniform in the range a
    coordinate (reference common.py:350-355)."""
    lo, hi = translation_range
    u = torch.rand((x.shape[0], 1, 1, x.shape[-1]), generator=generator, device=x.device,
                   dtype=x.dtype)
    return x + (lo + (hi - lo) * u)


# ---------------------------------------------------------------------------
# In-step augmentation: draw, then apply
# ---------------------------------------------------------------------------


def _check(x: torch.Tensor, spec: AugmentSpec) -> None:
    if (spec.mirror or spec.rotation) and not spec.joints:
        raise ValueError("mirror and rotation act on joints: give the spec its joint count")
    if spec.joints and x.shape[-1] != 3 * spec.joints:
        raise ValueError(f"a skeleton stream of {spec.joints} joints has {3 * spec.joints} "
                         f"channels, got {x.shape[-1]}")


def draw_augment(x: torch.Tensor, spec: AugmentSpec,
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The random numbers one stream's augmentation takes, in the module
    docstring's order; only those of the transforms ``spec`` has."""
    _check(x, spec)
    if generator is None:
        raise ValueError("augmentation draws from the step's generator: pass one")
    b, dev = x.shape[0], x.device
    draws = {}
    if spec.joints and spec.mirror:
        draws["mirror_u"] = fold_draws.rand((b,), generator, device=dev)
    if spec.joints and spec.rotation:
        draws["rot_axis"] = fold_draws.randint(0, 3, (b,), generator, device=dev)
        draws["rot_main_u"] = fold_draws.rand((b,), generator, device=dev)
        draws["rot_rest_u"] = fold_draws.rand((b, 3), generator, device=dev)
    if spec.axis_mask:
        n_axes = 3 if spec.joints else x.shape[-1]
        draws["gate_u"] = fold_draws.rand((b,), generator, device=dev)
        draws["channel"] = fold_draws.randint(0, n_axes, (b,), generator, device=dev)
    if spec.noise:
        draws["noise"] = fold_draws.randn(x.shape, generator, dtype=x.dtype, device=dev)
    return draws


def apply_augment(x: torch.Tensor, spec: AugmentSpec, params: Dict[str, torch.Tensor],
                  draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """gaitpd's ``augment_stream`` (:166-209) on given draws. A skeleton
    stream (B, T, J*3) is viewed as (B, T, J, 3): the gated mirror, the
    rotation, then the gated mask of one coordinate axis; a sensor stream
    takes the gated mask of one channel. Then ``noise_std`` times the noise.
    The result keeps ``x``'s dtype."""
    _check(x, spec)
    in_dtype = x.dtype
    if spec.joints:
        shape = x.shape
        s = x.reshape(x.shape[0], x.shape[1], spec.joints, 3)
        if spec.mirror:
            flip = draws["mirror_u"] < params["mirror_p"]
            s = torch.where(flip[:, None, None, None], mirror_reflection(s), s)
        if spec.rotation:
            rot = params["rot_deg"]
            angles = rotation_angles(draws["rot_axis"], draws["rot_main_u"],
                                     draws["rot_rest_u"], -rot, rot)
            s = rotate(s, rotation_matrix_3d(angles)).to(s.dtype)
        if spec.axis_mask:
            gate = draws["gate_u"] < params["axis_p"]
            s = torch.where(gate[:, None, None, None], mask_channel(s, draws["channel"]), s)
        x = s.reshape(shape)
    elif spec.axis_mask:
        gate = draws["gate_u"] < params["axis_p"]
        x = torch.where(gate[:, None, None], mask_channel(x, draws["channel"]), x)
    if spec.noise:
        x = x + params["noise_std"] * draws["noise"]
    return x.to(in_dtype)


def augment_stream(x: torch.Tensor, generator: torch.Generator, spec: AugmentSpec,
                   params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Batched train-time augmentation of one (B, T, C) stream."""
    return apply_augment(x, spec, params, draw_augment(x, spec, generator))


def make_aug_params(mirror_p=0.0, rot_deg=0.0, noise_std=0.0, axis_p=0.0,
                    device=None) -> Dict[str, torch.Tensor]:
    """The strengths ``augment_stream`` reads, as 0-dim float32 tensors."""
    return {k: torch.tensor(float(v), dtype=torch.float32, device=device)
            for k, v in (("mirror_p", mirror_p), ("rot_deg", rot_deg),
                         ("noise_std", noise_std), ("axis_p", axis_p))}


# ---------------------------------------------------------------------------
# Reader-level augmentation (reference common.py:276-362)
# ---------------------------------------------------------------------------


def estimate_translation_range(pose_dict, frac: float) -> Tuple[float, float]:
    """±frac of the global coordinate range (common.py:357-362)."""
    lo = min(float(np.min(p)) for p in pose_dict.values())
    hi = max(float(np.max(p)) for p in pose_dict.values())
    r = frac * (hi - lo)
    return (-r, r)


def augment_reader(reader, augmentation_list: Sequence[str], params: Dict, seed: int = 0):
    """A deep copy of ``reader`` with an augmented copy of every pose
    sequence, keyed ``{name}_{augmentation}`` and labelled as its source
    (reference PoseSequenceAugmentation.augment_data, common.py:286-327).
    The draws come from a CPU ``torch.Generator`` seeded with ``seed``, one
    augmentation after another; the mirror draws nothing."""
    generator = torch.Generator().manual_seed(seed)
    trans_range = None
    if "random_translation" in augmentation_list:
        trans_range = estimate_translation_range(
            reader.pose_dict, params.get("translation_frac", 0.1))

    out = copy.deepcopy(reader)
    labels_attr = "labels_dict" if hasattr(reader, "labels_dict") else "pose_label_dict"
    labels = getattr(out, labels_attr)
    new_poses, new_labels = {}, {}
    for name, seq in reader.pose_dict.items():
        x = torch.from_numpy(np.asarray(seq, np.float32))[None]  # (1, T, J, 3)
        for aug in augmentation_list:
            if aug == "mirror_reflection":
                y = mirror_reflection(x)
            elif aug == "joint_dropout":
                y = joint_dropout(x, generator, params.get("dropout_prob", 0.1))
            elif aug == "random_rotation":
                lo, hi = params.get("rotation_range", (-10.0, 10.0))
                y = random_rotation(x, generator, lo, hi)
            elif aug == "random_translation":
                y = random_translation(x, generator, trans_range)
            else:
                print(f"Warning: Unknown augmentation technique '{aug}'")
                continue
            aug_name = f"{name}_{aug}"
            new_poses[aug_name] = y[0].numpy()
            label_key = name if name in labels else "_".join(name.split("_")[:2])
            if label_key in labels:
                new_labels[aug_name] = labels[label_key]
    out.pose_dict.update(new_poses)
    labels.update(new_labels)
    return out
