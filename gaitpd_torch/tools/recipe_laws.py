"""The training recipe's draws held by their laws on one device.

    python -m gaitpd_torch.tools.recipe_laws [--device cuda] [--seed 0]

Draws from a ``torch.Generator`` on the device through the step's own
functions and checks, each within 5 sigma:

* ``augment_stream`` at zero strengths returns its input (``==``);
* the noise's sample std over about 10^6 entries is ``noise_std``;
* the axis-mask gate fires at rate ``axis_p``, each gated sample has
  exactly one zeroed channel (all its frames), the others none, and the
  zeroed channels are uniform (chi-squared within 5 sigma of its mean);
* modality dropout keeps each of 3 streams with probability
  (1 - p) + p^3 / 3 and never drops all three.

Raises AssertionError on the first law that fails (also under ``python
-O``); returns the statistics.
"""

from __future__ import annotations

import argparse
import math
from typing import Dict

import torch

from gaitpd_torch.data.augment import AugmentSpec, augment_stream, make_aug_params
from gaitpd_torch.train.step import draw_modality_dropout, modality_dropout

SIGMAS = 5.0
WIDTHS = (2, 13, 24)  # the flagship's walkway, insole and IMU channels


def _law(holds, message: str) -> None:
    if not holds:
        raise AssertionError(message)


def check_augment_laws(device, seed: int = 0, n_samples: int = 20_000, t: int = 64,
                       noise_entries: int = 1_000_000, noise_std: float = 0.05,
                       axis_p: float = 0.2) -> Dict[str, float]:
    """The augmentation's laws at each of the flagship's widths."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    both = AugmentSpec(noise=True, axis_mask=True)
    out: Dict[str, float] = {}
    for c in WIDTHS:
        x = torch.randn((64, t, c), generator=gen, device=dev)
        same = augment_stream(x, gen, both, make_aug_params(device=dev))
        _law(bool((same == x).all()), f"C={c}: augmentation at zero strengths moved x")

        z = torch.zeros((noise_entries // (t * c) + 1, t, c), device=dev)
        noise = augment_stream(z, gen, AugmentSpec(noise=True),
                               make_aug_params(noise_std=noise_std, device=dev)).double()
        n = noise.numel()
        std = float(noise.std())
        sigma = noise_std / math.sqrt(2.0 * n)
        out[f"noise_std_sigmas_c{c}"] = (std - noise_std) / sigma
        _law(abs(std - noise_std) <= SIGMAS * sigma,
             f"C={c}: noise std {std} over {n} entries, want {noise_std} (sigma {sigma:.2e})")

        ones = torch.ones((n_samples, t, c), device=dev)
        masked = augment_stream(ones, gen, AugmentSpec(axis_mask=True),
                                make_aug_params(axis_p=axis_p, device=dev))
        zero_frames = (masked == 0).sum(1)  # (B, C): frames zeroed per channel
        _law(bool(((zero_frames == 0) | (zero_frames == t)).all()),
             f"C={c}: a channel was zeroed in part of its frames")
        zeroed = (zero_frames == t).sum(1)  # channels zeroed per sample
        _law(int(zeroed.max()) <= 1, f"C={c}: a sample lost more than one channel")
        gated = int(zeroed.sum())
        sigma = math.sqrt(n_samples * axis_p * (1 - axis_p))
        out[f"gate_sigmas_c{c}"] = (gated - n_samples * axis_p) / sigma
        _law(abs(gated - n_samples * axis_p) <= SIGMAS * sigma,
             f"C={c}: {gated} of {n_samples} samples gated, want rate {axis_p}")
        counts = (zero_frames == t).sum(0).double()
        expect = gated / c
        chi2 = float(((counts - expect) ** 2 / expect).sum())
        bound = (c - 1) + SIGMAS * math.sqrt(2.0 * (c - 1))
        out[f"channel_chi2_c{c}"] = chi2
        _law(chi2 <= bound, f"C={c}: zeroed channels not uniform, chi2 {chi2:.1f} > {bound:.1f}")
    return out


def check_modality_dropout_law(device, seed: int = 0, n_draws: int = 20_000,
                               p: float = 0.3) -> Dict[str, float]:
    """Modality dropout over ``n_draws`` batches of 3 streams."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ones = tuple(torch.ones(1, device=dev) for _ in range(3))
    kept = torch.stack([torch.cat(modality_dropout(ones, *draw_modality_dropout(3, p, gen, dev)))
                        for _ in range(n_draws)]).cpu()
    _law(bool((kept.sum(1) > 0).all()), "modality dropout dropped all three streams")
    want = (1 - p) + p ** 3 / 3
    sigma = math.sqrt(n_draws * want * (1 - want))
    out = {}
    for i, k in enumerate(kept.sum(0).tolist()):
        out[f"keep_sigmas_stream{i}"] = (k - n_draws * want) / sigma
        _law(abs(k - n_draws * want) <= SIGMAS * sigma,
             f"stream {i} kept {k} of {n_draws} times, want rate {want:.4f}")
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    print(check_augment_laws(args.device, args.seed))
    print(check_modality_dropout_law(args.device, args.seed))


if __name__ == "__main__":
    main()
