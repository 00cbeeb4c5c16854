"""Synthetic WearGait streams for tests and CPU-runnable end-to-end runs.
The port's own copy of gaitpd/data/synthetic.py:29-57,155-195: the same
numpy draws in the same order, so a seed gives the same streams as gaitpd.

Per subject: walkway (T, 2), insole (T, 13), imu (T, 24) at 30 Hz. Each
class shifts the stream mean and the oscillation frequency, so small models
learn (loss decreases, accuracy above chance).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _signal(
    rng, t: int, c: int, label: int, strength: float = 1.0,
    per_channel: bool = False,
) -> np.ndarray:
    """Gaussian noise plus a class wave and offset, common to all channels,
    or, with per_channel, scaled by a class-fixed gain per channel drawn
    from its own seeded generator (the main stream's draws do not change)."""
    base = rng.normal(0.0, 1.0, size=(t, c)).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi)
    freq = 0.05 * (1 + label)
    wave = np.sin(2 * np.pi * freq * np.arange(t) + phase)[:, None]
    if per_channel:
        amp = np.random.default_rng(9700 + label).uniform(
            0.5, 1.5, size=(1, c)
        ).astype(np.float32)
        return base + strength * amp * (wave + 0.5 * label)
    return base + strength * (wave + 0.5 * label)


def make_weargait_streams(
    n_pd: int = 12,
    n_hc: int = 12,
    t_frames: int = 400,
    seed: int = 0,
    tie_free: bool = False,
    strength: float = 0.8,
) -> Tuple[Dict[str, Dict[str, np.ndarray]], List[str], List[str]]:
    """Per-subject {walkway (T,2), insole (T,13), imu (T,24)} streams with a
    PD-vs-HC separable signal; NaNs sprinkled into insole/imu (about 0.5 %)
    to exercise the NaN guards of the pipeline.

    tie_free: PD and HC stream lengths from disjoint ranges (PD strictly
    longer), so per-class train window counts never tie in a fold with
    equal subjects per class."""
    rng = np.random.default_rng(seed)
    streams = {}
    pd_ids = [f"PD{i:03d}" for i in range(n_pd)]
    hc_ids = [f"HC{i:03d}" for i in range(n_hc)]
    for sid in pd_ids + hc_ids:
        label = 1 if sid.startswith("PD") else 0
        if tie_free:
            lo, hi = (40, 90) if label == 1 else (-90, -40)
            t = t_frames + int(rng.integers(lo, hi))
        else:
            t = t_frames + int(rng.integers(-50, 50))
        sub = {
            "walkway": _signal(rng, t, 2, label, strength=strength),
            "insole": _signal(rng, t, 13, label, strength=strength),
            "imu": _signal(rng, t, 24, label, strength=strength),
        }
        for m in ("insole", "imu"):
            mask = rng.uniform(size=sub[m].shape) < 0.005
            sub[m] = sub[m].copy()
            sub[m][mask] = np.nan
        streams[sid] = sub
    return streams, pd_ids, hc_ids
