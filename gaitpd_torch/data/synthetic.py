"""Synthetic FBG, FoG and WearGait data for tests and CPU-runnable
end-to-end runs. The port's own copy of gaitpd/data/synthetic.py:29-195:
the same numpy draws in the same order, so a seed gives the same arrays as
gaitpd.

* FoG: ``pose_dict`` ("SUBxx_i" -> (T, 7, 3)), ``sensor_dict`` ("SUBxx_i"
  -> (426, 6)), ``labels_dict`` ("SUBxx" -> [label] * n), as the raw
  FoGReader gives them;
* FBG: ``pose_dict`` ("SUBxx_on_walk_i" -> (T, 17, 3)), ``sensor_dict``
  ("SUBxx_on" -> (101, n_trials, 3) GRF), ``pose_label_dict``,
  ``sensor_label_dict``, ``metadata_dict``;
* WearGait: per subject walkway (T, 2), insole (T, 13), imu (T, 24) at
  30 Hz.

Each class shifts the stream mean and the oscillation frequency, so small
models learn (loss decreases, accuracy above chance).
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass
class SyntheticFoGReader:
    """The attributes of the raw FoGReader that build_fusion_fold reads."""

    pose_dict: Dict[str, np.ndarray]
    sensor_dict: Dict[str, np.ndarray]
    labels_dict: Dict[str, List[int]]
    sensor_length: int = 426


def make_fog_reader(
    n_subjects: int = 9,
    segments: int = 4,
    n_classes: int = 3,
    pose_t: int = 101,
    sensor_t: int = 426,
    seed: int = 0,
    strength: float = 1.0,
    class_skew: bool = True,
    pose_per_joint: bool = False,
) -> SyntheticFoGReader:
    """``class_skew`` gives lower classes more segments a subject, as the
    real data's imbalance (exactly balanced counts would make gaitpd's
    reference GCL loss NaN). ``pose_per_joint`` gives the pose signal
    per-joint gains, so it survives root-joint centering."""
    rng = np.random.default_rng(seed)
    pose_dict, sensor_dict, labels = {}, {}, {}
    for s in range(n_subjects):
        sid = f"SUB{s:02d}"
        label = s % n_classes
        n_seg = segments + (n_classes - 1 - label if class_skew else 0)
        labels[sid] = [label] * n_seg
        for i in range(n_seg):
            pose = _signal(rng, pose_t, 21, label, strength,
                           per_channel=pose_per_joint).reshape(pose_t, 7, 3)
            pose_dict[f"{sid}_{i}"] = pose
            sensor_dict[f"{sid}_{i}"] = _signal(rng, sensor_t, 6, label, strength)
    return SyntheticFoGReader(pose_dict, sensor_dict, labels, sensor_length=sensor_t)


@dataclasses.dataclass
class SyntheticFBGReader:
    """The attributes of the raw FBGReader that build_fusion_fold reads."""

    pose_dict: Dict[str, np.ndarray]
    sensor_dict: Dict[str, np.ndarray]
    pose_label_dict: Dict[str, int]
    sensor_label_dict: Dict[str, int]
    metadata_dict: Dict[str, np.ndarray]


def make_fbg_reader(
    n_subjects: int = 9,
    n_classes: int = 3,
    walks: int = 3,
    trials: int = 4,
    pose_t: int = 101,
    grf_t: int = 101,
    seed: int = 0,
    strength: float = 1.0,
    class_skew: bool = True,
    pose_per_joint: bool = False,
) -> SyntheticFBGReader:
    """``class_skew`` and ``pose_per_joint``: as make_fog_reader. The GRF
    arrays are (grf_t, n_trials, 3), split a trial at a time by
    build_fusion_fold (and cut to 65 frames)."""
    rng = np.random.default_rng(seed)
    pose_dict, sensor_dict = {}, {}
    pose_labels, sensor_labels, meta = {}, {}, {}
    for s in range(n_subjects):
        sid = f"SUB{s:02d}_on"
        label = s % n_classes
        skew = n_classes - 1 - label if class_skew else 0
        pose_labels[sid] = label
        sensor_labels[sid] = label
        meta[sid] = rng.uniform(0, 1, size=4).astype(np.float32)
        for w in range(walks + skew):
            pose = _signal(rng, pose_t, 51, label, strength,
                           per_channel=pose_per_joint).reshape(pose_t, 17, 3)
            pose_dict[f"{sid}_walk_{w}"] = pose
        sensor_dict[sid] = np.stack(
            [_signal(rng, grf_t, 3, label, strength) for _ in range(trials + skew)],
            axis=1,
        )
    return SyntheticFBGReader(pose_dict, sensor_dict, pose_labels, sensor_labels, meta)



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
