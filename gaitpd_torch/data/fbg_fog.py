"""FBG/FoG fold assembly: raw reader dicts -> stacked arrays and index
pools. The port's own copy of gaitpd/data/fbg_fog.py (reference
create_fusion_loaders, train/data_processing/dataloader_fbg_fog.py:
269-494): each fold becomes padded arrays a modality plus integer pools of
sample indices; each epoch's batches are gathers from those arrays on the
device. Host numpy only, with the same generator calls in the same order as
gaitpd, so a seed gives the same fold.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from gaitpd_torch.config import normalize_dataset_name
from gaitpd_torch.data import sampler as S
from gaitpd_torch.data.pipeline import pad_or_trim

DEFAULT_SKELETON_LEN = 101
DEFAULT_SENSOR_LEN = 65


# ---------------------------------------------------------------------------
# Pose preprocessing (host-side, once per reader; cheap)
# ---------------------------------------------------------------------------


def center_pose(arr: np.ndarray, root: int = 0) -> np.ndarray:
    """Pelvis-center a (T, J, 3) sequence. reference dataloader_fbg_fog.py:93-99."""
    return arr - arr[:, root : root + 1, :]


def minmax_pose(arr: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """Per-video min-max into [0,1] per coordinate, computed on the raw
    (un-padded) sequence like the reference (dataloader_fbg_fog.py:107-113)."""
    mins = arr.min(axis=(0, 1))
    maxs = arr.max(axis=(0, 1))
    return (arr - mins) / (maxs - mins + eps)


def preprocess_pose_dict(pose_dict: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k: minmax_pose(center_pose(np.asarray(v, np.float32))) for k, v in pose_dict.items()}


def split_grf_trials(
    sensor_dict: Dict[str, np.ndarray],
    sensor_label_map: Dict[str, int],
    pad_sens: int,
) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
    """Split FBG (101, n_trials, 3) GRF arrays into per-trial keys
    "key_i". reference dataloader_fbg_fog.py:302-313."""
    new_d, new_m = {}, {}
    for key, arr in sensor_dict.items():
        arr = np.asarray(arr, np.float32)
        if arr.ndim == 3:
            for i in range(arr.shape[1]):
                seg = f"{key}_{i}"
                new_d[seg] = pad_or_trim(arr[:, i, :], pad_sens)
                new_m[seg] = sensor_label_map[key]
        else:
            new_d[key] = pad_or_trim(arr, pad_sens)
            new_m[key] = sensor_label_map[key]
    return new_d, new_m


# ---------------------------------------------------------------------------
# Fold container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ModalityArrays:
    x: np.ndarray  # (N, T, D) float32
    y: np.ndarray  # (N,) int32
    keys: List[str]
    key_index: Dict[str, int]


@dataclasses.dataclass
class FusionFold:
    """One CV fold's data: stacked arrays + index pools.

    sync pools: (N, 2) [pose_idx, sens_idx] pairs; labels resolved per side.
    async pools: two aligned (N,) index arrays (fixed j-th pairing within the
    fold, matching the reference's wrap-around Dataset indexing,
    dataloader_fbg_fog.py:234-239).
    """

    train_pose: Optional[ModalityArrays]
    train_sens: Optional[ModalityArrays]
    eval_pose: Optional[ModalityArrays]
    eval_sens: Optional[ModalityArrays]
    train_pool: np.ndarray  # (N, 2) int32 into (pose, sens) arrays
    eval_pool: np.ndarray
    synchronized: bool
    modality: str


def _stack(
    src: Dict[str, np.ndarray],
    keys: Sequence[str],
    pad_len: int,
    label_of: Callable[[str], int],
) -> ModalityArrays:
    uniq = list(dict.fromkeys(keys))
    x = np.stack([pad_or_trim(np.asarray(src[k], np.float32), pad_len) for k in uniq])
    if x.ndim == 4:  # (N, T, J, 3) -> flatten joints
        x = x.reshape(x.shape[0], x.shape[1], -1)
    y = np.asarray([label_of(k) for k in uniq], np.int32)
    return ModalityArrays(x=x, y=y, keys=uniq, key_index={k: i for i, k in enumerate(uniq)})


def _select_keys(all_keys, subjects: Optional[Sequence[str]]):
    """Keys whose name starts with one of the selected subject prefixes
    (reference SkeletonDataset/SensorDataset key filtering,
    dataloader_fbg_fog.py:131-134)."""
    if subjects is None:
        return list(all_keys)
    subs = tuple(subjects)
    return [k for k in all_keys if k.startswith(subs)]


def build_fusion_fold(
    dataset: str,
    reader,
    train_subjects: Sequence[str],
    eval_subjects: Sequence[str],
    *,
    synchronized: bool = False,
    seed: int = 0,
    pad_skel: int = DEFAULT_SKELETON_LEN,
    pad_sens: int = DEFAULT_SENSOR_LEN,
    modality: str = "multimodal",
) -> FusionFold:
    """Assemble one fold, step by step as create_fusion_loaders (reference
    dataloader_fbg_fog.py:269-494); see the comments a step."""
    dataset = normalize_dataset_name(dataset)
    rng = np.random.default_rng(seed)

    # 1) raw dicts, labels, pose normalisation, GRF trial split (:288-328)
    if dataset == "fbg":
        pose_dict = preprocess_pose_dict(reader.pose_dict)
        sensor_dict, sensor_label_map = split_grf_trials(
            reader.sensor_dict, dict(reader.sensor_label_dict), pad_sens
        )
        pose_label_map = dict(reader.pose_label_dict)
        pose_label = lambda k: int(pose_label_map["_".join(k.split("_")[:2])])  # noqa: E731
        sens_label = lambda k: int(sensor_label_map[k])  # noqa: E731
        subj_key = lambda k: "_".join(k.split("_")[:2])  # noqa: E731
    else:  # fog
        pose_dict = preprocess_pose_dict(reader.pose_dict)
        sensor_dict = {k: np.asarray(v, np.float32) for k, v in reader.sensor_dict.items()}
        subject_label_map = {
            s: (l[0] if isinstance(l, (list, tuple, np.ndarray)) else int(l))
            for s, l in reader.labels_dict.items()
            if s not in ("SUB10", "SUB30", "SUB22")
        }
        pose_label = lambda k: int(subject_label_map[k.split("_")[0]])  # noqa: E731
        sens_label = lambda k: int(subject_label_map[k.split("_")[0]])  # noqa: E731
        subj_key = lambda k: k.split("_")[0]  # noqa: E731

    # 2) modality-aware train-subject filtering, fbg only (:330-349)
    train_subjects = list(train_subjects)
    if dataset == "fbg":
        pose_pfx = {"_".join(k.split("_")[:2]) for k in pose_dict}
        sens_pfx = {"_".join(k.split("_")[:2]) for k in sensor_dict}

        def has_data(s: str) -> bool:
            if modality == "skeleton":
                return s in pose_pfx
            if modality == "sensor":
                return s in sens_pfx
            return (s in pose_pfx) or (s in sens_pfx)

        dropped = [s for s in train_subjects if not has_data(s)]
        if dropped:
            print(f"[WARN] dropping train subjects missing {modality} data: {set(dropped)}")
        train_subjects = [s for s in train_subjects if has_data(s)]

    # 3) key selection per split
    tr_pose_keys = _select_keys(pose_dict, train_subjects)
    tr_sens_keys = _select_keys(sensor_dict, train_subjects)
    ev_pose_keys = _select_keys(pose_dict, list(eval_subjects))
    ev_sens_keys = _select_keys(sensor_dict, list(eval_subjects))

    # 4) unique stacked arrays per split/modality
    tr_pose = _stack(pose_dict, tr_pose_keys, pad_skel, pose_label) if tr_pose_keys else None
    tr_sens = _stack(sensor_dict, tr_sens_keys, pad_sens, sens_label) if tr_sens_keys else None
    ev_pose = _stack(pose_dict, ev_pose_keys, pad_skel, pose_label) if ev_pose_keys else None
    ev_sens = _stack(sensor_dict, ev_sens_keys, pad_sens, sens_label) if ev_sens_keys else None

    def pairs_to_pool(pairs, pose_arr, sens_arr):
        return np.asarray(
            [[pose_arr.key_index[pk], sens_arr.key_index[sk]] for pk, sk in pairs],
            np.int32,
        ).reshape(-1, 2)

    if modality in ("skeleton", "sensor"):
        # single modality: plain train keys; class-balanced eval oversample
        # (reference :384-430)
        tr_arr = tr_pose if modality == "skeleton" else tr_sens
        ev_arr = ev_pose if modality == "skeleton" else ev_sens
        lbl = pose_label if modality == "skeleton" else sens_label
        train_pool = np.stack([np.arange(len(tr_arr.keys), dtype=np.int32)] * 2, 1)
        bal = S.oversample_keys_balanced(ev_arr.keys, lbl, rng)
        ev_idx = np.asarray([ev_arr.key_index[k] for k in bal], np.int32)
        eval_pool = np.stack([ev_idx, ev_idx], 1)
        return FusionFold(tr_pose, tr_sens, ev_pose, ev_sens, train_pool, eval_pool,
                          synchronized, modality)

    if synchronized:
        # sync pairs by segment suffix (:194-208). Train pairs are NOT
        # oversampled (the reference passes seed=None for sync train, :352),
        # eval pairs are class-balanced oversampled (seed=seed, :354).
        tr_pairs = S.build_synced_pairs(
            S.group_by_subject(tr_pose.keys), S.group_by_subject(tr_sens.keys)
        )
        ev_pairs = S.build_synced_pairs(
            S.group_by_subject(ev_pose.keys), S.group_by_subject(ev_sens.keys)
        )
        if not tr_pairs or not ev_pairs:
            # FBG pose/GRF keys have no common segment suffix, so sync pairing
            # is structurally empty there (the reference would crash the same
            # way deeper in oversample_equally); sync is a FoG-only mode.
            raise ValueError(
                f"synchronized loading produced no aligned pairs for '{dataset}'"
            )
        ev_pairs = S.oversample_equally(ev_pairs, pose_label, rng)
        return FusionFold(
            tr_pose, tr_sens, ev_pose, ev_sens,
            pairs_to_pool(tr_pairs, tr_pose, tr_sens),
            pairs_to_pool(ev_pairs, ev_pose, ev_sens),
            synchronized, modality,
        )

    # async multimodal: equalize train key-list lengths (:368-381); eval is
    # subject-balanced oversampled per modality (:434-473)
    tr_pose_ext, tr_sens_ext = S.equalize_lengths(tr_pose.keys, tr_sens.keys, rng)
    train_pool = np.stack(
        [
            np.asarray([tr_pose.key_index[k] for k in tr_pose_ext], np.int32),
            np.asarray([tr_sens.key_index[k] for k in tr_sens_ext], np.int32),
        ],
        axis=1,
    )
    bal_pose, bal_sens = S.subject_balanced_async_eval(
        ev_pose.keys, ev_sens.keys, list(eval_subjects), subj_key, rng
    )
    eval_pool = np.stack(
        [
            np.asarray([ev_pose.key_index[k] for k in bal_pose], np.int32),
            np.asarray([ev_sens.key_index[k] for k in bal_sens], np.int32),
        ],
        axis=1,
    )
    return FusionFold(tr_pose, tr_sens, ev_pose, ev_sens, train_pool, eval_pool,
                      synchronized, modality)
