"""WearGait fold preparation: per-subject streams -> train-only z-stats ->
strict full windows -> sync/async index pools, on the host in numpy.
The port's own copy of gaitpd/data/weargait.py:25-180.

Reading the preprocessed pickles of real recordings (``load_pkl_streams``)
waits for the readers (ROADMAP Queue 1, item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from gaitpd_torch.data.pipeline import window_stream_np

MIN_STD = 1e-6  # reference dataloader_weargait.py:28
MODALITIES = ("walkway", "insole", "imu")
NORMALIZED_MODALITIES = ("insole", "imu")  # walkway is body-weight normalised upstream


@dataclasses.dataclass
class WindowStore:
    """All windows of one modality for one split, stacked."""

    x: np.ndarray  # (N, win, C) float32
    y: np.ndarray  # (N,) int32 subject labels
    keys: List[str]  # "SID|mod|wid"
    key_index: Dict[str, int]


@dataclasses.dataclass
class WearGaitSplit:
    stats: Dict[str, Tuple[np.ndarray, np.ndarray]]  # modality -> (mean, std)
    train: Dict[str, WindowStore]
    test: Dict[str, WindowStore]
    train_sync: np.ndarray  # (N, 3) int32 into train stores
    test_sync: np.ndarray


def fit_stats_on_train(
    streams: Dict[str, Dict[str, np.ndarray]],
    train_subjects: Sequence[str],
    modalities: Sequence[str] = NORMALIZED_MODALITIES,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Per-channel NaN-aware mean/std over the train subjects' frames
    (reference dataloader_weargait.py:181-210)."""
    stats = {}
    for m in modalities:
        chunks = [
            np.asarray(streams[s][m], np.float64)
            for s in train_subjects
            if s in streams and streams[s][m].size
        ]
        if not chunks:
            continue
        x = np.concatenate(chunks, axis=0)
        finite = np.isfinite(x)
        n = np.maximum(finite.sum(axis=0), 1)
        xs = np.where(finite, x, 0.0)
        mean = xs.sum(axis=0) / n
        var = np.where(finite, (x - mean) ** 2, 0.0).sum(axis=0) / n
        std = np.maximum(np.sqrt(np.maximum(var, 0.0)), MIN_STD)
        stats[m] = (mean.astype(np.float32), std.astype(np.float32))
    return stats


def apply_stats_np(x: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """NaN-guarded z-score (reference :212-227): non-finite -> train mean
    before the transform, std floored, residual non-finites -> 0."""
    mean = np.where(np.isfinite(mean), mean, 0.0)
    std = np.where(np.isfinite(std) & (std > MIN_STD), std, MIN_STD)
    x = np.where(np.isfinite(x), x, mean)
    z = (x - mean) / std
    return np.nan_to_num(z, nan=0.0, posinf=0.0, neginf=0.0).astype(np.float32)


def build_split_stores(
    streams: Dict[str, Dict[str, np.ndarray]],
    subjects: Sequence[str],
    subj2label: Dict[str, int],
    stats: Dict[str, Tuple[np.ndarray, np.ndarray]],
    win: int,
    hop: int,
    modalities: Sequence[str] = MODALITIES,
) -> Tuple[Dict[str, WindowStore], np.ndarray]:
    """Window every subject's streams; also return the (N, 3) sync pool of
    per-subject common window ids (reference :278-299)."""
    per_mod_x = {m: [] for m in modalities}
    per_mod_y = {m: [] for m in modalities}
    per_mod_keys = {m: [] for m in modalities}
    per_subj_wids: Dict[str, Dict[str, List[int]]] = {}

    for sid in subjects:
        sub = streams[sid]
        per_subj_wids[sid] = {}
        for m in modalities:
            x = np.asarray(sub[m], np.float32)
            if m in stats:
                x = apply_stats_np(x, *stats[m])
            else:
                x = np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
            wins = window_stream_np(x, win, hop)
            wids = list(range(wins.shape[0]))
            per_subj_wids[sid][m] = wids
            per_mod_x[m].append(wins)
            per_mod_y[m].extend([subj2label[sid]] * len(wids))
            per_mod_keys[m].extend(f"{sid}|{m}|{w}" for w in wids)

    stores = {}
    for m in modalities:
        x = (
            np.concatenate(per_mod_x[m], axis=0)
            if per_mod_x[m]
            else np.zeros((0, win, 1), np.float32)
        )
        keys = per_mod_keys[m]
        stores[m] = WindowStore(
            x=x,
            y=np.asarray(per_mod_y[m], np.int32),
            keys=keys,
            key_index={k: i for i, k in enumerate(keys)},
        )

    sync_rows = []
    for sid in subjects:
        wid_sets = [set(per_subj_wids[sid][m]) for m in modalities]
        if not all(wid_sets):
            continue
        for wid in sorted(set.intersection(*wid_sets)):
            sync_rows.append(
                [stores[m].key_index[f"{sid}|{m}|{wid}"] for m in modalities]
            )
    sync = np.asarray(sync_rows, np.int32).reshape(-1, len(modalities))
    return stores, sync


def prepare_split(
    streams: Dict[str, Dict[str, np.ndarray]],
    train_subs: Sequence[str],
    test_subs: Sequence[str],
    subj2label: Dict[str, int],
    *,
    win: int = 64,
    hop: int = 64,
    modalities: Sequence[str] = MODALITIES,
) -> WearGaitSplit:
    """reference prepare_split (dataloader_weargait.py:388-418): stats on
    train only, window both splits, build sync index maps."""
    stats = fit_stats_on_train(streams, train_subs)
    train, train_sync = build_split_stores(
        streams, train_subs, subj2label, stats, win, hop, modalities
    )
    test, test_sync = build_split_stores(
        streams, test_subs, subj2label, stats, win, hop, modalities
    )
    return WearGaitSplit(stats, train, test, train_sync, test_sync)


def async_pool(
    stores: Dict[str, WindowStore],
    rng: np.random.Generator,
    modalities: Sequence[str] = MODALITIES,
) -> np.ndarray:
    """(min_len, 3) triplets: independent per-modality permutations without
    replacement, truncated to the shortest modality (reference
    WearGaitMultiAsyncDataset :305-347; the per-epoch reseed is a fresh
    generator, reference weargait_train.py:573-574)."""
    lens = [len(stores[m].keys) for m in modalities]
    min_len = min(lens)
    perms = [rng.permutation(n)[:min_len] for n in lens]
    return np.stack(perms, axis=1).astype(np.int32)
