"""Sampling-index functions and the epoch index matrices for the on-device
batch gather. The port's own copy of gaitpd/data/sampler.py:23-186
(reference dataloader_fbg_fog.py:45-90,210-250,368-473): integer and key
lists built with numpy generators, the same calls in the same order as
gaitpd's, so a seed gives the same pools.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np


def group_by_subject(keys: Sequence[str], token_count: int = 1) -> Dict[str, List[str]]:
    """Map prefix (first token_count '_'-tokens) -> keys
    (reference dataloader_fbg_fog.py:45-51, :438-441)."""
    out: Dict[str, List[str]] = defaultdict(list)
    for k in keys:
        out["_".join(k.split("_")[:token_count])].append(k)
    return out


def build_synced_pairs(
    pose_map: Dict[str, List[str]], sens_map: Dict[str, List[str]]
) -> List[Tuple[str, str]]:
    """Pair pose and sensor keys whose last two '_'-segments match, within
    each subject (reference dataloader_fbg_fog.py:53-73)."""
    pairs = []
    for sub, pkeys in pose_map.items():
        seg_dict: Dict[str, List[str]] = defaultdict(list)
        for sk in sens_map.get(sub, []):
            seg_dict["_".join(sk.split("_")[-2:])].append(sk)
        for pk in pkeys:
            seg = "_".join(pk.split("_")[-2:])
            for sk in seg_dict.get(seg, []):
                pairs.append((pk, sk))
    return pairs


def oversample_equally(
    pairs: List[Tuple[str, str]],
    get_label: Callable[[str], int],
    rng: np.random.Generator,
) -> List[Tuple[str, str]]:
    """Each class drawn with replacement to the largest class's count, then
    shuffled (reference dataloader_fbg_fog.py:76-90)."""
    cls2pairs: Dict[int, List[Tuple[str, str]]] = defaultdict(list)
    for pk, sk in pairs:
        cls2pairs[get_label(pk)].append((pk, sk))
    max_n = max(len(v) for v in cls2pairs.values())
    balanced: List[Tuple[str, str]] = []
    for group in cls2pairs.values():
        picks = rng.integers(0, len(group), size=max_n)
        balanced.extend(group[i] for i in picks)
    order = rng.permutation(len(balanced))
    return [balanced[i] for i in order]


def oversample_keys_balanced(
    keys: Sequence[str],
    get_label: Callable[[str], int],
    rng: np.random.Generator,
) -> List[str]:
    """Class-balanced key oversampling for single-modality eval
    (reference dataloader_fbg_fog.py:410-424)."""
    cls2keys: Dict[int, List[str]] = defaultdict(list)
    for k in keys:
        cls2keys[get_label(k)].append(k)
    max_n = max(len(v) for v in cls2keys.values())
    out: List[str] = []
    for group in cls2keys.values():
        picks = rng.integers(0, len(group), size=max_n)
        out.extend(group[i] for i in picks)
    order = rng.permutation(len(out))
    return [out[i] for i in order]


def equalize_lengths(
    keys_a: List[str], keys_b: List[str], rng: np.random.Generator
) -> Tuple[List[str], List[str]]:
    """Extend the shorter key list by drawing from it with replacement, so
    both modalities have one length (async train path, reference
    dataloader_fbg_fog.py:368-381)."""
    na, nb = len(keys_a), len(keys_b)
    if na == nb:
        return list(keys_a), list(keys_b)
    if na < nb:
        extra = [keys_a[i] for i in rng.integers(0, na, size=nb - na)]
        return list(keys_a) + extra, list(keys_b)
    extra = [keys_b[i] for i in rng.integers(0, nb, size=na - nb)]
    return list(keys_a), list(keys_b) + extra


def subject_balanced_async_eval(
    pose_keys: Sequence[str],
    sens_keys: Sequence[str],
    eval_subjects: Sequence[str],
    subj_key: Callable[[str], str],
    rng: np.random.Generator,
) -> Tuple[List[str], List[str]]:
    """Per-subject oversampling to the largest per-subject count of either
    modality, then a shuffle of each (reference
    dataloader_fbg_fog.py:434-473)."""
    pose_map = group_by_subject_fn(pose_keys, subj_key)
    sens_map = group_by_subject_fn(sens_keys, subj_key)
    max_pose = max(len(pose_map.get(s, [])) for s in eval_subjects)
    max_sens = max(len(sens_map.get(s, [])) for s in eval_subjects)
    target = max(max_pose, max_sens)
    bal_pose, bal_sens = [], []
    for s in eval_subjects:
        gp, gs = pose_map.get(s, []), sens_map.get(s, [])
        if not gp or not gs:
            raise ValueError(f"Subject {s} lacks data for one modality")
        bal_pose.extend(gp[i] for i in rng.integers(0, len(gp), size=target))
        bal_sens.extend(gs[i] for i in rng.integers(0, len(gs), size=target))
    rng.shuffle(bal_pose)
    rng.shuffle(bal_sens)
    return bal_pose, bal_sens


def group_by_subject_fn(
    keys: Sequence[str], subj_key: Callable[[str], str]
) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = defaultdict(list)
    for k in keys:
        out[subj_key(k)].append(k)
    return out


def batch_index_matrix(
    order: np.ndarray,
    batch_size: int,
    pad_multiple: int = 1,
    quantize_batches: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Chunk a sample order into a padded (n_batches, B) index matrix plus a
    matching validity mask; the partial final batch is padded with index 0
    and valid 0.

    quantize_batches rounds n_batches up to a power of two, as the reference
    does (there it bounds the number of compiled epoch scans); the fully
    padded tail batches change nothing and are dropped from the metrics."""
    n = len(order)
    b = batch_size
    n_batches = max(1, -(-n // b))
    if quantize_batches:
        p = 1
        while p < n_batches:
            p *= 2
        n_batches = p
    total = n_batches * b
    idx = np.zeros(total, dtype=np.int32)
    idx[:n] = order
    valid = np.zeros(total, dtype=np.float32)
    valid[:n] = 1.0
    if pad_multiple > 1 and b % pad_multiple:
        raise ValueError("batch_size must be divisible by the mesh size")
    return idx.reshape(n_batches, b), valid.reshape(n_batches, b)


def async_epoch_order(
    n_pose: int, n_sens: int, rng: np.random.Generator, shuffle: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """An async FBG/FoG epoch of max(n_pose, n_sens) samples; sample i takes
    (perm[i] % n_pose, perm[i] % n_sens), the wrap-around indexing of
    reference dataloader_fbg_fog.py:210-250 under a shuffled sampler."""
    n = max(n_pose, n_sens)
    perm = rng.permutation(n) if shuffle else np.arange(n)
    return (perm % n_pose).astype(np.int32), (perm % n_sens).astype(np.int32)
