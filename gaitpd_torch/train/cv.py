"""Subject-level cross-validation folds. The port's own copy of
gaitpd/train/cv.py:18-112 (reference train/utilities.py:89-126 for FBG/FoG,
dataloader_weargait.py:56-74 for WearGait), with numpy generators seeded
explicitly: the same calls in the same order, so a seed gives gaitpd's
folds.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np


def generate_class_stratified_folds(
    label_dict: Dict[str, int],
    rng: np.random.Generator,
) -> List[Tuple[List[str], List[str]]]:
    """One eval subject a class a fold; as many folds as the smallest class
    has subjects. Larger classes are down-sampled, each class list is
    shuffled, fold i evaluates the i-th subject of each (sorted-label) class
    and trains on everyone else."""
    by_class: Dict[int, List[str]] = defaultdict(list)
    for subject, label in label_dict.items():
        by_class[int(label)].append(subject)

    fold_count = min(len(v) for v in by_class.values())
    if fold_count == 0:
        raise ValueError("Need at least one subject per class")

    balanced = {}
    for label in by_class:
        subjects = list(by_class[label])
        if len(subjects) > fold_count:
            subjects = list(rng.choice(subjects, size=fold_count, replace=False))
        rng.shuffle(subjects)
        balanced[label] = subjects

    folds = []
    for index in range(fold_count):
        eval_subjects = [balanced[label][index] for label in sorted(balanced)]
        train_subjects = [s for s in label_dict if s not in eval_subjects]
        folds.append((train_subjects, eval_subjects))
    return folds


def fbg_label_dict(reader, exclude: Sequence[str] = ()) -> Dict[str, int]:
    """The FBG subjects (``SUBxx_on``/``_off``) with both modalities,
    labelled from ``pose_label_dict`` (reference train/utilities.py:91-96)."""
    pose_pfx = {"_".join(k.split("_")[:2]) for k in reader.pose_dict}
    sens_pfx = {"_".join(k.split("_")[:2]) for k in reader.sensor_dict}
    both = pose_pfx & sens_pfx
    return {
        s: int(l)
        for s, l in reader.pose_label_dict.items()
        if s in both and s not in set(exclude)
    }


FOG_EXCLUDED_SUBJECTS = ("SUB10", "SUB30", "SUB22")  # reference utilities.py:101


def fog_label_dict(reader, exclude: Sequence[str] = FOG_EXCLUDED_SUBJECTS) -> Dict[str, int]:
    """Each FoG subject's first H&Y label (reference train/utilities.py:97-102)."""
    out = {}
    for subject, labels in reader.labels_dict.items():
        if subject in set(exclude):
            continue
        lab = labels[0] if isinstance(labels, (list, tuple, np.ndarray)) else labels
        out[subject] = int(lab)
    return out


def make_fixed_balanced_folds_no_overlap(
    pd_ids: Sequence[str],
    hc_ids: Sequence[str],
    n_folds: int = 10,
    per_class: int = 8,
    seed: int = 0,
) -> List[Tuple[List[str], List[str]]]:
    """Disjoint test sets: per fold, per_class PD + per_class HC subjects."""
    if len(pd_ids) < n_folds * per_class or len(hc_ids) < n_folds * per_class:
        raise AssertionError("Not enough subjects.")
    rng = np.random.default_rng(seed)
    pd_pool = list(pd_ids)
    hc_pool = list(hc_ids)
    rng.shuffle(pd_pool)
    rng.shuffle(hc_pool)
    used_pd = pd_pool[: n_folds * per_class]
    used_hc = hc_pool[: n_folds * per_class]
    folds = []
    for f in range(n_folds):
        te = sorted(used_pd[f * per_class : (f + 1) * per_class]) + sorted(
            used_hc[f * per_class : (f + 1) * per_class]
        )
        tr = sorted(s for s in (list(pd_ids) + list(hc_ids)) if s not in set(te))
        folds.append((tr, te))
    return folds


def build_subj2label(pd_ids: Sequence[str], hc_ids: Sequence[str]) -> Dict[str, int]:
    """PD=1, HC=0."""
    out = {s: 1 for s in pd_ids}
    out.update({s: 0 for s in hc_ids})
    return out
