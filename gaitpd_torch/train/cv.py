"""Subject-level cross-validation folds for WearGait.
The port's own copy of gaitpd/train/cv.py:79-112 (reference
dataloader_weargait.py:56-74), with numpy generators seeded explicitly.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


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
