"""Readers of the preprocessed WearGait pickles: the port's own copy of
gaitpd/data/readers.py:280-364 (reference dataloader_weargait.py:76-178).

Each pickle is a pandas DataFrame, so these functions import pandas when
they run; importing this module needs only numpy. The insole's and the
IMU's tuple columns are expanded to the fixed 13- and 24-channel sets, the
walkway keeps its 2 columns; a missing or all-NaN column becomes zeros.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

IMU_SITES = [
    "L_Ankle", "R_Ankle", "L_DorsalFoot", "R_DorsalFoot",
    "L_MidLatThigh", "R_MidLatThigh", "L_LatShank", "R_LatShank",
]
IMU_AXES = ("E", "N", "U")
IMU_FIXED = [f"{s}_FreeAcc_{ax}" for s in IMU_SITES for ax in IMU_AXES]  # 24
INSOLE_FIXED = [
    "LTotalForce_BW", "RTotalForce_BW", "SumForce_BW",
    "LCoP_X", "LCoP_Y", "RCoP_X", "RCoP_Y",
    "Linsole_Acc_X", "Linsole_Acc_Y", "Linsole_Acc_Z",
    "Rinsole_Acc_X", "Rinsole_Acc_Y", "Rinsole_Acc_Z",
]  # 13
WALKWAY_FIXED = ["L Foot Pressure_BW", "R Foot Pressure_BW"]  # 2


def _ensure_cols(df, required: List[str]) -> np.ndarray:
    """Column-complete float array in the fixed order; missing or all-NaN
    columns become 0 (reference dataloader_weargait.py:76-91; the pre-norm
    mean-fill happens later in the pipeline's NaN-guarded z-score)."""
    import pandas as pd

    n = len(df)
    out = np.zeros((n, len(required)), np.float64)
    for j, c in enumerate(required):
        if c in df.columns:
            x = pd.to_numeric(df[c], errors="coerce").to_numpy(dtype=float)
            if np.isfinite(x).any():
                out[:, j] = x
    return out


def _expand_tuple_col(df, col: str, prefix: str, axes) -> None:
    if col not in df.columns:
        return
    arr = np.vstack(
        df[col].astype(object).apply(lambda t: np.asarray(t, dtype=float)).to_numpy()
    )
    for i, ax in enumerate(axes):
        df[f"{prefix}_{ax}"] = arr[:, i]
    df.drop(columns=[col], inplace=True)


def expand_insole_df(df) -> np.ndarray:
    """(T, 13) insole array (reference dataloader_weargait.py:154-160)."""
    if df is None or len(df) == 0:
        return np.zeros((0, len(INSOLE_FIXED)), np.float64)
    df = df.copy()
    _expand_tuple_col(df, "Linsole_Acc", "Linsole_Acc", ("X", "Y", "Z"))
    _expand_tuple_col(df, "Rinsole_Acc", "Rinsole_Acc", ("X", "Y", "Z"))
    return _ensure_cols(df, INSOLE_FIXED)


def expand_imu_df(df) -> np.ndarray:
    """(T, 24) IMU array (reference dataloader_weargait.py:162-170)."""
    if df is None or len(df) == 0:
        return np.zeros((0, len(IMU_FIXED)), np.float64)
    df = df.copy()
    for s in IMU_SITES:
        _expand_tuple_col(df, f"{s}_FreeAcc", f"{s}_FreeAcc", IMU_AXES)
    return _ensure_cols(df, IMU_FIXED)


def walkway_df_to_array(df) -> np.ndarray:
    if df is None or len(df) == 0:
        return np.zeros((0, len(WALKWAY_FIXED)), np.float64)
    return _ensure_cols(df, WALKWAY_FIXED)


def discover_weargait_subjects(
    data_dir: Path, pd_dir: Optional[Path] = None, hc_dir: Optional[Path] = None
) -> Tuple[List[str], List[str]]:
    """PD/HC subject ids. Prefers the raw csv roots' *_matTURN.csv scan
    (reference weargait_train.py:60-69); falls back to the preprocessed pkl
    names when only those exist."""
    if pd_dir and hc_dir and Path(pd_dir).exists() and Path(hc_dir).exists():
        scan = lambda d: sorted(  # noqa: E731
            {p.name.split("_")[0] for p in Path(d).glob("*_matTURN.csv")}
        )
        return scan(pd_dir), scan(hc_dir)
    subs = sorted({p.name.split("_")[0] for p in Path(data_dir).glob("*_walkway.pkl")})
    pd_ids = [s for s in subs if s.lower().startswith("pd")]
    hc_ids = [s for s in subs if not s.lower().startswith("pd")]
    return pd_ids, hc_ids
