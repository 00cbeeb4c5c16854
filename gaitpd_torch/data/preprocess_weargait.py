"""WearGait raw preprocessor: per-subject CSVs -> three 30 Hz streams
(walkway pressure, insole, 8-site IMU) saved as per-subject pickles.
The port's own copy of gaitpd/data/preprocess_weargait.py (reference
train/data_processing/preprocess_weargait.py:1-354); it needs pandas,
which each function imports when it runs.

    python -m gaitpd_torch.data.preprocess_weargait   # the paths of data/WearGait

Behavioural parity notes:
* body-weight normalisation of walkway/insole forces uses weight_kg * 9.81
  (reference :137-171);
* downsampling is time-bin 'first sample per 1/30 s bin' with bin-centre
  timestamps (reference :119-134);
* "standing" GeneralEvent rows are dropped before any stream build
  (reference :285-287);
* fold-agnostic mode (train_subject_ids=None) skips the optional global IMU
  z-score — the CV pipeline fits fold-local stats instead
  (gaitpd_torch.data.weargait.fit_stats_on_train), matching the recommended
  reference flow (:345-347).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict

import numpy as np

GRAV = 9.81
CSV_PATTERN = "*_SelfPace_matTURN.csv"
IMU_SITES = [
    "L_Ankle", "R_Ankle", "L_DorsalFoot", "R_DorsalFoot",
    "L_MidLatThigh", "R_MidLatThigh", "L_LatShank", "R_LatShank",
]


# ------------------------- demographics ------------------------------------


def read_demographics(path) -> "pd.DataFrame":
    """Header lives on the second row of these CSVs (reference :22-28)."""
    import pandas as pd

    df0 = pd.read_csv(path, header=None, dtype=str)
    header = (
        df0.iloc[1].fillna("").astype(str).str.replace(r"\s+", " ", regex=True).str.strip()
    )
    df = df0.iloc[2:].reset_index(drop=True).copy()
    df.columns = header
    return df


def subject_weights(demo_df) -> Dict[str, float]:
    """subject_id (lowercased) -> weight in kg (reference :30-46)."""
    import pandas as pd

    id_col = next(
        c for c in demo_df.columns if re.search(r"(subject\s*id|participant)", c, re.I)
    )
    wt_col = next(c for c in demo_df.columns if re.search(r"weight", c, re.I))
    out = {}
    for _, row in demo_df.iterrows():
        sid = str(row[id_col]).strip().lower()
        m = re.search(r"([0-9]*\.?[0-9]+)", str(row[wt_col]))
        if sid and m:
            out[sid] = float(m.group(1))
    return out


def build_weight_map(hc_demo_csv, pd_demo_csv) -> Dict[str, float]:
    weight_map: Dict[str, float] = {}
    for p in (hc_demo_csv, pd_demo_csv):
        if p and Path(p).exists():
            weight_map.update(subject_weights(read_demographics(p)))
    return weight_map


# ------------------------- downsampling ------------------------------------


def parse_time_seconds(series) -> np.ndarray:
    """reference :112-117 — strip ' sec' suffixes and comma decimals."""
    import pandas as pd

    t = (
        series.astype(str)
        .str.strip()
        .str.replace(" sec", "", regex=False)
        .str.replace(",", ".", regex=False)
    )
    return pd.to_numeric(t, errors="coerce").to_numpy(dtype=float)


def downsample_to_30hz(df, time_col: str = "Time", target_hz: int = 30):
    """First sample per 1/target_hz time bin; timestamps become bin centres
    (reference :119-134)."""
    import pandas as pd

    if df is None or len(df) == 0 or time_col not in df.columns:
        return df
    t = parse_time_seconds(df[time_col])
    finite = np.isfinite(t)
    if not finite.any():
        return pd.DataFrame()
    bins = np.full(t.shape, -1, dtype=np.int64)
    bins[finite] = np.floor(t[finite] * target_hz).astype(np.int64)
    tmp = df.copy()
    tmp["_bin"] = bins
    out = tmp[tmp["_bin"] >= 0].groupby("_bin", sort=True, as_index=False).first()
    out[time_col] = (out["_bin"].to_numpy(dtype=float) + 0.5) / target_hz
    return out.drop(columns=["_bin"]).reset_index(drop=True)


# ------------------------- the three streams -------------------------------


def build_walkway(df, weight_kg: float):
    """(Time, L/R Foot Pressure_BW) at 30 Hz (reference :137-150)."""
    import pandas as pd

    keep = [c for c in ("Time", "L Foot Pressure", "R Foot Pressure") if c in df.columns]
    if not keep:
        return pd.DataFrame()
    out = df[keep].copy()
    denom = weight_kg * GRAV if weight_kg and weight_kg > 0 else np.nan
    for c in ("L Foot Pressure", "R Foot Pressure"):
        if c in out and denom == denom:  # not NaN
            out[c + "_BW"] = pd.to_numeric(out[c], errors="coerce") / denom
    cols = ["Time"] + [c for c in ("L Foot Pressure_BW", "R Foot Pressure_BW") if c in out]
    return downsample_to_30hz(out[cols])


def build_insole(df, weight_kg: float):
    """Forces BW-normalised + CoP + 3-axis acc packed as tuples
    (reference :152-194; z-score deferred to the fold-local pipeline)."""
    import pandas as pd

    wanted = [
        "Time", "LTotalForce", "RTotalForce",
        "LCoP_X", "LCoP_Y", "RCoP_X", "RCoP_Y",
        "Linsole:Acc_X", "Linsole:Acc_Y", "Linsole:Acc_Z",
        "Rinsole:Acc_X", "Rinsole:Acc_Y", "Rinsole:Acc_Z",
    ]
    keep = [c for c in wanted if c in df.columns]
    if not keep:
        return pd.DataFrame()
    out = df[keep].copy()
    if weight_kg and weight_kg > 0:
        denom = weight_kg * GRAV
        for c in ("LTotalForce", "RTotalForce"):
            if c in out:
                out[c + "_BW"] = pd.to_numeric(out[c], errors="coerce") / denom
        if {"LTotalForce", "RTotalForce"}.issubset(out.columns):
            out["SumForce_BW"] = (
                pd.to_numeric(out["LTotalForce"], errors="coerce")
                + pd.to_numeric(out["RTotalForce"], errors="coerce")
            ) / denom
    for prefix in ("Linsole", "Rinsole"):
        cols = [f"{prefix}:Acc_{ax}" for ax in "XYZ"]
        if all(c in out.columns for c in cols):
            out[f"{prefix}_Acc"] = list(map(tuple, out[cols].to_numpy()))
            out.drop(columns=cols, inplace=True)
    cols = [
        "Time", "LTotalForce_BW", "RTotalForce_BW", "SumForce_BW",
        "LCoP_X", "LCoP_Y", "RCoP_X", "RCoP_Y", "Linsole_Acc", "Rinsole_Acc",
    ]
    return downsample_to_30hz(out[[c for c in cols if c in out.columns]])


def build_imu(df):
    """8 sites x E/N/U free-acceleration packed per site (reference :196-222)."""
    import pandas as pd

    keep = ["Time"]
    for s in IMU_SITES:
        keep += [c for c in (f"{s}_FreeAcc_E", f"{s}_FreeAcc_N", f"{s}_FreeAcc_U") if c in df.columns]
    if len(keep) == 1:
        return pd.DataFrame()
    imu = df[[c for c in keep if c in df.columns]].copy()
    for s in IMU_SITES:
        cols = [f"{s}_FreeAcc_{ax}" for ax in ("E", "N", "U")]
        if all(c in imu.columns for c in cols):
            imu[f"{s}_FreeAcc"] = list(map(tuple, imu[cols].to_numpy()))
            imu.drop(columns=cols, inplace=True)
    return downsample_to_30hz(imu)


def find_subject_files(root_dir, pattern: str = CSV_PATTERN) -> Dict[str, Path]:
    return {p.stem.split("_", 1)[0].lower(): p for p in Path(root_dir).glob(pattern)}


def run_end_to_end(
    hc_csv_root,
    pd_csv_root,
    hc_demo_csv,
    pd_demo_csv,
    output_dir,
    pattern: str = CSV_PATTERN,
) -> int:
    """Process every subject CSV into the three 30 Hz stream pickles
    (reference :225-343, fold-agnostic mode). Returns subjects processed."""
    import pandas as pd

    outdir = Path(output_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    weight_map = build_weight_map(hc_demo_csv, pd_demo_csv)
    all_files = {**find_subject_files(hc_csv_root, pattern),
                 **find_subject_files(pd_csv_root, pattern)}
    if not all_files:
        print("[warn] no CSV files found; check paths/pattern")
        return 0
    for sid, csv_path in sorted(all_files.items()):
        df = pd.read_csv(csv_path)
        if "GeneralEvent" in df.columns:
            df = df[df["GeneralEvent"].str.lower() != "standing"].copy()
        wkg = weight_map.get(sid, np.nan)
        walkway = build_walkway(df, wkg)
        insole = build_insole(df, wkg)
        imu = build_imu(df)
        print(f"[{sid}] rows_w={len(walkway)} rows_i={len(insole)} rows_m={len(imu)}")
        walkway.to_pickle(outdir / f"{sid}_walkway.pkl")
        insole.to_pickle(outdir / f"{sid}_insole.pkl")
        imu.to_pickle(outdir / f"{sid}_imu.pkl")
    return len(all_files)


def main():
    from gaitpd_torch.data.paths import weargait_paths

    p = weargait_paths()
    run_end_to_end(
        p["hc_path"], p["pd_path"], p["hc_demo_csv"], p["pd_demo_csv"], p["output_dir"]
    )


if __name__ == "__main__":
    main()
