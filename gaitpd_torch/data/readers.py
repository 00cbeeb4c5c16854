"""Host-side raw dataset readers: the port's own copy of
gaitpd/data/readers.py:28-364.

* FBGReader: processed mocap skeleton .npy, GRF .npy and the PDGinfo label
  table, with min-max-normalised demographics (reference
  train/data_processing/preprocess_fbg.py:7-149);
* FoGReader: mmpose 3-D prediction JSONs (the first 7 keypoints a frame)
  and 6-channel IMU .txt (columns 2:8, every third row), each cut into 36
  equal segments; H&Y labels less 2; the reference's hand-picked bad
  segments removed (preprocess_fog.py:6-208);
* the WearGait pickle readers (reference dataloader_weargait.py:76-178):
  the insole's and the IMU's tuple columns expanded to the fixed 13- and
  24-channel sets, the walkway's 2 columns; a missing or all-NaN column
  becomes zeros.

The label tables and the pickles are pandas objects, so these functions
import pandas when they run; importing this module needs only numpy.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np


def read_label_table(path):
    """Label tables ship as .xlsx (reference reads with openpyxl); .csv is
    also accepted so environments without an xlsx engine can convert."""
    import pandas as pd

    path = Path(path)
    if path.suffix.lower() == ".csv":
        return pd.read_csv(path)
    return pd.read_excel(path, engine="openpyxl")


# ---------------------------------------------------------------------------
# FBG (UPDRS-III walking) reader
# ---------------------------------------------------------------------------


class FBGReader:
    """Interface-compatible with the reference PDReader: pose_dict,
    sensor_dict, pose_label_dict, sensor_label_dict, metadata_dict (each
    value an object array of the demographics), video_names."""

    ON_LABEL_COLUMN = "ON - UPDRS-III - walking"
    OFF_LABEL_COLUMN = "OFF - UPDRS-III - walking"

    def __init__(self, joints_path, sensor_path, labels_path):
        # the label tables are pandas frames, kept only while reading: a
        # pickled reader then holds numpy arrays and builtins alone, which
        # the port's reader cache loads (gaitpd_torch.data.cache)
        self.label_list = read_label_table(labels_path)
        self.metadata_table = self._metadata_table()
        try:
            self.sensor_dict, self.sensor_label_dict = self._read_sensors(sensor_path)
            (
                self.pose_dict,
                self.pose_label_dict,
                self.video_names,
                self.metadata_dict,
            ) = self._read_poses(joints_path)
        finally:
            del self.label_list, self.metadata_table

    # -- labels / metadata ---------------------------------------------------
    def _label_for(self, file_name: str) -> int:
        """UPDRS label by subject + on/off (reference preprocess_fbg.py:73-85)."""
        subject_id, on_or_off = file_name.split("_")[:2]
        df = self.label_list[["ID", self.ON_LABEL_COLUMN, self.OFF_LABEL_COLUMN]]
        rows = df[df["ID"] == subject_id]
        col = self.ON_LABEL_COLUMN if on_or_off == "on" else self.OFF_LABEL_COLUMN
        return int(rows[col].values[0])

    def _metadata_table(self):
        """Min-max normalised demographics (reference preprocess_fbg.py:93-109)."""
        import pandas as pd

        df = self.label_list[
            ["ID", "Gender", "Age", "Height (cm)", "Weight (kg)", "BMI (kg/m2)"]
        ].copy()
        df.columns = ["ID", "gender", "age", "height", "weight", "bmi"]
        df["gender"] = df["gender"].map({"M": 0, "F": 1}).astype(float)
        for col in ("age", "height", "weight", "bmi"):
            df[col] = pd.to_numeric(df[col], errors="coerce")
            denom = df[col].max() - df[col].min()
            df[col] = 0.0 if denom == 0 else (df[col] - df[col].min()) / denom
        return df

    def _metadata_for(self, file_name: str):
        sid = file_name.split("_")[0]
        rows = self.metadata_table[self.metadata_table["ID"] == sid]
        return np.asarray(rows.values[:, 1:], dtype=object)

    # -- arrays ----------------------------------------------------------------
    def _read_sensors(self, sensor_path):
        """GRF npy files named SUBxx_on_left.npy -> keys SUBxx_on_left
        (reference preprocess_fbg.py:29-55)."""
        sensor_dict, sensor_label = {}, {}
        for file in sorted(os.listdir(sensor_path)):
            if not file.endswith(".npy"):
                continue
            parts = file.split("_")
            key = f"{parts[0]}_{parts[1]}_{parts[2].split('.')[0]}"
            arr = np.load(Path(sensor_path) / file, allow_pickle=True)
            if arr.shape[1] != 0:
                sensor_dict[key] = arr
                sensor_label[key] = self._label_for(file)
        return sensor_dict, sensor_label

    def _read_poses(self, joints_path):
        """Skeleton npy, mm -> m (reference preprocess_fbg.py:58-71,111-138)."""
        pose_dict, pose_label, meta, names = {}, {}, {}, []
        for file_name in sorted(os.listdir(joints_path)):
            path = Path(joints_path) / file_name
            if not path.exists():
                continue
            body = np.load(path) / 1000.0
            label = self._label_for(file_name)
            stem = file_name.split(".")[0]
            pose_dict[stem] = body
            pose_label["_".join(stem.split("_")[:2])] = label
            meta[stem] = self._metadata_for(file_name)
            names.append(stem)
        return pose_dict, pose_label, names, meta


# ---------------------------------------------------------------------------
# FoG (turn-in-place) reader
# ---------------------------------------------------------------------------

# manually discarded segments with bad skeleton projections
# (reference preprocess_fog.py:44-64)
FOG_BAD_POSE_SEGMENTS = (
    ["SUB21_1_1"]
    + [f"SUB21_3_{i + 1}" for i in range(14)]
    + [f"SUB24_1_{i + 1}" for i in range(4)]
    + [f"SUB24_1_{i + 1}" for i in range(10, 20)]
)
FOG_BAD_SENSOR_SEGMENTS = ["SUB19_1_1"]


def segment_equal(seq: np.ndarray, n_segments: int) -> List[np.ndarray]:
    """Split into n equal parts; the last part absorbs the remainder
    (reference preprocess_fog.py:100-108,141-149)."""
    total = seq.shape[0]
    seg_len = total // n_segments
    if seg_len == 0:
        return []
    out = []
    for i in range(n_segments):
        start = i * seg_len
        end = (i + 1) * seg_len if i < n_segments - 1 else total
        if end - start >= 1:
            out.append(seq[start:end])
    return out


class FoGReader:
    """Interface-compatible with the reference pdfeReader: pose_dict,
    sensor_dict, labels_dict, sensor_length."""

    def __init__(
        self,
        pose_path,
        sensor_path,
        label_path,
        lifted_path,
        pose_seg: int = 36,
        sensor_seg: int = 36,
        downsample_factor: int = 3,
    ):
        self.pose_segs = pose_seg
        self.sensor_segs = sensor_seg
        self.downsample_factor = downsample_factor
        self.sensor_dict, self.sensor_length = self._load_sensors(sensor_path)
        self.labels_dict = self._load_labels(label_path)
        self.pose_dict = self._load_poses(pose_path, lifted_path)
        self._discard_bad_segments()
        print(f"self.sensor_length is :{self.sensor_length}")

    def _discard_bad_segments(self):
        """reference preprocess_fog.py:44-64 (incl. the SUB19 label patch)."""
        if "SUB21_1_1" in self.pose_dict:
            for k in FOG_BAD_POSE_SEGMENTS:
                self.pose_dict.pop(k, None)
        for k in FOG_BAD_SENSOR_SEGMENTS:
            self.sensor_dict.pop(k, None)
        if "SUB21" in self.labels_dict:
            self.labels_dict["SUB19"] = [2]

    def _load_poses(self, pose_path, lifted_path):
        """mmpose 3-D JSONs: first person, first 7 keypoints per frame, split
        into 36 equal segments (reference preprocess_fog.py:66-109)."""
        lifted = {
            f.replace(".mp4", "")
            for f in os.listdir(lifted_path)
            if f.endswith(".mp4")
        }
        pose_dict = {}
        for file in sorted(os.listdir(pose_path)):
            if not file.endswith(".json"):
                continue
            video = file.replace("_3d_predictions.json", "")
            if video not in lifted:
                continue
            video = video.replace("PDFE", "SUB")
            with open(Path(pose_path) / file) as f:
                data = json.load(f)
            frames = []
            for frame_pred in data:
                instances = frame_pred.get("predictions") or []
                if not instances:
                    continue
                frames.append(instances[0][0]["keypoints"][0:7])
            seq = np.asarray(frames)  # (T, 7, 3)
            video = video.replace("_cropped", "")
            segs = segment_equal(seq, self.pose_segs)
            if not segs:
                print(f"[WARN] Skipping {video} — too few frames for {self.pose_segs} segments.")
                continue
            for i, seg in enumerate(segs, 1):
                pose_dict[f"{video}_{i}"] = seg
        return pose_dict

    def _load_sensors(self, sensor_path):
        """IMU .txt: columns 2:8, downsample x3, split into 36 segments
        (reference preprocess_fog.py:111-152)."""
        import pandas as pd

        raw, sensor_dict, max_len = {}, {}, 0
        for fname in sorted(os.listdir(sensor_path)):
            if not fname.endswith(".txt") or "standing" in fname.lower():
                continue
            try:
                df = pd.read_csv(
                    Path(sensor_path) / fname, sep=r"\s{2,}|\t", engine="python"
                )
                sig = df.iloc[:, 2:8].to_numpy()[:: self.downsample_factor, :]
                raw[fname.replace(".txt", "")] = sig
            except Exception as e:  # noqa: BLE001 — skip unreadable trials like the reference
                print(f"[ERROR] Failed to read {fname}: {e}")
        for name, signal in raw.items():
            segs = segment_equal(signal, self.sensor_segs)
            if not segs:
                print(f"[WARN] Skipping {name} — too few samples for {self.sensor_segs} segments.")
                continue
            for i, seg in enumerate(segs, 1):
                sensor_dict[f"{name}_{i}"] = seg
                max_len = max(max_len, seg.shape[0])
        print(f"[INFO] Sensor segmentation complete: {len(sensor_dict)} segments generated.")
        return sensor_dict, max_len

    def _load_labels(self, label_path):
        """H&Y labels, normalised by -2 (reference preprocess_fog.py:154-180)."""
        import pandas as pd

        df = read_label_table(label_path)
        df.columns = [str(c).strip() for c in df.columns]
        hy_cols = [c for c in df.columns if "H&Y" in c]
        out = {}
        for idx, row in df.iterrows():
            if idx == 0:
                continue
            labels = []
            for col in hy_cols:
                try:
                    if pd.notna(row[col]):
                        labels.append(int(row[col]) - 2)
                except ValueError:
                    continue
            if labels:
                out[f"SUB{idx:02d}"] = labels
        return out


# WearGait preprocessed pickles


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
