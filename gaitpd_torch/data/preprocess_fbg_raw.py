"""FBG raw preprocessor: mocap .c3d -> cleaned 17-joint H36M skeletons, and
GRF gait-cycle spreadsheets -> per-subject (101, n_trials, 3) npy arrays.
The port's own copy of gaitpd/data/preprocess_fbg_raw.py (reference
train/data_processing/preprocess_fbg_raw.py:18-276); no kernel, no device.

    python -m gaitpd_torch.data.preprocess_fbg_raw --input_path DIR [--grf]

The spreadsheets need pandas (and an Excel engine), which
``extract_grf_data`` imports when it runs.

The 44-marker PD marker set is reduced to H36M joints by the same averaging
rules (pelvis = mean of ASIS/PSIS, elbows/hands = lateral/medial midpoints,
neck/head = fixed offsets from the upper torso); frames with any all-zero
marker are dropped and their gap structure recorded. The c3d dependency is
optional exactly like the reference (:13-16).
"""

from __future__ import annotations

import argparse
import os
import re
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from gaitpd_torch.data.augment import H36M_FULL

try:  # optional, needed only to parse raw mocap files
    import c3d  # type: ignore
except ImportError:
    c3d = None

# PD 44-marker index map (reference preprocess_fbg_raw.py:18-63)
PD_MARKERS = {
    "CLAV": 0, "STRN": 1, "C7": 2, "T10": 3,
    "R.SHO": 4, "L.SHO": 5,
    "R.UPA": 6, "R.EL": 7, "R.EM": 8, "R.FRA": 9, "R.WL": 10, "R.WM": 11,
    "L.UPA": 12, "L.EL": 13, "L.EM": 14, "L.FRA": 15, "L.WL": 16, "L.WM": 17,
    "R.ASIS": 18, "L.ASIS": 19, "R.PSIS": 20, "L.PSIS": 21,
    "R.GTR": 22, "R.KNEE": 23, "R.HF": 24, "R.TT": 25, "R.ANKLE": 26,
    "R.HEEL": 27, "R.MT1": 28, "R.MT5": 29,
    "L.GTR": 30, "L.KNEE": 31, "L.HF": 32, "L.TT": 33, "L.ANKLE": 34,
    "L.HEEL": 35, "L.MT1": 36, "L.MT5": 37,
    "R.KNEE.MEDIAL": 38, "R.ANKLE.MEDIAL": 39, "R.MT2": 40,
    "L.KNEE.MEDIAL": 41, "L.ANKLE.MEDIAL": 42, "L.MT2": 43,
}

# fixed neck/head offsets from the upper torso, in mm
# (reference preprocess_fbg_raw.py:94-95)
NECK_OFFSET = np.array([0.27, 57.48, 11.44])
HEAD_OFFSET = np.array([-2.07, 165.23, 34.02])


def convert_pd_h36m(sequence: np.ndarray) -> np.ndarray:
    """(T, 44, 3) PD markers -> (T, 17, 3) H36M joints
    (reference preprocess_fbg_raw.py:66-97)."""
    p = PD_MARKERS
    h = H36M_FULL

    def m(*names):
        return np.mean([sequence[..., p[n], :] for n in names], axis=0)

    out = np.zeros(sequence.shape[:-2] + (17, 3))
    out[..., h["B.TORSO"], :] = m("L.ASIS", "R.ASIS", "L.PSIS", "R.PSIS")
    out[..., h["L.HIP"], :] = m("L.ASIS", "L.PSIS")
    out[..., h["L.KNEE"], :] = sequence[..., p["L.KNEE"], :]
    out[..., h["L.FOOT"], :] = sequence[..., p["L.ANKLE"], :]
    out[..., h["R.HIP"], :] = m("R.ASIS", "R.PSIS")
    out[..., h["R.KNEE"], :] = sequence[..., p["R.KNEE"], :]
    out[..., h["R.FOOT"], :] = sequence[..., p["R.ANKLE"], :]
    out[..., h["U.TORSO"], :] = m("C7", "CLAV")
    out[..., h["C.TORSO"], :] = m("STRN", "T10")
    out[..., h["R.SHOULDER"], :] = sequence[..., p["R.SHO"], :]
    out[..., h["R.ELBOW"], :] = m("R.EL", "R.EM")
    out[..., h["R.HAND"], :] = m("R.WL", "R.WM")
    out[..., h["L.SHOULDER"], :] = sequence[..., p["L.SHO"], :]
    out[..., h["L.ELBOW"], :] = m("L.EL", "L.EM")
    out[..., h["L.HAND"], :] = m("L.WL", "L.WM")
    out[..., h["NECK"], :] = out[..., h["U.TORSO"], :] + NECK_OFFSET
    out[..., h["HEAD"], :] = out[..., h["U.TORSO"], :] + HEAD_OFFSET
    return out


def identify_gaps(sequence) -> Dict[int, str]:
    """Record consecutive corrupted-frame gaps as {gap_idx: "start-end:len"}
    (reference preprocess_fbg_raw.py:160-188)."""
    gaps: Dict[int, str] = {}
    current = 0
    count = 0
    for idx, frame in enumerate(sequence):
        if np.any(np.all(frame == 0, axis=1)):
            current += 1
            if current == 1:
                gaps[count] = f"{idx}-"
        elif current > 0:
            gaps[count] += f"{idx}:{current}"
            count += 1
            current = 0
    if current > 0:
        gaps[count] += f"{len(sequence)}:{current}"
    return gaps


def read_pd(sequence_path) -> Tuple[np.ndarray, float, Dict]:
    """Read a .c3d file, drop frames with any all-zero marker, convert to
    H36M (reference preprocess_fbg_raw.py:121-158)."""
    if c3d is None:
        raise ImportError("c3d is required to read raw .c3d files")
    reader = c3d.Reader(open(sequence_path, "rb"))
    sequence, cleaned = [], []
    removed = 0
    for _, points, _ in reader.read_frames():
        frame = points[:44, :3]
        sequence.append(frame)
        if np.any(np.all(frame == 0, axis=1)):
            removed += 1
            continue
        cleaned.append(frame[None])
    if not cleaned:
        return np.array([]), 100.0, {}
    gaps = identify_gaps(sequence)
    removal_rate = removed / reader.frame_count * 100
    return convert_pd_h36m(np.concatenate(cleaned)), removal_rate, gaps


def extract_sort_key(file_name: str):
    """(subject, on-before-off, walk number) sort key
    (reference preprocess_fbg_raw.py:106-119)."""
    match = re.search(r"SUB(\d+)_([Oo]n|[Oo]ff)_walk_(\d+)", file_name)
    if match:
        return (
            int(match.group(1)),
            0 if match.group(2).lower() == "on" else 1,
            int(match.group(3)),
        )
    return (float("inf"), float("inf"), float("inf"))


def extract_grf_data(grf_root_folder, output_folder):
    """GRF xlsx sheets -> per subject/condition/foot (101, n_trials, 3) npy
    (reference preprocess_fbg_raw.py:190-276). Each sheet holds consecutive
    (x, y, z) column triplets, one gait-cycle trial per triplet."""
    import pandas as pd

    out = Path(output_folder)
    out.mkdir(parents=True, exist_ok=True)
    subject_data: Dict[str, Dict[str, List[np.ndarray]]] = {}
    for subj_folder in sorted(os.listdir(grf_root_folder)):
        subj_path = Path(grf_root_folder) / subj_folder
        if not subj_path.is_dir():
            continue
        slots = subject_data.setdefault(
            subj_folder, {"on_left": [], "on_right": [], "off_left": [], "off_right": []}
        )
        for condition in ("ON", "OFF"):
            grf_folder = subj_path / condition / "GRF"
            if not grf_folder.exists():
                continue
            for csv_file in sorted(os.listdir(grf_folder)):
                if not csv_file.endswith(".csv"):
                    continue
                low = csv_file.lower()
                side = "left" if "left" in low else "right" if "right" in low else None
                if side is None:  # sum_cycles sheets are skipped
                    continue
                xls = pd.ExcelFile(grf_folder / csv_file)
                df = pd.read_excel(xls, sheet_name=xls.sheet_names[0])
                if "gait" in str(df.columns[0]).lower():
                    df = df.iloc[1:, 1:]
                trials = []
                for start in range(0, df.shape[1] - 2, 3):
                    trials.append(df.iloc[:, start : start + 3].to_numpy())
                slots[f"{condition.lower()}_{side}"].extend(trials)

    for subj_id, foot_dict in subject_data.items():
        for slot, trials in foot_dict.items():
            arr = (
                np.concatenate([t[:, None, :] for t in trials], axis=1)
                if trials
                else np.zeros((101, 0, 3))
            )
            path = out / f"{subj_id}_{slot}.npy"
            np.save(path, arr)
            print(f"[GRF] Saved {path} => shape {arr.shape}")


def load_skip_stems(manifest_path) -> set:
    """Parse a removed-sequence manifest into a set of sequence stems.

    The reference ships `train/data_processing/removed_fbg_raw_sequences.csv`
    — a 315-row list (with duplicates) of discarded raw c3d paths like
    `./PD_3D_motion-capture_data/C3Dfiles/SUB09_on/SUB09_on_walk_8.c3d` —
    as a record of sequences excluded from the processed dataset. No
    reference code reads it back; here it is accepted as an explicit
    skip-list input so a rebuild reproduces the same exclusions. Matching is
    by file stem, so both bare names and full paths work."""
    stems = set()
    for line in Path(manifest_path).read_text().splitlines():
        line = line.strip().strip(",")
        if not line:
            continue
        name = os.path.basename(line)
        if name.endswith(".c3d"):
            name = name[:-4]
        stems.add(name)
    return stems


def process_c3d_tree(
    input_path, output_path, skip_manifest=None, removed_manifest_out=None
) -> List[Dict]:
    """Walk the C3Dfiles tree, clean every SUB*_walk_*.c3d, save npy, and
    return per-file stats rows (reference preprocess_fbg_raw.py:299-341).

    skip_manifest: optional removed-sequence CSV (see load_skip_stems) whose
    sequences are excluded up front.
    removed_manifest_out: optional path; sequences this run discards (empty
    after cleaning, or unreadable) are recorded there in the same format —
    regenerating the reference's manifest artifact from the raw data."""
    skip = load_skip_stems(skip_manifest) if skip_manifest else set()
    files = []
    for root, _, names in os.walk(input_path):
        for f in names:
            if f.endswith(".c3d") and "walk" in f and f.startswith("SUB"):
                files.append(os.path.join(root, f))
    files.sort(key=lambda x: extract_sort_key(os.path.basename(x)))
    Path(output_path).mkdir(parents=True, exist_ok=True)
    rows = []
    removed_paths = []
    for path in files:
        stem = os.path.basename(path)[:-4]
        if stem in skip:
            continue
        try:
            cleaned, removal_rate, gaps = read_pd(path)
        except Exception as e:  # noqa: BLE001 — continue past bad files like the reference
            print(f"Error reading {path}: {e}")
            removed_paths.append(path)
            continue
        if len(cleaned):
            np.save(Path(output_path) / f"{stem}.npy", cleaned)
        else:
            removed_paths.append(path)
        rows.append(
            {
                "file names": stem,
                "sequence length": len(cleaned),
                "removal_rate": removal_rate if len(cleaned) else "NA",
                "gaps info": f"gaps: {gaps.items()}" if gaps else "0 gaps",
            }
        )
    if removed_manifest_out:
        Path(removed_manifest_out).write_text(
            "".join(f"{p}\n" for p in removed_paths)
        )
    return rows


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_path", default="./PD_3D_motion-capture_data")
    parser.add_argument("--grf", action="store_true", help="also extract GRF npy")
    parser.add_argument(
        "--skip_manifest",
        default=None,
        help="removed-sequence CSV (e.g. the reference's "
        "removed_fbg_raw_sequences.csv) to exclude up front",
    )
    parser.add_argument(
        "--removed_out",
        default=None,
        help="write the sequences discarded by this run to a manifest CSV",
    )
    args = parser.parse_args()
    process_c3d_tree(
        os.path.join(args.input_path, "C3Dfiles"),
        os.path.join(args.input_path, "C3Dfiles_cleaned_sequences"),
        skip_manifest=args.skip_manifest,
        removed_manifest_out=args.removed_out,
    )
    if args.grf:
        extract_grf_data(
            os.path.join(args.input_path, "Gait cycle"),
            os.path.join(args.input_path, "GRF_processed"),
        )


if __name__ == "__main__":
    main()
