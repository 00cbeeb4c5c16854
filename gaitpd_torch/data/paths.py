"""Dataset paths. The port's own copy of gaitpd/data/paths.py (reference
const/path.py:4-72): the roots resolve under the repository's ``data/``
directory, or under ``GAITPD_DATA_ROOT`` when that is set, with the same
fallbacks to older layouts in the same order.
"""

from __future__ import annotations

import os
from pathlib import Path

PROJECT_ROOT = Path(__file__).resolve().parents[2]


def data_root() -> Path:
    env = os.environ.get("GAITPD_DATA_ROOT")
    return Path(env) if env else PROJECT_ROOT / "data"


def _pd_root() -> Path:
    raw = data_root() / "raw" / "PD_3D_motion-capture_data"
    legacy = PROJECT_ROOT / "PD_3D_motion-capture_data"
    return raw if raw.exists() else legacy


def _first_existing(*candidates: Path) -> Path:
    for p in candidates:
        if p.exists():
            return p
    return candidates[0]


def get_pd_paths() -> dict:
    """The FBG ("walk") and FoG ("turn") raw data paths (reference
    const/path.py:33-63): the first of each list that exists, else the
    first."""
    root = _pd_root()
    d = data_root()
    return {
        "walk": {
            "pose_path": _first_existing(
                root / "FBG", d / "FBG",
                root / "C3Dfiles_processed_new", d / "C3Dfiles_processed_new",
                root / "C3Dfiles_cleaned_sequences", d / "C3Dfiles_cleaned_sequences",
            ),
            "sensor_path": _first_existing(root / "GRF_processed", d / "GRF_processed"),
            "label_path": _first_existing(root / "PDGinfo.xlsx", d / "PDGinfo.xlsx"),
        },
        "turn": {
            "pose_path": _first_existing(
                root / "FoG" / "predictions", d / "FoG" / "predictions",
                root / "turn-in-place" / "predictions", d / "turn-in-place" / "predictions",
            ),
            "lifted_path": _first_existing(
                root / "FoG" / "lifted", d / "FoG" / "lifted",
                root / "turn-in-place" / "lifted", d / "turn-in-place" / "lifted",
            ),
            "sensor_path": _first_existing(
                root / "FoG" / "IMU", d / "FoG" / "IMU",
                root / "turn-in-place" / "IMU", d / "turn-in-place" / "IMU",
            ),
            "label_path": _first_existing(
                root / "FoG" / "PDFEinfo.xlsx", d / "FoG" / "PDFEinfo.xlsx",
                root / "turn-in-place" / "PDFEinfo.xlsx", d / "turn-in-place" / "PDFEinfo.xlsx",
            ),
        },
    }


def weargait_paths() -> dict:
    """The raw CSV roots, the demographics tables and the preprocessed
    pickles' directory of WearGait."""
    d = data_root() / "WearGait"
    return {
        "hc_path": d / "HC",
        "pd_path": d / "PD",
        "hc_demo_csv": d / "HC" / "hc_demographic.csv",
        "pd_demo_csv": d / "PD" / "pd_demographic.csv",
        "output_dir": d / "WearGait_preproc_SPmT_30Hz",
    }


def cache_dir() -> Path:
    return data_root() / "cache"
