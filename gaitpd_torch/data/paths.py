"""Dataset paths. The port's own copy of the WearGait part of
gaitpd/data/paths.py: the roots resolve under the repository's ``data/``
directory, or under ``GAITPD_DATA_ROOT`` when that is set.
"""

from __future__ import annotations

import os
from pathlib import Path

PROJECT_ROOT = Path(__file__).resolve().parents[2]


def data_root() -> Path:
    env = os.environ.get("GAITPD_DATA_ROOT")
    return Path(env) if env else PROJECT_ROOT / "data"


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
