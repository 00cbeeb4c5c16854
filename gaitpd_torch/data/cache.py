"""Dataset caches: the WearGait part of gaitpd/data/cache.py (:93-95)."""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from gaitpd_torch.data.paths import weargait_paths


def count_weargait_pickles(root: Optional[Path] = None) -> int:
    """The ``*.pkl`` files in ``root`` (default: the preprocessed WearGait
    directory); 0 if it does not exist."""
    d = Path(root) if root else weargait_paths()["output_dir"]
    return len(list(d.glob("*.pkl"))) if d.exists() else 0
