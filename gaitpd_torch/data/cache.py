"""Dataset caches: the FBG/FoG reader cache and the WearGait pickle count.
The port's own counterpart of gaitpd/data/cache.py:20-118 (reference
train/data_processing/dataset_cache.py:27-104, and its command line):

    python -m gaitpd_torch.data.cache [--datasets fbg fog weargait | all] [--rebuild]

A built reader is pickled once under the cache directory and loaded on
later runs, written whole through a temporary file. The port's files have
names of their own (``{dataset}_reader.gaitpd_torch.pkl``, and the legacy
``{walk,turn}_reader.gaitpd_torch.pkl``): a cache gaitpd wrote holds
gaitpd's reader classes, and loading it would import gaitpd. The port reads
its pickles through an unpickler that takes classes of ``builtins``,
``numpy`` and ``gaitpd_torch`` only, and refuses any other with an error
that names it.
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path
from typing import Any, Optional, Sequence

from gaitpd_torch.config import normalize_dataset_name, raw_reader_dataset_name
from gaitpd_torch.data.paths import cache_dir, get_pd_paths, weargait_paths

CACHE_SUFFIX = "_reader.gaitpd_torch.pkl"
ALLOWED_MODULES = ("builtins", "numpy", "gaitpd_torch")


class RestrictedUnpickler(pickle.Unpickler):
    """An unpickler that loads classes of ALLOWED_MODULES only."""

    def find_class(self, module: str, name: str):
        if module.split(".")[0] not in ALLOWED_MODULES:
            raise pickle.UnpicklingError(
                f"the reader cache names {module}.{name}; it loads classes of "
                f"{', '.join(ALLOWED_MODULES)} only (a cache written by gaitpd holds "
                "gaitpd's readers: rebuild it with rebuild=True)")
        return super().find_class(module, name)


def load_pickle(path: Path) -> Any:
    """The object pickled at ``path``, through RestrictedUnpickler."""
    with Path(path).open("rb") as f:
        return RestrictedUnpickler(f).load()


def reader_cache_path(dataset: str, root: Optional[Path] = None) -> Path:
    dataset = normalize_dataset_name(dataset)
    return (Path(root) if root else cache_dir()) / f"{dataset}{CACHE_SUFFIX}"


def legacy_reader_cache_path(dataset: str, root: Optional[Path] = None) -> Path:
    return (Path(root) if root else cache_dir()) / (
        f"{raw_reader_dataset_name(dataset)}{CACHE_SUFFIX}")


def build_reader(dataset: str) -> Any:
    """The raw reader of ``dataset`` from get_pd_paths() (reference
    dataset_cache.py:38-61); needs pandas."""
    dataset = normalize_dataset_name(dataset)
    paths = get_pd_paths()
    if dataset == "fbg":
        from gaitpd_torch.data.readers import FBGReader

        p = paths["walk"]
        return FBGReader(p["pose_path"], p["sensor_path"], p["label_path"])
    if dataset == "fog":
        from gaitpd_torch.data.readers import FoGReader

        p = paths["turn"]
        return FoGReader(p["pose_path"], p["sensor_path"], p["label_path"], p["lifted_path"])
    raise ValueError(f"Unknown cached reader dataset: {dataset}")


def load_reader(dataset: str, *, rebuild: bool = False, root: Optional[Path] = None) -> Any:
    """The cached reader of ``dataset``, the legacy-named one, or (with
    ``rebuild``, or neither there) a reader built from the raw data and
    pickled to the cache (reference dataset_cache.py:64-85)."""
    dataset = normalize_dataset_name(dataset)
    path = reader_cache_path(dataset, root)
    if path.exists() and not rebuild:
        print(f"[CACHE] Loading {dataset} reader from {path}")
        return load_pickle(path)
    legacy = legacy_reader_cache_path(dataset, root)
    if legacy.exists() and not rebuild:
        print(f"[CACHE] Loading {dataset} reader from legacy cache {legacy}")
        return load_pickle(legacy)
    print(f"[CACHE] Building {dataset} reader and saving to {path}")
    reader = build_reader(dataset)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    with tmp.open("wb") as f:
        pickle.dump(reader, f, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(path)
    return reader


def summarize_reader(dataset: str, reader: Any) -> dict:
    """Entry counts of a reader (reference dataset_cache.py:88-104)."""
    dataset = normalize_dataset_name(dataset)
    if dataset == "fbg":
        return {
            "pose_entries": len(reader.pose_dict),
            "sensor_entries": len(reader.sensor_dict),
            "pose_labels": len(reader.pose_label_dict),
            "sensor_labels": len(reader.sensor_label_dict),
        }
    if dataset == "fog":
        return {
            "pose_entries": len(reader.pose_dict),
            "sensor_entries": len(reader.sensor_dict),
            "subject_labels": len(reader.labels_dict),
            "sensor_length": int(reader.sensor_length),
        }
    raise ValueError(dataset)


def count_weargait_pickles(root: Optional[Path] = None) -> int:
    """The ``*.pkl`` files in ``root`` (default: the preprocessed WearGait
    directory); 0 if it does not exist."""
    d = Path(root) if root else weargait_paths()["output_dir"]
    return len(list(d.glob("*.pkl"))) if d.exists() else 0


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Build (or load) each requested reader's cache and print its entry
    counts; for WearGait, count the preprocessed pickles, and raise
    FileNotFoundError if there are none (gaitpd/data/cache.py:98-118)."""
    parser = argparse.ArgumentParser("Generate reusable dataset pickle caches")
    parser.add_argument(
        "--datasets", nargs="+", choices=["fbg", "fog", "weargait", "all"],
        default=["all"],
    )
    parser.add_argument("--rebuild", action="store_true")
    args = parser.parse_args(argv)
    requested = ["fbg", "fog", "weargait"] if "all" in args.datasets else args.datasets
    for dataset in requested:
        if dataset == "weargait":
            count = count_weargait_pickles()
            if count == 0:
                raise FileNotFoundError(
                    "No WearGait .pkl files found. Run "
                    "python -m gaitpd_torch.data.preprocess_weargait first."
                )
            print(f"[CACHE] WearGait already has {count} per-subject .pkl files.")
            continue
        reader = load_reader(dataset, rebuild=args.rebuild)
        print(f"[CACHE] {dataset}: {summarize_reader(dataset, reader)}")


if __name__ == "__main__":
    main()
