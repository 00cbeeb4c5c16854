"""Builds the port's CUDA sources (gaitpd_torch/csrc/*.cu) with nvcc at first
use and loads them with ctypes.

Each source becomes one shared library with a plain C interface under
gaitpd_torch/_build/ (listed in .gitignore), named by a hash of the source
and the flags, so a changed source builds anew. A failed build raises with
nvcc's output. ``build_all`` starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the log
]

_loaded: Dict[str, ctypes.CDLL] = {}
# called with the BuildResult of each build that runs nvcc
# (gaitpd_torch.runtime.profiling.log_compile_times)
BUILD_LISTENERS: List[Callable[["BuildResult"], None]] = []


@dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output, with the -Xptxas -v lines


def sources() -> List[str]:
    """Names of the kernels in csrc/, one per .cu file."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH nor at {path}")
    return str(path)


def build(name: str) -> BuildResult:
    """Compile csrc/<name>.cu into _build/lib<name>_<hash>.so unless it is
    there already. The library appears under its final name only once nvcc
    has finished, so a concurrent loader never sees a partial file."""
    src = CSRC / f"{name}.cu"
    tag = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}_{tag}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        return BuildResult(name, out, 0.0, log_path.read_text() if log_path.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)
    result = BuildResult(name, out, seconds, log)
    for listener in BUILD_LISTENERS:
        listener(result)
    return result


def build_all() -> List[BuildResult]:
    """Build every source in csrc/ in parallel, one nvcc each."""
    names = sources()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name).path))
        _loaded[name] = lib
    return lib
