"""The port stands alone: no module of gaitpd_torch, nor chip_smoke.py,
imports JAX, flax, optax, orbax or anything of the JAX package gaitpd; and
every one of them imports without pandas, sklearn, matplotlib or openpyxl,
which the card's machine lacks (the real-data readers import pandas when
they run, the loss plots matplotlib)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "gaitpd"}
FILES = sorted((ROOT / "gaitpd_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax_or_gaitpd(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for must in ("gaitpd_torch/serve.py", "gaitpd_torch/ops/stream_block.py",
                 "gaitpd_torch/models/multitask.py", "gaitpd_torch/ops/cagrad_solver.py",
                 "gaitpd_torch/learning/losses.py", "gaitpd_torch/learning/minnorm.py",
                 "gaitpd_torch/learning/mtl.py", "gaitpd_torch/train/step.py",
                 "gaitpd_torch/train/loop.py", "gaitpd_torch/train/weargait_driver.py",
                 "gaitpd_torch/data/weargait.py", "gaitpd_torch/data/synthetic.py",
                 "gaitpd_torch/data/sampler.py", "gaitpd_torch/train/cv.py",
                 "gaitpd_torch/ops/attention.py", "gaitpd_torch/ops/cheap_xattn.py",
                 "gaitpd_torch/models/fusion.py", "gaitpd_torch/data/augment.py",
                 "gaitpd_torch/train/checkpoint.py", "gaitpd_torch/data/readers.py",
                 "gaitpd_torch/data/paths.py", "gaitpd_torch/data/cache.py",
                 "gaitpd_torch/data/preprocess_weargait.py",
                 "gaitpd_torch/tools/recipe_laws.py", "gaitpd_torch/config.py",
                 "gaitpd_torch/data/fbg_fog.py", "gaitpd_torch/train/metrics.py",
                 "gaitpd_torch/train/fbg_fog_driver.py",
                 "gaitpd_torch/train/baseline_drivers.py",
                 "gaitpd_torch/data/preprocess_fbg_raw.py", "gaitpd_torch/runtime/mesh.py",
                 "gaitpd_torch/runtime/remat.py", "gaitpd_torch/entry.py", "chip_smoke.py"):
        assert must in names


def test_port_imports_without_pandas():
    modules = [p.relative_to(ROOT).with_suffix("").as_posix().replace("/", ".")
               for p in FILES]
    code = ("import importlib, sys\n"
            "sys.modules['pandas'] = None  # import pandas now raises ImportError\n"
            f"for name in {modules!r}:\n"
            "    importlib.import_module(name)\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr


def test_port_imports_without_sklearn_matplotlib_openpyxl():
    modules = [p.relative_to(ROOT).with_suffix("").as_posix().replace("/", ".")
               for p in FILES]
    code = ("import importlib, sys\n"
            "for blocked in ('pandas', 'sklearn', 'matplotlib', 'openpyxl'):\n"
            "    sys.modules[blocked] = None\n"
            f"for name in {modules!r}:\n"
            "    importlib.import_module(name)\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'gaitpd')], 'the port imported JAX or gaitpd'\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr
