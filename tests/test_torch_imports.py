"""The port stands alone: no module of gaitpd_torch, nor chip_smoke.py,
imports JAX, flax, optax, orbax or anything of the JAX package gaitpd."""

import ast
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
                 "gaitpd_torch/models/fusion.py", "chip_smoke.py"):
        assert must in names
