"""gaitpd_torch.train.vmap_cv's flagship under FAMO and NashMTL against
gaitpd's own run_cv_vmapped on the CPU: sync GCL, 2 folds of
test_per_class 3, 2 epochs, from gaitpd's initial parameters (recorded by
wrapping gaitpd's ``init_stacked_state`` and copied into the port's model by
wrapping the port's, here only), with tests/test_torch_vmap_cv_baselines_
gaitpd.py's helper. FAMO carries seven state entries from step to step,
NashMTL a state and its solver (the plain version here); the other methods'
stacked steps are held against the port's own per-fold combine in
tests/test_torch_vmap_mtl.py, and their sequential runs against gaitpd's in
tests/test_torch_mtl_driver.py.

Tolerances, those of tests/test_torch_vmap_cv.py::
test_run_cv_vmapped_matches_gaitpd: per-epoch train losses within 1e-4
relative; each fold's best macro accuracy, 7-subset score and per-modality
accuracy within one eval window's share.
"""

import pytest

pytest.importorskip("jax")

from test_torch_vmap_cv_baselines import COMMON, one_thread  # noqa: E402,F401
from test_torch_vmap_cv_baselines_gaitpd import assert_vmapped_matches_gaitpd  # noqa: E402


@pytest.mark.parametrize("name", ["famo", "nashmtl"])
def test_mtl_method_matches_gaitpd(monkeypatch, name):
    assert_vmapped_matches_gaitpd(monkeypatch, dict(COMMON, mtl_method=name))
