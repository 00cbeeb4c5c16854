"""gaitpd_torch.train.vmap_cv's SOTA baselines against gaitpd's own
run_cv_vmapped on the CPU, on the helper and tolerances of
test_torch_vmap_cv_baselines_gaitpd.py: FOCAL (sync, GCL without its
noise), TACA (async, class_wt) and DeepAV-Lite (sync, class_wt), the last
two built at dropout 0 in both packages. A file of its own, so that test
runners which hand out whole files to workers spread the JAX runs.
"""

import pytest

pytest.importorskip("jax")

from test_torch_vmap_cv_baselines import COMMON, one_thread  # noqa: E402,F401
from test_torch_vmap_cv_baselines_gaitpd import assert_vmapped_matches_gaitpd  # noqa: E402

SOTA_CASES = {
    "focal_sync_gcl": dict(COMMON, baseline="focal"),
    "taca_async_class_wt": dict(COMMON, baseline="taca", async_loading=True, wm="class_wt"),
    "deepav_lite_sync_class_wt": dict(COMMON, baseline="deepav_lite", wm="class_wt"),
}


@pytest.mark.parametrize("name", sorted(SOTA_CASES))
def test_sota_baseline_matches_gaitpd(monkeypatch, name):
    assert_vmapped_matches_gaitpd(monkeypatch, SOTA_CASES[name])
