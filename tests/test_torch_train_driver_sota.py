"""gaitpd_torch.train.weargait_driver.run_cv against
gaitpd.train.weargait_driver.run_cv on the CPU for the SOTA baselines
DeepAV-Lite, FOCAL and TACA: sync 3 epochs of GCL and async 2 of class_wt,
as the cheap cross-attention baseline's cases in test_torch_train_driver.py,
whose helper, tolerances and dropout-0 builds they share; DeepAV-Lite also
with torch's init of its tokenizers. A file of their own, so that test
runners which hand out whole files to workers run them beside that file's
cases rather than after them.
"""

import pytest

pytest.importorskip("jax")

import gaitpd_torch.train.weargait_driver as TD  # noqa: E402
from test_torch_train_driver import CONFIGS, assert_run_cv_matches_gaitpd  # noqa: E402

SOTA_CONFIGS = {}
for _b in TD.SOTA_BASELINES:
    SOTA_CONFIGS[f"{_b}_sync_gcl"] = dict(CONFIGS["cheap_xattn_sync_gcl"], baseline=_b)
    SOTA_CONFIGS[f"{_b}_async_class_wt"] = dict(CONFIGS["cheap_xattn_async_class_wt"],
                                                baseline=_b)
SOTA_CONFIGS["deepav_lite_torch_init_sync_gcl"] = dict(SOTA_CONFIGS["deepav_lite_sync_gcl"],
                                                       baseline_torch_init=True)


@pytest.mark.parametrize("name", sorted(SOTA_CONFIGS))
def test_run_cv_matches_gaitpd(monkeypatch, name):
    assert_run_cv_matches_gaitpd(monkeypatch, SOTA_CONFIGS[name])
