"""gaitpd_torch.train.vmap_cv's WearGait baselines against gaitpd's own
run_cv_vmapped on the CPU: 2 folds of test_per_class 3, 2 epochs, from
gaitpd's initial parameters (recorded by wrapping gaitpd's
``init_stacked_state`` and copied into the port's model by wrapping the
port's, here only). This file holds the fusion baselines: the cheap
cross-attention (sync, class_wt) and the early, late and shared-latent
fusions (sync, GCL without its noise); the SOTA baselines' cases are in
test_torch_vmap_cv_baselines_gaitpd_sota.py, on this file's helper, so that
test runners which hand out whole files to workers spread the JAX runs.
DeepAV-Lite and TACA train with dropout, whose masks cannot match JAX's
PRNG: both packages build them at dropout 0, as test_torch_train_driver.py
does; their draws are held against the port's sequential run in
tests/test_torch_vmap_cv_baselines.py, whose constants and thread fixture
this file shares.

Tolerances, those of tests/test_torch_vmap_cv.py: per-epoch train losses
within 1e-4 relative; each fold's best macro accuracy, 7-subset score and
per-modality accuracy within one eval window's share.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import gaitpd.train.vmap_cv as JV  # noqa: E402
import gaitpd.train.weargait_driver as JD  # noqa: E402
import gaitpd_torch.train.vmap_cv as TV  # noqa: E402
import gaitpd_torch.train.weargait_driver as TD  # noqa: E402
from gaitpd_torch.params import load_flax_params  # noqa: E402
from test_torch_train_driver import _without_dropout  # noqa: E402
from test_torch_vmap_cv_baselines import (  # noqa: E402,F401
    COMMON,
    LOSS_RTOL,
    _eval_share,
    one_thread,
)


def assert_vmapped_matches_gaitpd(monkeypatch, kw):
    """Both packages' run_cv_vmapped on ``kw`` from gaitpd's initial
    parameters, DeepAV-Lite and TACA at dropout 0: each epoch's (fold, task)
    train losses within LOSS_RTOL, each fold's best macro accuracy, the
    7-subset scores and per-modality accuracies within one eval window's
    share."""
    _without_dropout(monkeypatch)
    monkeypatch.setattr(TV, "build_model", TD.build_model)  # the dropout-0 build
    rec = {"init": None, "jax": [], "port": []}
    orig_init, orig_agg = JV.init_stacked_state, JV.aggregate_folds

    def j_init(*a, **k):
        states, partition = orig_init(*a, **k)
        rec["init"] = jax.tree_util.tree_map(lambda v: np.asarray(v)[0],
                                             jax.device_get(states.params))
        return states, partition

    def j_agg(metrics):
        out = orig_agg(metrics)
        rec["jax"].append(out["loss"])
        return out

    monkeypatch.setattr(JV, "init_stacked_state", j_init)
    monkeypatch.setattr(JV, "aggregate_folds", j_agg)
    want = JV.run_cv_vmapped(JD.WearGaitArgs(**kw))

    orig_t_init = TV.init_stacked_state

    def t_init(model, *a, **k):
        load_flax_params(model, rec["init"])
        return orig_t_init(model, *a, **k)

    monkeypatch.setattr(TV, "init_stacked_state", t_init)
    got = TV.run_cv_vmapped(TD.WearGaitArgs(**kw, device="cpu"),
                            on_epoch=lambda ep, tr, ev: rec["port"].append(tr["loss"]))
    # gaitpd aggregates each epoch's train, then eval metrics
    jax_train = rec["jax"][0:2 * kw["epochs"]:2]
    assert len(rec["port"]) == len(jax_train) == kw["epochs"]
    for ep, (p, j) in enumerate(zip(rec["port"], jax_train), 1):
        np.testing.assert_allclose(p, j, rtol=LOSS_RTOL, err_msg=f"epoch {ep}, (fold, task)")
    share = _eval_share(kw)
    np.testing.assert_allclose(got["per_fold_macro"], want["per_fold_macro"], atol=share)
    assert set(got["masks"]) == set(want["masks"]) == set(TD.MASK_COMBOS)
    for mk in TD.MASK_COMBOS:
        assert abs(got["masks"][mk] - want["masks"][mk]) <= share, mk
    for mod in TD.MODALITIES:
        assert abs(got["per_mod"][mod] - want["per_mod"][mod]) <= share, mod


def test_cheap_xattn_matches_gaitpd(monkeypatch):
    assert_vmapped_matches_gaitpd(monkeypatch,
                                  dict(COMMON, baseline="cheap_xattn", wm="class_wt"))


@pytest.mark.parametrize("baseline", ["early_fusion", "late_fusion", "shared_latent"])
def test_fusion_baseline_matches_gaitpd(monkeypatch, baseline):
    assert_vmapped_matches_gaitpd(monkeypatch, dict(COMMON, baseline=baseline))
