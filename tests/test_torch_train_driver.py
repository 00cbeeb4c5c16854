"""gaitpd_torch.train.weargait_driver.run_cv against
gaitpd.train.weargait_driver.run_cv on the CPU, from the same initial
parameters: gaitpd's init is recorded and copied into the port's model by
wrapping each package's ``init_train_state`` (here only; gaitpd's
single-modality driver builds its ``TrainState`` directly, so that is
wrapped too). The synthetic streams, folds, epoch orders and async pools come
from the same seeds, so both runs see the same batches. The configurations:
the flagship with CAGrad, the cheap cross-attention fusion baseline (sync and
async, the mean of the branch losses) and the single-modality mode.

Tolerances: per-epoch losses within 1e-4 relative (f32 on both sides; the
sums and the CAGrad solver's golden-section comparisons round differently,
and a few epochs of SGD carry that forward); each 7-mask accuracy within one
eval window's share, since an argmax on a near-tie may flip.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import gaitpd.train.step as JS  # noqa: E402
import gaitpd.train.weargait_driver as JD  # noqa: E402
import gaitpd_torch.train.weargait_driver as TD  # noqa: E402
from gaitpd_torch.params import load_flax_params  # noqa: E402

LOSS_RTOL = 1e-4

CONFIGS = {
    # the sizes of tests/test_e2e.py:44-53
    "sync_gcl": dict(n_folds=2, test_per_class=3, epochs=3, patience=50, synthetic=True,
                     verbose=False, seed=0, n_folds_cap=1, wm="gcl", alpha=0.5),
    "async_class_wt": dict(n_folds=2, test_per_class=3, epochs=2, patience=50,
                           synthetic=True, verbose=False, seed=0, n_folds_cap=1,
                           wm="class_wt", alpha=0.5, async_loading=True),
    "cheap_xattn_sync_gcl": dict(n_folds=2, test_per_class=3, epochs=3, patience=50,
                                 synthetic=True, verbose=False, seed=0, n_folds_cap=1,
                                 wm="gcl", alpha=0.5, baseline="cheap_xattn"),
    "cheap_xattn_async_class_wt": dict(n_folds=2, test_per_class=3, epochs=2, patience=50,
                                       synthetic=True, verbose=False, seed=0, n_folds_cap=1,
                                       wm="class_wt", alpha=0.5, async_loading=True,
                                       baseline="cheap_xattn"),
    "single_mod_imu_gcl": dict(n_folds=2, test_per_class=3, epochs=3, patience=50,
                               synthetic=True, verbose=False, seed=0, n_folds_cap=1,
                               wm="gcl", alpha=0.5, single_mod="imu"),
}


def _run_both(monkeypatch, kw):
    record = {"jax_init": None, "jax": [], "port": [], "n_eval": []}

    orig_j_init = JD.init_train_state

    def j_init(*a, **k):
        state, partition = orig_j_init(*a, **k)
        record["jax_init"] = jax.device_get(state.params)
        return state, partition

    orig_j_train, orig_j_eval = JD.run_train_epoch, JD.run_eval_epoch

    def j_train(*a, **k):
        state, tr = orig_j_train(*a, **k)
        record["jax"].append(np.asarray(tr.loss))
        return state, tr

    def j_eval(runner, state, data, *a, **k):
        record["n_eval"].append(len(data.eval_pool))
        return orig_j_eval(runner, state, data, *a, **k)

    orig_j_state = JS.TrainState

    def j_state(**k):  # the single-modality driver's init
        record["jax_init"] = jax.device_get(k["params"])
        return orig_j_state(**k)

    monkeypatch.setattr(JD, "init_train_state", j_init)
    monkeypatch.setattr(JS, "TrainState", j_state)
    monkeypatch.setattr(JD, "run_train_epoch", j_train)
    monkeypatch.setattr(JD, "run_eval_epoch", j_eval)
    ref = JD.run_cv(JD.WearGaitArgs(**kw))

    orig_t_init = TD.init_train_state

    def t_init(model, *a, **k):
        load_flax_params(model, record["jax_init"])
        return orig_t_init(model, *a, **k)

    def on_epoch(fold, ep, state, tr, ev):
        record["port"].append(np.asarray(tr.loss))

    monkeypatch.setattr(TD, "init_train_state", t_init)
    got = TD.run_cv(TD.WearGaitArgs(device="cpu", **kw), on_epoch=on_epoch)
    return ref, got, record


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_run_cv_matches_gaitpd(monkeypatch, name):
    ref, got, rec = _run_both(monkeypatch, CONFIGS[name])
    assert len(rec["port"]) == len(rec["jax"]) == CONFIGS[name]["epochs"]
    for ep, (p, j) in enumerate(zip(rec["port"], rec["jax"]), 1):
        np.testing.assert_allclose(p, j, rtol=LOSS_RTOL, err_msg=f"epoch {ep} train losses")
    share = 100.0 / max(rec["n_eval"])
    assert set(got["masks"]) == set(ref["masks"]) == set(TD.MASK_COMBOS)
    for mk in TD.MASK_COMBOS:
        if "single_mod" in CONFIGS[name]:  # no masked table
            assert got["masks"][mk] is None and ref["masks"][mk] is None
            continue
        assert abs(got["masks"][mk] - ref["masks"][mk]) <= share + 1e-4, (
            mk, got["masks"][mk], ref["masks"][mk])
    assert abs(got["macro"][0] - ref["macro"][0]) <= share + 1e-4
    for mod in TD.MODALITIES:
        assert abs(got["per_mod"][mod] - ref["per_mod"][mod]) <= share + 1e-4, mod


def test_default_device_is_the_card():
    """device=None means the card: without one, run_cv raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    args = TD.WearGaitArgs(**CONFIGS["sync_gcl"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.run_cv(args)


@pytest.mark.parametrize("option", [
    dict(baseline="deepav_lite"), dict(baseline="taca"), dict(ckpt_dir="ck"),
    dict(resume=True), dict(fused=True), dict(aug_noise_std=0.1),
    dict(modality_dropout=0.2), dict(synthetic=False), dict(mesh=object()),
    dict(mtl_method="mgda"),
])
def test_unported_options_raise(option):
    kw = {**CONFIGS["sync_gcl"], "epochs": 1, "device": "cpu", **option}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TD.run_cv(TD.WearGaitArgs(**kw))


@pytest.mark.parametrize("method, wants_c", [("cagrad", True), ("log_cagrad", True),
                                             ("pcgrad", False)])
def test_make_method_gets_c_only_for_cagrad(monkeypatch, method, wants_c):
    """CAGrad's strength c (args.alpha) goes to cagrad and log_cagrad only,
    as gaitpd's driver builds the keywords (gaitpd/train/weargait_driver.py:283-289)."""
    seen = {}

    class Built(Exception):
        pass

    def record(name, n_tasks, **kwargs):
        seen.update(name=name, n_tasks=n_tasks, kwargs=kwargs)
        raise Built

    monkeypatch.setattr(TD, "make_method", record)
    kw = {**CONFIGS["sync_gcl"], "epochs": 1, "device": "cpu", "mtl_method": method}
    with pytest.raises(Built):
        TD.run_cv(TD.WearGaitArgs(**kw))
    assert (seen["name"], seen["n_tasks"]) == (method, 3)
    assert seen["kwargs"] == ({"c": CONFIGS["sync_gcl"]["alpha"]} if wants_c else {})
