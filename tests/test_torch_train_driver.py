"""gaitpd_torch.train.weargait_driver.run_cv against
gaitpd.train.weargait_driver.run_cv on the CPU, from the same initial
parameters: gaitpd's init is recorded and copied into the port's model by
wrapping each package's ``init_train_state`` (here only; gaitpd's
single-modality driver builds its ``TrainState`` directly, so that is
wrapped too). The synthetic streams, folds, epoch orders and async pools come
from the same seeds, so both runs see the same batches. The configurations:
the flagship with CAGrad, the cheap cross-attention fusion baseline (sync and
async, the mean of the branch losses) and the single-modality mode; the SOTA
baselines' cases (DeepAV-Lite, FOCAL, TACA) are in
test_torch_train_driver_sota.py, on the same helper. DeepAV-Lite and TACA
train with dropout, whose masks cannot match JAX's PRNG: here both packages
build them at dropout 0 (wrapping each ``build_model``, here only), and the
train forward still takes its ``train=True`` path.

Tolerances: per-epoch losses within 1e-4 relative (f32 on both sides; the
sums and the CAGrad solver's golden-section comparisons round differently,
and a few epochs of SGD carry that forward); each 7-mask accuracy within one
eval window's share, since an argmax on a near-tie may flip.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import gaitpd.train.step as JS  # noqa: E402
import gaitpd.train.weargait_driver as JD  # noqa: E402
import gaitpd_torch.train.weargait_driver as TD  # noqa: E402
from gaitpd_torch.models import baselines as TB  # noqa: E402
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


def _without_dropout(monkeypatch):
    """Both packages' build_model, with DeepAV-Lite and TACA at dropout 0."""
    orig_j, orig_t = JD.build_model, TD.build_model

    def j_build(args, sync_flag):
        model = orig_j(args, sync_flag)
        return model.clone(drop=0.0) if args.baseline in TD.DROPOUT_BASELINES else model

    def t_build(args, sync_flag, generator=None):
        return TB.without_dropout(orig_t(args, sync_flag, generator))

    monkeypatch.setattr(JD, "build_model", j_build)
    monkeypatch.setattr(TD, "build_model", t_build)


def _run_both(monkeypatch, kw):
    record = {"jax_init": None, "jax": [], "port": [], "n_eval": []}
    _without_dropout(monkeypatch)

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


def assert_run_cv_matches_gaitpd(monkeypatch, kw):
    """Both packages' run_cv from one init: per-epoch train losses within
    LOSS_RTOL, the 7-subset table, macro and per-modality accuracies within
    one eval window's share."""
    ref, got, rec = _run_both(monkeypatch, kw)
    assert len(rec["port"]) == len(rec["jax"]) == kw["epochs"]
    for ep, (p, j) in enumerate(zip(rec["port"], rec["jax"]), 1):
        np.testing.assert_allclose(p, j, rtol=LOSS_RTOL, err_msg=f"epoch {ep} train losses")
    share = 100.0 / max(rec["n_eval"])
    assert set(got["masks"]) == set(ref["masks"]) == set(TD.MASK_COMBOS)
    for mk in TD.MASK_COMBOS:
        if "single_mod" in kw:  # no masked table
            assert got["masks"][mk] is None and ref["masks"][mk] is None
            continue
        assert abs(got["masks"][mk] - ref["masks"][mk]) <= share + 1e-4, (
            mk, got["masks"][mk], ref["masks"][mk])
    assert abs(got["macro"][0] - ref["macro"][0]) <= share + 1e-4
    for mod in TD.MODALITIES:
        assert abs(got["per_mod"][mod] - ref["per_mod"][mod]) <= share + 1e-4, mod


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_run_cv_matches_gaitpd(monkeypatch, name):
    assert_run_cv_matches_gaitpd(monkeypatch, CONFIGS[name])


def test_default_device_is_the_card():
    """device=None means the card: without one, run_cv raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    args = TD.WearGaitArgs(**CONFIGS["sync_gcl"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.run_cv(args)


@pytest.mark.parametrize("baseline", TD.SOTA_BASELINES)
def test_sota_baselines_default_to_the_card(baseline):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    args = TD.WearGaitArgs(**dict(CONFIGS["cheap_xattn_sync_gcl"], baseline=baseline))
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.run_cv(args)


@pytest.mark.parametrize("baseline, torch_init", [("deepav_lite", False), ("deepav_lite", True),
                                                  ("focal", True), ("taca", True)])
def test_build_model_reads_torch_init_for_deepav_only(baseline, torch_init):
    """baseline_torch_init gives DeepAV-Lite's tokenizers torch's law (a
    random bias) and leaves the other baselines as they are, as in gaitpd."""
    args = TD.WearGaitArgs(baseline=baseline, baseline_torch_init=torch_init, seed=0)
    model = TD.build_model(args, True)
    plain = TD.build_model(dataclasses.replace(args, baseline_torch_init=False), True)
    if baseline == "deepav_lite":
        assert bool(model.core.tk_walkway.bias.any()) == torch_init
    else:
        for p, q in zip(model.parameters(), plain.parameters()):
            assert torch.equal(p, q)


@pytest.mark.parametrize("baseline, dropout", [("deepav_lite", True), ("taca", True),
                                               ("focal", False), ("cheap_xattn", False)])
def test_dropout_baselines_train_with_dropout(monkeypatch, baseline, dropout):
    """DeepAV-Lite and TACA take the dropout step settings (gaitpd/train/
    weargait_driver.py:291-292), the other baselines do not."""
    seen = []
    orig = TD.EpochRunner

    def runner(settings, *a, **k):
        seen.append(settings.dropout)
        return orig(settings, *a, **k)

    monkeypatch.setattr(TD, "EpochRunner", runner)
    kw = {**CONFIGS["cheap_xattn_sync_gcl"], "epochs": 1, "device": "cpu", "baseline": baseline}
    TD.run_cv(TD.WearGaitArgs(**kw))
    assert seen == [dropout]


@pytest.mark.parametrize("option", [dict(mesh=True)])
def test_unported_options_raise(option):
    """Once refused (ROADMAP Queue 1, item 14), a mesh now runs: run_cv
    data-parallel over a mesh of this process alone gives the results of
    run_cv without one, exactly (2 ranks: tests/test_torch_mesh.py)."""
    from test_torch_mesh import one_rank_mesh, one_thread_here

    kw = {**CONFIGS["sync_gcl"], "epochs": 1, "device": "cpu"}
    with one_thread_here(), one_rank_mesh() as mesh:
        got = TD.run_cv(TD.WearGaitArgs(**kw, mesh=mesh))
    with one_thread_here():
        assert got == TD.run_cv(TD.WearGaitArgs(**kw))


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
