"""gaitpd_torch.train.vmap_cv (every fold in one step) on the CPU.

One case against gaitpd's own run_cv_vmapped: the sync flagship (GCL,
CAGrad 0.5, 2 folds of test_per_class 3, 2 epochs), from gaitpd's initial
parameters (recorded by wrapping gaitpd's ``init_stacked_state`` and copied
into the port's model by wrapping the port's, here only). Every other case
is held fold by fold against the port's own sequential ``run_cv``, which
tests/test_torch_train_driver.py holds against gaitpd's: async, the
single-modality mode, early stop (patience 1: fold 1 stops at epoch 2 while
fold 2 trains on to epoch 4, and fold 1's best stays frozen though its
stacked parameters score higher at epoch 3), a run checkpointed at 3
epochs and resumed to 5 (bitwise equal to 5 straight on the CPU) and
``WearGaitEngine.from_vmap_checkpoint`` against the stacked best
parameters. The early-stop and resume cases train on the mean of the
branch losses (alpha 0): they hold the driver's bookkeeping, and the plain
CAGrad solver's ~100k small ops a step would dominate their time; the
others run CAGrad. ``stack_index_batches`` and ``aggregate_folds`` match
gaitpd's on the same numpy inputs, and a fold whose batch is all padding
keeps its parameters and momentum bitwise. The module runs with one
intra-op thread (restored after): its steps are many small ops, which the
parallel test workers' threads would otherwise oversubscribe.

Tolerances, those of tests/test_torch_train_driver.py: per-epoch train
losses within 1e-4 relative (the stacked step sums in other orders: batched
products, grouped convolutions); each fold's best macro accuracy, 7-subset
score and per-modality accuracy within one eval window's share, since an
argmax on a near-tie may flip.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import gaitpd.train.vmap_cv as JV  # noqa: E402
import gaitpd.train.weargait_driver as JD  # noqa: E402
import gaitpd_torch.train.vmap_cv as TV  # noqa: E402
import gaitpd_torch.train.weargait_driver as TD  # noqa: E402
from gaitpd_torch.params import load_flax_params  # noqa: E402
from gaitpd_torch.serve import WearGaitEngine  # noqa: E402
from gaitpd_torch.train.optim import sgd_torch  # noqa: E402
from gaitpd_torch.train.step import StepSettings, make_loss_ctx  # noqa: E402

LOSS_RTOL = 1e-4
COMMON = dict(n_folds=2, test_per_class=3, epochs=2, patience=50, synthetic=True,
              verbose=False, seed=0, wm="gcl", alpha=0.5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eval_share(kw) -> float:
    """One eval window's share of an accuracy, in percent, at the largest
    fold's eval pool."""
    splits = TV._folds_and_splits(TD.WearGaitArgs(**kw, device="cpu"))
    return 100.0 / max(len(s.test_sync) for s in splits) + 1e-4


def test_run_cv_vmapped_matches_gaitpd(monkeypatch):
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
    want = JV.run_cv_vmapped(JD.WearGaitArgs(**COMMON))

    orig_t_init = TV.init_stacked_state

    def t_init(model, *a, **k):
        load_flax_params(model, rec["init"])
        return orig_t_init(model, *a, **k)

    monkeypatch.setattr(TV, "init_stacked_state", t_init)
    got = TV.run_cv_vmapped(TD.WearGaitArgs(**COMMON, device="cpu"),
                            on_epoch=lambda ep, tr, ev: rec["port"].append(tr["loss"]))
    # gaitpd aggregates each epoch's train, then eval metrics
    jax_train = rec["jax"][0:2 * COMMON["epochs"]:2]
    assert len(rec["port"]) == len(jax_train) == COMMON["epochs"]
    for ep, (p, j) in enumerate(zip(rec["port"], jax_train), 1):
        np.testing.assert_allclose(p, j, rtol=LOSS_RTOL, err_msg=f"epoch {ep}, (fold, task)")
    share = _eval_share(COMMON)
    np.testing.assert_allclose(got["per_fold_macro"], want["per_fold_macro"], atol=share)
    assert set(got["masks"]) == set(want["masks"]) == set(TD.MASK_COMBOS)
    for mk in TD.MASK_COMBOS:
        assert abs(got["masks"][mk] - want["masks"][mk]) <= share, mk
    for mod in TD.MODALITIES:
        assert abs(got["per_mod"][mod] - want["per_mod"][mod]) <= share, mod


def _sequential_and_vmapped(monkeypatch, kw):
    """The port's run_cv and run_cv_vmapped on ``kw``: per fold, the per-epoch
    train losses and (best macro, per-mod accuracies, 7-subset scores) of
    each."""
    seq = {"losses": {}, "folds": []}
    orig_fold, orig_single = TD.run_fold, TD.run_single_mod_fold

    def keep(orig):
        def fold(*a, **k):
            out = orig(*a, **k)
            seq["folds"].append(out)
            return out
        return fold

    monkeypatch.setattr(TD, "run_fold", keep(orig_fold))
    monkeypatch.setattr(TD, "run_single_mod_fold", keep(orig_single))
    args = TD.WearGaitArgs(**kw, device="cpu")
    TD.run_cv(args, on_epoch=lambda fi, ep, st, tr, ev:
              seq["losses"].setdefault(fi, []).append(np.asarray(tr.loss)))
    vm = {"losses": []}
    res = TV.run_cv_vmapped(args, on_epoch=lambda ep, tr, ev: vm["losses"].append(tr["loss"]))
    return seq, vm, res


def assert_vmapped_matches_sequential(monkeypatch, kw):
    seq, vm, res = _sequential_and_vmapped(monkeypatch, kw)
    share = _eval_share(kw)
    n_folds = len(seq["folds"])
    assert len(res["per_fold_macro"]) == n_folds
    for f in range(n_folds):
        losses = seq["losses"][f + 1]  # a sequential fold stops at its early stop
        for ep, want in enumerate(losses):
            np.testing.assert_allclose(vm["losses"][ep][f], want, rtol=LOSS_RTOL,
                                       err_msg=f"fold {f + 1}, epoch {ep + 1}")
        macro, per_mod, masks = seq["folds"][f]
        assert abs(res["per_fold_macro"][f] - macro) <= share, (f, res["per_fold_macro"], macro)
        for mk, score in masks.items():
            assert abs(res["per_fold_masks"][mk][f] - score) <= share, (f, mk)
    for i, mod in enumerate(TD.MODALITIES):
        want = np.mean([fold[1][i] for fold in seq["folds"]])
        assert abs(res["per_mod"][mod] - want) <= share, mod
    return seq, vm, res


def test_vmapped_matches_sequential_async(monkeypatch):
    assert_vmapped_matches_sequential(monkeypatch, dict(COMMON, wm="class_wt",
                                                        async_loading=True))


def test_vmapped_matches_sequential_single_mod(monkeypatch):
    _, _, res = assert_vmapped_matches_sequential(monkeypatch, dict(COMMON, single_mod="imu"))
    assert res["masks"] == {}


def test_vmapped_early_stop_matches_sequential(monkeypatch):
    """Fold 1 stops at epoch 2, fold 2 trains all 4 epochs: fold 1's best
    stays frozen while the stacked step goes on training it."""
    kw = dict(COMMON, patience=1, epochs=4, alpha=0.0)
    seq, vm, _ = assert_vmapped_matches_sequential(monkeypatch, kw)
    assert [len(seq["losses"][fi]) for fi in (1, 2)] == [2, 4]
    assert len(vm["losses"]) == 4


@pytest.fixture(scope="module")
def resumed_runs(tmp_path_factory):
    """The flagship 5 epochs straight (checkpointed), and 3 epochs then
    resumed to 5, with their per-epoch train losses."""
    root = tmp_path_factory.mktemp("vmap_ckpt")
    kw = dict(COMMON, epochs=5, alpha=0.0, device="cpu")
    straight, resumed = [], []
    res = TV.run_cv_vmapped(TD.WearGaitArgs(**kw, ckpt_dir=str(root / "straight")),
                            on_epoch=lambda ep, tr, ev: straight.append((ep, tr["loss"])))
    cut = str(root / "cut")
    TV.run_cv_vmapped(TD.WearGaitArgs(**dict(kw, epochs=3), ckpt_dir=cut))
    again = TV.run_cv_vmapped(TD.WearGaitArgs(**kw, ckpt_dir=cut, resume=True),
                              on_epoch=lambda ep, tr, ev: resumed.append((ep, tr["loss"])))
    return root, res, again, straight, resumed


def test_vmapped_resume_is_bitwise_equal(resumed_runs):
    root, res, again, straight, resumed = resumed_runs
    assert [ep for ep, _ in resumed] == [4, 5]
    for (ep, got), (ep2, want) in zip(resumed, straight[3:]):
        assert ep == ep2 and np.array_equal(got, want), ep
    assert again == res
    snap = TV.load_vmap_snapshot(root / "cut")
    assert snap["epoch"] == 5 and len(snap["best"]) == COMMON["n_folds"]


def test_from_vmap_checkpoint_serves_each_folds_best(resumed_runs):
    root = resumed_runs[0] / "straight"
    snap = TV.load_vmap_snapshot(root)
    best = snap["extras"]["best_params"]
    rng = np.random.default_rng(0)
    windows = {m: rng.normal(size=(5, 64, c)).astype(np.float32)
               for m, c in zip(TD.MODALITIES, (2, 13, 24))}
    for fold in range(COMMON["n_folds"]):
        model = TD.build_model(TD.WearGaitArgs(**COMMON), True)
        model.load_state_dict({k: v[fold] for k, v in best.items()})
        want = WearGaitEngine(model, device="cpu").predict_windows(windows)
        got = WearGaitEngine.from_vmap_checkpoint(root, fold, device="cpu")
        assert np.array_equal(got.predict_windows(windows), want)
    with pytest.raises(ValueError, match="out of range"):
        WearGaitEngine.from_vmap_checkpoint(root, COMMON["n_folds"], device="cpu")


def test_from_vmap_checkpoint_refuses_a_snapshot_without_best_params(tmp_path):
    TV.run_cv_vmapped(TD.WearGaitArgs(**dict(COMMON, epochs=1), single_mod="walkway",
                                      device="cpu", ckpt_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="best_params"):
        WearGaitEngine.from_vmap_checkpoint(tmp_path, 0, device="cpu")


def test_stack_index_batches_matches_gaitpd():
    rng = np.random.default_rng(3)
    pools = [rng.integers(0, 50, size=(n, 3)).astype(np.int32) for n in (70, 130, 9)]
    orders = [rng.permutation(len(p)) for p in pools]
    got = TV.stack_index_batches(pools, orders, 64)
    want = JV.stack_index_batches(pools, orders, 64)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, np.asarray(w))


def test_aggregate_folds_matches_gaitpd():
    rng = np.random.default_rng(4)
    f, nb, k = 3, 4, 3
    n = rng.integers(0, 64, size=(f, nb)).astype(np.float32)
    n[0, -1] = n[2, -2:] = 0.0  # fully padded batches
    metrics = {"losses": rng.normal(size=(f, nb, k)).astype(np.float32),
               "correct": np.minimum(rng.integers(0, 64, size=(f, nb, k)), n[..., None]),
               "n": n, "ens_correct": np.minimum(rng.integers(0, 64, size=(f, nb)), n)}
    got, want = TV.aggregate_folds(metrics), JV.aggregate_folds(metrics)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=1e-6)


def test_a_fully_padded_fold_keeps_its_state_bitwise():
    """A step where fold 2's batch is all padding: fold 2's parameters and
    momentum are the bits they were, fold 1's are those of the same step on
    fold 1 alone."""
    args = TD.WearGaitArgs(**COMMON, device="cpu")
    splits = TV._folds_and_splits(args)
    datas = [TD.split_to_device(s, False, args.seed, "cpu") for s in splits]
    data = TV.stack_folds(datas, "cpu")
    settings = StepSettings(n_streams=3, wm="gcl", synchronized=True,
                            private_grads="sum_plus_own")
    ctxs = [make_loss_ctx(settings, [np.bincount(np.asarray(d.ys[k])[d.train_pool[:, k]],
                                                 minlength=2) for k in range(3)])
            for d in datas]
    mtl = TD.make_method("cagrad", 3, c=0.5)
    make_opt = functools.partial(sgd_torch, lr=args.lr, momentum=0.9, weight_decay=1e-4)

    def state_and_runner(n_folds):
        state, partition = TV.init_stacked_state(TD.build_model(args, True), make_opt, mtl,
                                                 n_folds, "cpu")
        return state, TV.VmapEpochRunner(settings, mtl, partition)

    idx, valid = TV.stack_index_batches([d.train_pool for d in datas],
                                        [np.arange(len(d.train_pool)) for d in datas], 64)
    idx, valid = torch.from_numpy(idx), torch.from_numpy(valid)
    state, runner = state_and_runner(2)
    alone, runner1 = state_and_runner(1)
    data1 = dataclasses.replace(data, xs=tuple(x[:1] for x in data.xs),
                                ys=tuple(y[:1] for y in data.ys))
    for step, pad in enumerate((False, True)):  # a real step first: momentum exists
        v = valid[:, step].clone()
        if pad:
            v[1] = 0.0
        before = {n: (p.detach().clone(), state.optimizer.state.get(p, {})
                      .get("momentum_buffer", torch.zeros(0)).clone())
                  for n, p in state.params.items()}
        batch = TV._gather(data.xs, data.ys, idx[:, step], v, (0, 1, 2))
        state, metrics = runner.train_step(state, batch, TV.stack_ctx(ctxs), pad)
        batch1 = TV._gather(data1.xs, data1.ys, idx[:1, step], v[:1], (0, 1, 2))
        alone, _ = runner1.train_step(alone, batch1, TV.stack_ctx(ctxs[:1]), False)
    assert metrics["n"][1] == 0
    for name, p in state.params.items():
        old_p, old_buf = before[name]
        buf = state.optimizer.state[p]["momentum_buffer"]
        assert torch.equal(p.detach()[1], old_p[1]) and torch.equal(buf[1], old_buf[1]), name
        assert not torch.equal(p.detach()[0], old_p[0]), name
        q = alone.params[name]
        torch.testing.assert_close(p.detach()[0], q.detach()[0], rtol=1e-6, atol=1e-7)
