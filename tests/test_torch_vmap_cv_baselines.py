"""gaitpd_torch.train.vmap_cv with WearGait's baselines and the recipe's
random draws, on the CPU.

Every baseline is held against gaitpd's own run_cv_vmapped in
tests/test_torch_vmap_cv_baselines_gaitpd*.py (files of their own, so that
the test workers spread the JAX runs; DeepAV-Lite and TACA there at dropout
0). Here each case is held fold by fold against the port's own sequential
``run_cv``, the yardstick for the draws, which come from torch generators
that no JAX run shares: the drawless fusion baselines and FOCAL; TACA
(async) and DeepAV-Lite (sync), which train with dropout; the flagship with
augmentation, modality dropout and the GCL noise, with patience 1 so that a
fold stops early, and with a fold that never improves; the single-modality
mode with its draws; and TACA under every draw, checkpointed at 2 epochs
and resumed to 3, bitwise equal to 3 straight.
Where a run draws, each fold's ``torch.Generator`` must end in the state
the sequential run leaves it in, bitwise: the same draws, in the same order,
of the same shapes. The per-fold draw (gaitpd_torch/runtime/fold_draws.py)
is held against sequential draws directly, with a fold that draws nothing;
the cross-attention's vmap rule folds the vmap axis into its problems; and
the CLI takes ``--vmap_folds`` with ``--baseline``, and with another
``--mtl_method`` for the flagship. The module runs with one intra-op
thread (restored after): its steps are many small ops, which the parallel
test workers' threads would otherwise oversubscribe.

Tolerances, those of tests/test_torch_vmap_cv.py: per-epoch train losses
within 1e-4 relative (the stacked step sums in other orders); each fold's
best macro accuracy, 7-subset score and per-modality accuracy within one
eval window's share, since an argmax on a near-tie may flip.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.func import vmap

import gaitpd_torch.cli as TC
import gaitpd_torch.ops.cheap_xattn as cx
import gaitpd_torch.train.vmap_cv as TV
import gaitpd_torch.train.weargait_driver as TD
from gaitpd_torch.runtime import fold_draws as FD

LOSS_RTOL = 1e-4
COMMON = dict(n_folds=2, test_per_class=3, epochs=2, patience=50, synthetic=True,
              verbose=False, seed=0, wm="gcl", alpha=0.5)
# every draw of the recipe: augmentation (gate, channel, noise), modality
# dropout and the GCL noise; alpha 0 (the mean of the branch losses) keeps
# the plain CAGrad solver's ~100k small ops a step out of these runs
RECIPE = dict(aug_noise_std=0.05, aug_axis_p=0.2, modality_dropout=0.3, noise_mul=0.5)


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


def _sequential_and_vmapped(monkeypatch, kw):
    """The port's run_cv and run_cv_vmapped on ``kw``: per fold, the per-epoch
    train losses, (best macro, per-mod accuracies, 7-subset scores) and the
    fold generator's final state of each."""
    seq = {"losses": {}, "folds": [], "generators": []}
    orig_eval = TD.run_eval_epoch
    orig_folds = {name: getattr(TD, name) for name in ("run_fold", "run_single_mod_fold")}

    def eval_epoch(runner, state, data, batch_size, generator, *a, **k):
        if not seq["generators"] or seq["generators"][-1] is not generator:
            seq["generators"].append(generator)  # each fold's, in fold order
        return orig_eval(runner, state, data, batch_size, generator, *a, **k)

    def keep(orig):
        def fold(*a, **k):
            out = orig(*a, **k)
            seq["folds"].append(out)
            return out
        return fold

    monkeypatch.setattr(TD, "run_eval_epoch", eval_epoch)
    for name, orig in orig_folds.items():
        monkeypatch.setattr(TD, name, keep(orig))
    args = TD.WearGaitArgs(**kw, device="cpu")
    TD.run_cv(args, on_epoch=lambda fi, ep, st, tr, ev:
              seq["losses"].setdefault(fi, []).append(np.asarray(tr.loss)))

    vm = {"losses": [], "generators": []}
    orig_streams = TV._random_streams

    def streams(*a):
        rngs, gens = orig_streams(*a)
        vm["generators"] = gens
        return rngs, gens

    monkeypatch.setattr(TV, "_random_streams", streams)
    res = TV.run_cv_vmapped(args, on_epoch=lambda ep, tr, ev: vm["losses"].append(tr["loss"]))
    return seq, vm, res


def assert_vmapped_matches_sequential(monkeypatch, kw, draws=False):
    """Losses and scores within tolerance fold by fold; with ``draws``, each
    fold generator's final state bitwise equal to the sequential one's, and
    moved from its seed (the run drew)."""
    seq, vm, res = _sequential_and_vmapped(monkeypatch, kw)
    share = _eval_share(kw)
    n_folds = len(seq["folds"])
    assert len(res["per_fold_macro"]) == n_folds
    for f in range(n_folds):
        for ep, want in enumerate(seq["losses"][f + 1]):  # to the fold's early stop
            np.testing.assert_allclose(vm["losses"][ep][f], want, rtol=LOSS_RTOL,
                                       err_msg=f"fold {f + 1}, epoch {ep + 1}")
        macro, _, masks = seq["folds"][f]
        assert abs(res["per_fold_macro"][f] - macro) <= share, (f, res["per_fold_macro"], macro)
        for mk, score in masks.items():
            assert abs(res["per_fold_masks"][mk][f] - score) <= share, (f, mk)
    for i, mod in enumerate(TD.MODALITIES):
        want = np.mean([fold[1][i] for fold in seq["folds"]])
        assert abs(res["per_mod"][mod] - want) <= share, mod
    assert len(seq["generators"]) == len(vm["generators"]) == n_folds
    for f, (s, v) in enumerate(zip(seq["generators"], vm["generators"])):
        assert torch.equal(v.get_state(), s.get_state()), f"fold {f + 1}'s draws"
        fresh = torch.Generator().manual_seed(kw["seed"] + f + 1).get_state()
        assert torch.equal(v.get_state(), fresh) != draws, f"fold {f + 1} drew: {draws}"
    return seq, vm, res


@pytest.mark.parametrize("baseline", ["early_fusion", "late_fusion", "shared_latent", "focal"])
def test_drawless_baselines_match_sequential(monkeypatch, baseline):
    assert_vmapped_matches_sequential(monkeypatch, dict(COMMON, baseline=baseline))


@pytest.mark.parametrize("baseline, async_loading", [("taca", True), ("deepav_lite", False)])
def test_dropout_baselines_match_sequential_draw_for_draw(monkeypatch, baseline, async_loading):
    """The two baselines that train with dropout: each fold's masks from its
    own generator, as the sequential run draws them."""
    kw = dict(COMMON, baseline=baseline, async_loading=async_loading, wm="class_wt")
    assert_vmapped_matches_sequential(monkeypatch, kw, draws=True)


def test_recipe_with_an_early_stop_matches_sequential(monkeypatch):
    """Every draw of the recipe, with patience 1: fold 1 stops at epoch 2 and
    fold 2 trains all 4 epochs. The stacked run keeps training fold 1 with
    its draws off, so its generator ends where its sequential run leaves it,
    after the masked eval's GCL noise."""
    kw = dict(COMMON, **RECIPE, seed=3, patience=1, epochs=4, alpha=0.0)
    seq, vm, _ = assert_vmapped_matches_sequential(monkeypatch, kw, draws=True)
    assert [len(seq["losses"][fi]) for fi in (1, 2)] == [2, 4]
    assert len(vm["losses"]) == 4


def test_recipe_with_a_fold_that_never_improves_matches_sequential(monkeypatch):
    """Every draw of the recipe where fold 1's stopper never records an
    improvement (in both runs): the sequential run_fold has no best
    parameters for it and runs no masked eval, so it draws no GCL noise
    there, and the stacked run must not draw for it either."""
    kw = dict(COMMON, **RECIPE, alpha=0.0)
    made = []

    class Stopper(TD.EarlyStopper):
        def __init__(self, patience):
            super().__init__(patience)
            self.fold = len(made) % kw["n_folds"]  # each run makes one a fold, in order
            made.append(self)

        def update(self, metric, payload=None):
            if self.fold == 0:
                self.no_improve += 1
                return False
            return super().update(metric, payload)

    monkeypatch.setattr(TD, "EarlyStopper", Stopper)
    monkeypatch.setattr(TV, "EarlyStopper", Stopper)
    seq, _, res = assert_vmapped_matches_sequential(monkeypatch, kw, draws=True)
    assert len(made) == 2 * kw["n_folds"]
    assert seq["folds"][0][2] == {} and seq["folds"][1][2]  # fold 1: no masked eval
    assert res["per_fold_macro"][0] == 0.0 < res["per_fold_macro"][1]


def test_recipe_on_ragged_batches_matches_sequential(monkeypatch):
    """Every draw of the recipe where the folds' batches differ (batch 16):
    fold 1's sixth train batch is all padding where fold 2's is not (78
    against 81 windows), and fold 1's sequential eval runs 4 batches against
    fold 2's 2 (35 against 32 windows, each count a power of two), so each
    fold draws in its own batches only."""
    kw = dict(COMMON, **RECIPE, seed=3, alpha=0.0, batch_size=16)
    splits = TV._folds_and_splits(TD.WearGaitArgs(**kw, device="cpu"))
    datas = [TD.split_to_device(s, False, kw["seed"], "cpu") for s in splits]
    assert [len(d.train_pool) for d in datas] == [78, 81]
    assert TV._eval_indices(TV.stack_folds(datas, "cpu"), 16)[2] == [4, 2]
    assert_vmapped_matches_sequential(monkeypatch, kw, draws=True)


def test_single_mod_recipe_matches_sequential(monkeypatch):
    """The single-modality mode's draws: augmentation and the GCL noise (it
    takes no modality dropout, as the sequential driver)."""
    kw = dict(COMMON, aug_noise_std=0.05, aug_axis_p=0.2, noise_mul=0.5, single_mod="imu",
              epochs=3)
    _, _, res = assert_vmapped_matches_sequential(monkeypatch, kw, draws=True)
    assert res["masks"] == {}


def test_resume_with_draws_is_bitwise_equal(monkeypatch, tmp_path):
    """TACA (dropout) under the whole recipe, 2 epochs then resumed to 3,
    against 3 straight: the same losses, results and generator states,
    bitwise."""
    kw = dict(COMMON, **RECIPE, baseline="taca", epochs=3, device="cpu")
    gens = []
    orig_streams = TV._random_streams

    def streams(*a):
        rngs, g = orig_streams(*a)
        gens.append(g)
        return rngs, g

    monkeypatch.setattr(TV, "_random_streams", streams)
    straight, resumed = [], []
    res = TV.run_cv_vmapped(TD.WearGaitArgs(**kw, ckpt_dir=str(tmp_path / "straight")),
                            on_epoch=lambda ep, tr, ev: straight.append((ep, tr["loss"])))
    cut = str(tmp_path / "cut")
    TV.run_cv_vmapped(TD.WearGaitArgs(**dict(kw, epochs=2), ckpt_dir=cut))
    again = TV.run_cv_vmapped(TD.WearGaitArgs(**kw, ckpt_dir=cut, resume=True),
                              on_epoch=lambda ep, tr, ev: resumed.append((ep, tr["loss"])))
    assert [ep for ep, _ in resumed] == [3]
    assert resumed[0][0] == straight[2][0] and np.array_equal(resumed[0][1], straight[2][1])
    assert again == res
    for f, (a, b) in enumerate(zip(gens[0], gens[2])):
        assert torch.equal(a.get_state(), b.get_state()), f"fold {f + 1}"
    snap = TV.load_vmap_snapshot(cut)
    assert snap["epoch"] == 3 and len(snap["generators"]) == COMMON["n_folds"]


# ---------------------------------------------------------------------------
# The per-fold draw
# ---------------------------------------------------------------------------


def _fold_sites(x, g):
    """Every kind of draw, at the shapes the step's sites take them."""
    return (FD.rand(x.shape, g, device=x.device),
            FD.randn(x.shape[-1:], g, device=x.device, dtype=x.dtype),
            FD.randint(0, 3, (x.shape[0],), g, device=x.device),
            FD.randint(0, 3, (), g, device=x.device))


def test_fold_draws_equal_sequential_draws_and_skip_inactive_folds():
    seeds = (11, 12, 13)
    active = (True, False, True)
    x = torch.zeros(len(seeds), 5, 4)
    gens = [torch.Generator().manual_seed(s) for s in seeds]

    def fold(x, token):
        return _fold_sites(x, FD.FoldDraws(gens, active, token))

    got = vmap(fold)(x, FD.fold_tokens(len(seeds)))
    for f, (seed, on) in enumerate(zip(seeds, active)):
        alone = torch.Generator().manual_seed(seed)
        if on:
            want = _fold_sites(x[f], alone)
            assert all(torch.equal(g[f], w) for g, w in zip(got, want)), f
        else:
            assert all(not g[f].any() for g in got), f  # zeros: dropout keeps all
        assert torch.equal(gens[f].get_state(), alone.get_state()), f
    for g, w in zip(got, _fold_sites(x[0], torch.Generator())):
        assert g.shape[1:] == w.shape and g.dtype == w.dtype


def test_fold_draws_outside_a_vmap_raise_and_a_generator_draws_as_torch():
    g = torch.Generator().manual_seed(5)
    with pytest.raises(ValueError, match="only under torch.func.vmap"):
        FD.rand((3,), FD.FoldDraws([g], [True], torch.zeros(())), device="cpu")
    want = torch.rand((3, 2), generator=torch.Generator().manual_seed(5))
    assert torch.equal(FD.rand((3, 2), g, device="cpu"), want)


def test_cheap_xattn_vmap_rule_folds_the_vmap_axis():
    """On CPU tensors the rule's flattened call takes the plain version: one
    call for every entry, values and gradients as per entry, and an
    unbatched argument (in_dims None) expanded."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(3, 4, 5, 6)).astype(np.float32)).requires_grad_()
    b = torch.from_numpy(rng.normal(size=(4, 7, 6)).astype(np.float32)).requires_grad_()
    out = vmap(cx._CheapXAttnFunction.apply, in_dims=(0, None))(a, b)
    want = torch.stack([cx.cheap_xattn_reference(a[f], b) for f in range(3)])
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    g = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    got = torch.autograd.grad(out, (a, b), g)
    want_g = torch.autograd.grad(want, (a, b), g)
    for x, y in zip(got, want_g):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_cli_vmap_folds_takes_a_baseline_and_refuses_another_mtl_method(monkeypatch):
    got = {}

    def driver(args, *a, **k):
        got["args"] = args
        return {}

    monkeypatch.setattr(TV, "run_cv_vmapped", driver)
    monkeypatch.setattr(TD, "run_cv", lambda *a, **k: pytest.fail("the sequential driver ran"))
    argv = ["--mode", "weargait", "--synthetic", "--vmap_folds", "--baseline", "taca",
            "--async_loading", "--device", "cpu"] + [f"--{k}={v}" for k, v in RECIPE.items()]
    TC.main(argv)
    args = got["args"]
    assert (args.baseline, args.async_loading) == ("taca", True)
    assert all(getattr(args, k) == v for k, v in RECIPE.items())
    # the flagship under another MTL method reaches the stacked driver too
    TC.main(["--mode", "weargait", "--synthetic", "--vmap_folds", "--mtl_method", "mgda",
             "--device", "cpu"])
    assert (got["args"].mtl_method, got["args"].baseline) == ("mgda", None)
    # a baseline takes no MTL method, as the sequential driver
    TC.main(argv + ["--mtl_method", "mgda"])
    assert dataclasses.replace(got["args"], mtl_method="cagrad") == args
