"""The flagship's 17 MTL methods under gaitpd_torch.train.vmap_cv (every
fold in one step), on the CPU, without JAX.

A stacked step of every method at F = 3 folds is held fold by fold against
``combine_flat`` (gaitpd_torch.learning.mtl) on that fold's own per-task
matrix J, losses, state and generator: the stateful methods' states are
first advanced by stacked steps (DWA's past its window of 25, so that its
weights switch on), and each fold's generator must end bitwise where the
fold's own draw leaves it. The four solvers' vmap rules
(gaitpd_torch/ops/solver_folds.py) solve every fold in one call, bitwise as
a call of its own; ``fold_draws.randperm`` draws each fold's permutation
from its own generator; a fold whose batch is all padding keeps its
parameters, momentum and method state bitwise (DWA, FAMO, NashMTL). Then
``run_cv_vmapped`` of the three drawing methods (RLW, PCGrad, GradDrop,
with the GCL noise drawn first in each step) against the port's sequential
``run_cv`` (tests/test_torch_vmap_cv_baselines.py's rule: each fold's
generator bitwise equal at the end), and a DWA run checkpointed at epoch 2
and resumed to 3, bitwise equal to 3 straight. The methods against gaitpd's
own run_cv_vmapped: tests/test_torch_vmap_mtl_gaitpd.py. The module runs
with one intra-op thread (restored after), as tests/test_torch_vmap_cv.py.

Tolerances: final gradients within test_torch_mtl.py's GRAD_ATOL (1e-5, of
the largest value; the stacked products sum in another order); new states
within 1e-6 relative (and 1e-7 absolute).
"""

import functools

import numpy as np
import pytest
import torch
from torch.func import vmap

import gaitpd_torch.train.vmap_cv as TV
import gaitpd_torch.train.weargait_driver as TD
from gaitpd_torch.learning import mtl as TM
from gaitpd_torch.learning.minnorm import cagrad_weights
from gaitpd_torch.ops import cagrad_solver as CS
from gaitpd_torch.ops import mtl_solvers as MS
from gaitpd_torch.runtime import fold_draws as FD
from gaitpd_torch.train.optim import sgd_torch
from gaitpd_torch.train.step import StepSettings, make_loss_ctx
from test_torch_vmap_cv_baselines import (  # noqa: F401
    COMMON,
    assert_vmapped_matches_sequential,
    one_thread,
)

GRAD_ATOL = 1e-5  # tests/test_torch_mtl.py's
STATE_RTOL, STATE_ATOL = 1e-6, 1e-7
FOLDS = 3
# stacked steps before the compared one: DWA's past its window (25 steps)
WARM_STEPS = {"dwa": 26, "uw": 2, "famo": 3, "nashmtl": 3}


def _setup(name, n_folds=FOLDS):
    """The stacked flagship (sync GCL, ``sum_plus_own``) of ``n_folds``
    folds under method ``name`` (Uncertainty with lr 0.1, so that its state
    moves), its runner, every fold's train batches of 64 (index, validity),
    the stacked data and loss context, and one generator a fold."""
    args = TD.WearGaitArgs(**dict(COMMON, n_folds=n_folds), device="cpu")
    datas = [TD.split_to_device(s, False, args.seed, "cpu") for s in TV._folds_and_splits(args)]
    data = TV.stack_folds(datas, "cpu")
    settings = StepSettings(n_streams=3, wm="gcl", synchronized=True,
                            private_grads="sum_plus_own")
    ctx = TV.stack_ctx([make_loss_ctx(settings, [
        np.bincount(np.asarray(d.ys[k])[d.train_pool[:, k]], minlength=2) for k in range(3)])
        for d in datas])
    kwargs = {"lr": 0.1} if name == "uw" else {"c": 0.5} if "cagrad" in name else {}
    mtl = TM.make_method(name, 3, **kwargs)
    make_opt = functools.partial(sgd_torch, lr=args.lr, momentum=0.9, weight_decay=1e-4)
    state, partition = TV.init_stacked_state(TD.build_model(args, True), make_opt, mtl, n_folds,
                                             "cpu")
    idx, valid = TV.stack_index_batches([d.train_pool for d in datas],
                                        [np.arange(len(d.train_pool)) for d in datas], 64)
    gens = [torch.Generator().manual_seed(100 + f) for f in range(n_folds)]
    runner = TV.VmapEpochRunner(settings, mtl, partition)
    return state, runner, (torch.from_numpy(idx), torch.from_numpy(valid)), data, ctx, gens


def _batch(data, batches, step, valid=None):
    idx, v = batches
    return TV._gather(data.xs, data.ys, idx[:, step % idx.shape[1]],
                      v[:, step % idx.shape[1]] if valid is None else valid, (0, 1, 2))


def _clone(gen):
    out = torch.Generator()
    out.set_state(gen.get_state())
    return out


@pytest.mark.parametrize("name", sorted(TM.METHODS))
def test_stacked_step_matches_combine_flat_fold_by_fold(monkeypatch, name):
    state, runner, batches, data, ctx, gens = _setup(name)
    for step in range(WARM_STEPS.get(name, 0)):
        state, _ = runner.train_step(state, _batch(data, batches, step), ctx, False, gens)
    seen = {}
    orig = runner._combine

    def record(st, jmat, losses, generators, active):
        seen.update(jmat=jmat, losses=losses,
                    state={k: v.clone() for k, v in st.mtl_state.items()},
                    gens=[_clone(g) for g in generators])
        return orig(st, jmat, losses, generators, active)

    monkeypatch.setattr(runner, "_combine", record)
    state, _ = runner.train_step(state, _batch(data, batches, 1), ctx, False, gens)
    assert seen["jmat"].shape[:2] == (FOLDS, 3)
    got = torch.cat([p.grad.reshape(FOLDS, -1) for p in state.params.values()], 1)
    for f in range(FOLDS):
        old = {k: v[f] for k, v in seen["state"].items()}
        want, new, _ = TM.combine_flat(runner.mtl_method, seen["jmat"][f], seen["losses"][f],
                                       runner.partition, old, "sum_plus_own", seen["gens"][f])
        scale = max(want.abs().max().item(), 1.0)
        err = (got[f] - want).abs().max().item()
        assert err <= GRAD_ATOL * scale, (name, f, err)
        assert set(new) == set(state.mtl_state)
        for k, v in new.items():
            torch.testing.assert_close(state.mtl_state[k][f], v, rtol=STATE_RTOL,
                                       atol=STATE_ATOL, msg=f"{name} fold {f} state {k}")
        assert torch.equal(gens[f].get_state(), seen["gens"][f].get_state()), (name, f)
    if name == "dwa":
        assert (state.mtl_state["iter"] > runner.mtl_method.iteration_window).all()


def _grams(rng, n, k=3):
    a = rng.normal(size=(n, k, 6)) * 10.0 ** rng.uniform(-1, 1, size=(n, 1, 1))
    return torch.from_numpy((a @ a.transpose(0, 2, 1)).astype(np.float32))


@pytest.mark.parametrize("solver", ["cagrad", "min_norm", "fairgrad", "nashmtl"])
def test_solver_vmap_rule_solves_every_fold_in_one_call(monkeypatch, solver):
    """Each public solver under torch.func.vmap: one call of the plain
    version on the merged batch (F, N, K, K) -> F·N matrices, each fold's
    weights bitwise those of its own call; no launch is counted on the CPU;
    a nested vmap merges both axes; CAGrad's c_coef per fold as alone."""
    grams = _grams(np.random.default_rng(3), 3 * 2).reshape(3, 2, 3, 3)
    if solver == "nashmtl":
        grams = grams / torch.linalg.matrix_norm(grams)[..., None, None]
    run = {"cagrad": lambda g: CS.cagrad_solve(g, 0.5), "min_norm": MS.min_norm_solve,
           "fairgrad": lambda g: MS.fairgrad_solve(g, 2.0), "nashmtl": MS.nashmtl_solve}[solver]
    module, plain = (CS, "cagrad_solve_reference") if solver == "cagrad" else (
        MS, f"{solver}_solve_reference")
    calls = []
    orig = getattr(module, plain)

    def counted(g, *a):
        calls.append(tuple(g.shape))
        return orig(g, *a)

    monkeypatch.setattr(module, plain, counted)
    counters = (CS.launches, CS.fold_launches, MS.min_norm_launches, MS.fairgrad_launches,
                MS.nashmtl_launches, MS.min_norm_fold_launches, MS.fairgrad_fold_launches,
                MS.nashmtl_fold_launches)
    got = vmap(run)(grams)
    assert calls == [(6, 3, 3)]
    assert torch.equal(vmap(vmap(run))(grams), got) and calls[1:] == [(6, 3, 3)]
    for f in range(3):
        assert torch.equal(got[f], run(grams[f])), f
    assert torch.equal(got[2, 1], run(grams[2, 1]))
    assert counters == (CS.launches, CS.fold_launches, MS.min_norm_launches,
                        MS.fairgrad_launches, MS.nashmtl_launches, MS.min_norm_fold_launches,
                        MS.fairgrad_fold_launches, MS.nashmtl_fold_launches)
    if solver == "cagrad":
        coef = vmap(lambda g: CS.cagrad_c_coef(g, 0.5))(grams[:, 0])
        for f in range(3):
            assert torch.equal(coef[f], CS.cagrad_c_coef(grams[f, 0], 0.5)), f
        assert torch.equal(got[:, 0], cagrad_weights(grams[:, 0], coef))


def test_fold_draws_randperm_draws_each_fold_from_its_own_generator():
    seeds, active = (5, 6, 7), (True, False, True)
    gens = [torch.Generator().manual_seed(s) for s in seeds]
    perms = vmap(lambda t: FD.randperm(4, FD.FoldDraws(gens, active, t)))(FD.fold_tokens(3))
    assert perms.dtype == torch.int64 and perms.shape == (3, 4)
    for f, (seed, on) in enumerate(zip(seeds, active)):
        alone = torch.Generator().manual_seed(seed)
        want = torch.randperm(4, generator=alone) if on else torch.arange(4)
        assert torch.equal(perms[f], want), f  # an idle fold: the identity
        assert torch.equal(gens[f].get_state(), alone.get_state()), f
    g = torch.Generator().manual_seed(9)
    assert torch.equal(FD.randperm(5, g), torch.randperm(5, generator=torch.Generator()
                                                         .manual_seed(9)))


@pytest.mark.parametrize("name", ["dwa", "famo", "nashmtl"])
def test_a_fully_padded_fold_keeps_its_method_state_bitwise(name):
    """After two real steps (the states and momentum exist), a step where
    fold 2's batch is all padding: fold 2's parameters, momentum and method
    state keep their bits, the other folds' move."""
    state, runner, batches, data, ctx, gens = _setup(name)
    for step in range(2):
        state, _ = runner.train_step(state, _batch(data, batches, step), ctx, False, gens)
    valid = batches[1][:, 0].clone()
    valid[1] = 0.0
    before = {n: (p.detach().clone(), state.optimizer.state[p]["momentum_buffer"].clone())
              for n, p in state.params.items()}
    old_state = {k: v.clone() for k, v in state.mtl_state.items()}
    state, metrics = runner.train_step(state, _batch(data, batches, 0, valid), ctx, True, gens,
                                       [True, False, True])
    assert metrics["n"][1] == 0
    for n, p in state.params.items():
        old_p, old_buf = before[n]
        buf = state.optimizer.state[p]["momentum_buffer"]
        assert torch.equal(p.detach()[1], old_p[1]) and torch.equal(buf[1], old_buf[1]), n
    assert any(not torch.equal(p.detach()[0], before[n][0][0]) for n, p in state.params.items())
    for k, v in state.mtl_state.items():
        assert torch.equal(v[1], old_state[k][1]), (name, k)
    moved = [k for k, v in state.mtl_state.items() if not torch.equal(v[0], old_state[k][0])]
    assert moved, name


@pytest.mark.parametrize("name", ["rlw", "pcgrad", "graddrop"])
def test_drawing_methods_match_sequential_draw_for_draw(monkeypatch, name):
    """The GCL noise first, then the method's draw, in every step of each
    fold: each fold's generator ends where its sequential run leaves it."""
    assert_vmapped_matches_sequential(monkeypatch, dict(COMMON, mtl_method=name, noise_mul=0.5),
                                      draws=True)


def test_dwa_resume_is_bitwise_equal(tmp_path):
    """DWA 2 epochs then resumed to 3, against 3 straight: the same losses,
    results and stacked method state, bitwise."""
    kw = dict(COMMON, mtl_method="dwa", epochs=3, device="cpu")
    straight, resumed = [], []
    res = TV.run_cv_vmapped(TD.WearGaitArgs(**kw, ckpt_dir=str(tmp_path / "straight")),
                            on_epoch=lambda ep, tr, ev: straight.append((ep, tr["loss"])))
    cut = str(tmp_path / "cut")
    TV.run_cv_vmapped(TD.WearGaitArgs(**dict(kw, epochs=2), ckpt_dir=cut))
    snap = TV.load_vmap_snapshot(cut)
    assert snap["epoch"] == 2 and snap["mtl_state"]["costs"].shape[0] == COMMON["n_folds"]
    again = TV.run_cv_vmapped(TD.WearGaitArgs(**kw, ckpt_dir=cut, resume=True),
                              on_epoch=lambda ep, tr, ev: resumed.append((ep, tr["loss"])))
    assert [ep for ep, _ in resumed] == [3]
    assert np.array_equal(resumed[0][1], straight[2][1])
    assert again == res
    a, b = (TV.load_vmap_snapshot(str(tmp_path / d))["mtl_state"] for d in ("straight", "cut"))
    assert set(a) == {"costs", "iter"} and all(torch.equal(a[k], b[k]) for k in a)


def test_every_method_builds_as_gaitpd_builds_it(monkeypatch):
    """run_cv_vmapped makes the method as gaitpd's does: c = alpha for CAGrad
    and LOG_CAGrad only, and none at alpha 0 or with a baseline."""
    made = []

    def runner(settings, mtl=None, *a, **k):
        made.append(mtl)
        raise StopIteration

    monkeypatch.setattr(TV, "VmapEpochRunner", runner)
    for name in sorted(TM.METHODS):
        with pytest.raises(StopIteration):
            TV.run_cv_vmapped(TD.WearGaitArgs(**dict(COMMON, mtl_method=name), device="cpu"))
        kwargs = {"c": COMMON["alpha"]} if name in ("cagrad", "log_cagrad") else {}
        assert made[-1] == TM.make_method(name, 3, **kwargs), name
    for extra in (dict(alpha=0.0), dict(baseline="focal")):
        with pytest.raises(StopIteration):
            TV.run_cv_vmapped(TD.WearGaitArgs(**dict(COMMON, mtl_method="famo", **extra),
                                              device="cpu"))
        assert made[-1] is None, extra
