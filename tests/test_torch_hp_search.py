"""gaitpd_torch.train.hp_search (an HP grid, every (row, fold) instance in
one stacked run) on the CPU, against the port's own run_cv_vmapped and
run_fbg_fog_vmapped, which tests/test_torch_vmap_cv.py and
test_torch_vmap_fbg_fog.py hold against the sequential drivers. No JAX
here; tests/test_torch_hp_search_gaitpd.py holds the grids against gaitpd's.

The cases mirror each non-mesh case of gaitpd's tests/test_hp_search.py at
its sizes (2 folds, test_per_class 3, 3 epochs): a row of the args' values
equal to run_cv_vmapped for the flagship under CAGrad, ``--baseline taca``
and ``--single_mod insole`` (and, beyond gaitpd's cases, async loading); an lr axis and an alpha axis, where the row of
the args' values still equals the plain run and an extreme row trains
otherwise; ``gcl_m_scale``/``gcl_s_scale`` in the loss context equal to the
static settings; ``cagrad_c`` in the method state equal to
``CAGrad(c=...)``; ``make_grid``'s product; FoG's axes, and ``--modality
both`` equal to each modality's own grid; the alpha refusals. Beside them:
``FoldSGD`` instance by instance against ``sgd_torch``, and a padded
instance under it keeping its parameters and momentum bitwise; the CAGrad
solver with c per matrix against one call a matrix, directly and under
``torch.func.vmap`` with a batched c.

Tolerances: gaitpd's atol 1e-6 on each fold's best accuracy; per-epoch
train losses within 1e-6 relative (the same framework and device: the
instance axis only changes how many instances a call stacks); CAGrad's
combine with c in its state within gaitpd's rtol 1e-6 of the static c (on
the CPU both round 1 + c² alike; on the card the tensor c divides where a
Python c multiplies by a reciprocal); the optimizer and the solvers
bitwise. The module runs with one intra-op thread (restored after): its
steps are many small ops, which the parallel test workers' threads would
otherwise oversubscribe.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import gaitpd_torch.train.fbg_fog_driver as TF
import gaitpd_torch.train.vmap_cv as TV
import gaitpd_torch.train.weargait_driver as TD
from gaitpd_torch.learning.mtl import make_method
from gaitpd_torch.ops import cagrad_solver as CS
from gaitpd_torch.train.hp_search import (
    make_grid,
    run_fbg_fog_hp_vmapped,
    run_weargait_hp_vmapped,
)
from gaitpd_torch.train.optim import FoldSGD, sgd_torch
from gaitpd_torch.train.step import StepSettings, branch_loss, make_loss_ctx

LOSS_RTOL = 1e-6
KW = dict(n_folds=2, test_per_class=3, epochs=3, patience=50, synthetic=True, verbose=False,
          seed=0, wm="gcl", alpha=0.5, device="cpu")
FOG_KW = dict(dataset="fog", modality="multimodal", wm="gcl", use_norm_and_cos=True,
              synthetic=True, epochs=3, n_folds_cap=2, verbose=False, seed=0, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _plain(**kw):
    """run_cv_vmapped on ``kw``: its result and per-epoch train losses (F, K)."""
    losses = []
    res = TV.run_cv_vmapped(TD.WearGaitArgs(**kw),
                            on_epoch=lambda ep, tr, ev: losses.append(tr["loss"]))
    return res, losses


def _grid(args, grid, runner=run_weargait_hp_vmapped):
    """The runner on ``grid``: its rows by their hp and each epoch's train
    losses (H·nf, K)."""
    losses = []
    res = runner(args, grid, on_epoch=lambda ep, tr, ev: losses.append(tr["loss"]))
    return res, losses


def _row_losses(losses, row, n_folds):
    return [ep[row * n_folds:(row + 1) * n_folds] for ep in losses]


def _key(hp):
    return tuple(sorted(hp.items()))


def _assert_row_is_plain(res, losses, grid, hp, kw):
    base, base_losses = _plain(**kw)
    rows = {_key(r["hp"]): r for r in res["table"]}
    np.testing.assert_allclose(rows[_key(hp)]["per_fold"], base["per_fold_macro"], atol=1e-6)
    mine = _row_losses(losses, grid.index(hp), res["n_folds"])
    assert len(mine) == len(base_losses)
    for ep, (a, b) in enumerate(zip(mine, base_losses), 1):
        np.testing.assert_allclose(a, b, rtol=LOSS_RTOL, err_msg=f"epoch {ep}")


def test_hp_vmap_defaults_row_matches_run_cv_vmapped():
    args = TD.WearGaitArgs(**KW)
    grid = [{"lr": args.lr, "gcl_m": args.gcl_m, "gcl_s": args.gcl_s}]
    res, losses = _grid(args, grid)
    assert res["grid_size"] == 1 and res["n_folds"] == 2
    _assert_row_is_plain(res, losses, grid, grid[0], KW)


def test_hp_vmap_lr_axis_trains_distinct_instances():
    """Two lrs in one run (FoldSGD): the args' row still reproduces the plain
    run, and a near-zero lr's row scores otherwise."""
    args = TD.WearGaitArgs(**KW)
    grid = [{"lr": args.lr}, {"lr": 1e-8}]
    res, losses = _grid(args, grid)
    _assert_row_is_plain(res, losses, grid, grid[0], KW)
    rows = {r["hp"]["lr"]: r for r in res["table"]}
    assert rows[1e-8]["per_fold"] != rows[args.lr]["per_fold"]


@pytest.mark.parametrize("extra", [{"alpha": 0.0}, {"single_mod": "insole"}],
                         ids=["flagship_mean", "single_mod"])
def test_hp_vmap_async_defaults_row_matches_run_cv_vmapped(extra):
    """Async loading (each fold's pools reseeded every epoch, repeated for
    every row): the args' row of a 2-lr grid reproduces the plain run."""
    kw = {**KW, "async_loading": True, "epochs": 2, **extra}
    args = TD.WearGaitArgs(**kw)
    grid = [{"lr": args.lr}, {"lr": 3e-3}]
    res, losses = _grid(args, grid)
    _assert_row_is_plain(res, losses, grid, grid[0], kw)


def test_gcl_scale_ctx_override_equals_static_setting():
    """branch_loss with gcl_m/gcl_s in the context equals the static
    settings' (the mechanism the GCL axes ride on)."""
    rng = np.random.default_rng(0)
    logits = torch.tensor(rng.normal(size=(16, 3)), dtype=torch.float32)
    labels = torch.tensor(rng.integers(0, 3, size=16))
    valid = torch.ones(16)
    s_static = StepSettings(n_streams=1, wm="gcl", gcl_m=0.35, gcl_s=17.0, noise_mul=1.0)
    s_other = StepSettings(n_streams=1, wm="gcl", gcl_m=0.2, gcl_s=25.0, noise_mul=1.0)
    ctx = {**make_loss_ctx(s_static, [(9, 4, 2)])[0], "drw_w": torch.ones(3)}
    ref = branch_loss(s_static, logits, labels, ctx, torch.Generator().manual_seed(7), valid)
    ovr = branch_loss(s_other, logits, labels,
                      {**ctx, "gcl_m_scale": torch.tensor(0.35), "gcl_s_scale": torch.tensor(17.0)},
                      torch.Generator().manual_seed(7), valid)
    torch.testing.assert_close(ovr, ref, rtol=1e-6, atol=0)


def test_hp_vmap_alpha_axis():
    """CAGrad's strength in the method state: the args' alpha row still
    reproduces the plain run (state c == static c), and alpha 25 trains
    otherwise."""
    args = TD.WearGaitArgs(**KW)
    grid = [{"alpha": args.alpha}, {"alpha": 25.0}]
    res, losses = _grid(args, grid)
    _assert_row_is_plain(res, losses, grid, grid[0], KW)
    strong = _row_losses(losses, 1, res["n_folds"])
    weak = _row_losses(losses, 0, res["n_folds"])
    assert not np.allclose(strong[-1], weak[-1], rtol=1e-4, atol=0)


def test_cagrad_state_resident_c_equals_static():
    """CAGrad.combine with c in its state == CAGrad(c=that value)."""
    rng = np.random.default_rng(3)
    j = torch.tensor(rng.normal(size=(3, 40)), dtype=torch.float32)
    losses = torch.tensor([1.0, 2.0, 0.5])
    gram = j @ j.T
    for name in ("cagrad", "log_cagrad"):
        ga = make_method(name, 3, c=0.7).combine(losses, j, gram, {})[0]
        gb = make_method(name, 3, c=0.123).combine(
            losses, j, gram, {"cagrad_c": torch.tensor(0.7)})[0]
        torch.testing.assert_close(gb, ga, rtol=1e-6, atol=0)


def test_make_grid_product():
    g = make_grid([1e-3, 1e-4], [0.2], [25.0, 30.0])
    assert len(g) == 4
    assert {"lr": 1e-4, "gcl_m": 0.2, "gcl_s": 30.0} in g
    # knobs not supplied are left out (the runner takes the args' values)
    assert make_grid(None, None, None) == [{}]
    assert make_grid(alphas=[0.1, 0.5]) == [{"alpha": 0.1}, {"alpha": 0.5}]


def test_fog_hp_vmap_axes():
    """FBG/FoG: a row of explicit values equal to the driver's matches the
    empty row, and an extreme lr trains otherwise."""
    args = TF.FbgFogArgs(**FOG_KW)
    explicit = {"lr": 1e-3, "alpha": args.alpha}
    res = run_fbg_fog_hp_vmapped(args, [{}, explicit, {"lr": 10.0}])
    rows = {_key(r["hp"]): r for r in res["table"]}
    np.testing.assert_allclose(rows[_key(explicit)]["per_fold"], rows[()]["per_fold"], atol=1e-6)
    assert rows[_key({"lr": 10.0})]["per_fold"] != rows[()]["per_fold"]


def test_fog_hp_defaults_row_matches_run_fbg_fog_vmapped():
    """The empty row's per-epoch losses are run_fbg_fog_vmapped's, and its
    mean best its average accuracy; a gcl_m row trains otherwise."""
    kw = {**FOG_KW, "epochs": 2}
    plain, grid_losses = [], []
    summary = TV.run_fbg_fog_vmapped(TF.FbgFogArgs(**kw), on_epoch=lambda ep, tr, ev:
                                     plain.append(tr["loss"]))
    res = run_fbg_fog_hp_vmapped(TF.FbgFogArgs(**kw), [{}, {"gcl_m": 0.4}],
                                 on_epoch=lambda ep, tr, ev: grid_losses.append(tr["loss"]))
    nf = res["n_folds"]
    empty = next(r for r in res["table"] if r["hp"] == {})
    assert abs(empty["acc_mean"] - summary["multimodal"]["avg"]) <= 1e-4
    for ep, (a, b) in enumerate(zip(_row_losses(grid_losses, 0, nf), plain), 1):
        np.testing.assert_allclose(a, b, rtol=LOSS_RTOL, err_msg=f"epoch {ep}")
    assert not np.allclose(_row_losses(grid_losses, 1, nf)[0], plain[0], rtol=1e-4, atol=0)


def test_hp_vmap_baseline_defaults_row_matches_run_cv_vmapped():
    """--baseline taca: the args' row reproduces the plain vmapped baseline
    run (its adapters, its dropout from each instance's generator, no
    method), and a near-zero lr's row scores otherwise."""
    kw = {**KW, "baseline": "taca"}
    args = TD.WearGaitArgs(**kw)
    grid = [{"lr": args.lr}, {"lr": 1e-9}]
    res, losses = _grid(args, grid)
    _assert_row_is_plain(res, losses, grid, grid[0], kw)
    rows = {r["hp"]["lr"]: r for r in res["table"]}
    assert rows[1e-9]["per_fold"] != rows[args.lr]["per_fold"]


def test_hp_vmap_single_mod_defaults_row_matches_run_cv_vmapped():
    """--single_mod insole: the args' row reproduces the vmapped
    single-modality run (a fresh FoldSGD every epoch keeps each instance's
    lr); a near-zero lr's row scores otherwise; an alpha axis raises."""
    kw = {**KW, "single_mod": "insole"}
    args = TD.WearGaitArgs(**kw)
    grid = [{"lr": args.lr}, {"lr": 1e-9}]
    res, losses = _grid(args, grid)
    _assert_row_is_plain(res, losses, grid, grid[0], kw)
    rows = {r["hp"]["lr"]: r for r in res["table"]}
    assert rows[1e-9]["per_fold"] != rows[args.lr]["per_fold"]
    with pytest.raises(ValueError, match="alpha"):
        run_weargait_hp_vmapped(args, [{"alpha": 0.5}])


def test_fog_hp_vmap_modality_both_runs_per_modality_grids():
    """--modality both: one ranked grid a concrete modality, each equal to
    that modality's grid run directly."""
    kw = dict(dataset="fog", wm="ce", synthetic=True, epochs=2, n_folds_cap=2, verbose=False,
              seed=0, device="cpu")
    grid = [{"lr": 1e-3}, {"lr": 3e-3}]
    reader = TF.get_reader(TF.FbgFogArgs(**kw))
    res = run_fbg_fog_hp_vmapped(TF.FbgFogArgs(modality="both", **kw), grid, reader=reader)
    assert set(res) == {"skeleton", "sensor"}
    direct = run_fbg_fog_hp_vmapped(TF.FbgFogArgs(modality="sensor", **kw), grid, reader=reader)
    direct_rows = {_key(r["hp"]): r for r in direct["table"]}
    for r in res["sensor"]["table"]:
        np.testing.assert_allclose(r["per_fold"], direct_rows[_key(r["hp"])]["per_fold"],
                                   atol=1e-6)


@pytest.mark.parametrize("kw,grid", [
    ({"alpha": 0.0}, [{"alpha": 0.5}]),  # CAGrad off: the axis would be ignored
    ({"mtl_method": "famo"}, [{"alpha": 0.5}]),  # a method without a strength
    ({}, [{"alpha": 0.5}, {"alpha": 0.0}]),  # c <= 0
    ({"baseline": "early_fusion"}, [{"alpha": 0.5}]),  # no method for a baseline
], ids=["alpha_off", "famo", "nonpositive", "baseline"])
def test_hp_vmap_rejects_ignored_alpha_axis(monkeypatch, kw, grid):
    """An alpha axis that would do nothing, or a strength <= 0, raises
    before any step."""
    def no_steps(*a, **k):
        raise AssertionError("an epoch started before the grid was refused")

    monkeypatch.setattr(TV, "run_train_epoch", no_steps)
    with pytest.raises(ValueError, match="alpha"):
        run_weargait_hp_vmapped(TD.WearGaitArgs(**{**KW, **kw}), grid)


def test_mesh_raises_naming_its_item():
    """Once refused (ROADMAP Queue 1, item 14), a mesh now shards the grid's
    instances: over a mesh of this process alone, both grids' tables equal
    those without one (over 2 and 4 ranks: gaitpd_torch.entry's dry run)."""
    from test_torch_mesh import one_rank_mesh

    grid = [{}, {"lr": 3e-3}]
    for run, args in ((run_weargait_hp_vmapped, TD.WearGaitArgs(**{**KW, "epochs": 1})),
                      (run_fbg_fog_hp_vmapped, TF.FbgFogArgs(**{**FOG_KW, "epochs": 1}))):
        with one_rank_mesh() as mesh:
            got = run(dataclasses.replace(args, mesh=mesh), grid)
        assert got == run(args, grid)


def test_fold_sgd_matches_sgd_torch_per_instance():
    """FoldSGD over stacked leaves: each instance's parameters and momentum
    bitwise those of its own sgd_torch at its lr, step after step."""
    torch.manual_seed(0)
    lrs = [1e-3, 3e-3, 1e-8, 10.0]
    f = len(lrs)
    shapes = [(16, 12, 3), (7,), (33, 5), (1000,)]
    p0 = [torch.randn((f,) + s) for s in shapes]
    grads = [[torch.randn((f,) + s) for s in shapes] for _ in range(3)]
    leaves = [p.clone().requires_grad_() for p in p0]
    opt = FoldSGD(leaves, lr=torch.tensor(lrs), momentum=0.9, weight_decay=1e-4)
    for gs in grads:
        for p, g in zip(leaves, gs):
            p.grad = g.clone()
        opt.step()
    for i, lr in enumerate(lrs):
        own = [p[i].clone().requires_grad_() for p in p0]
        ref = sgd_torch(own, lr=lr)
        for gs in grads:
            for p, g in zip(own, gs):
                p.grad = g[i].clone()
            ref.step()
        for p, q in zip(leaves, own):
            assert torch.equal(p.detach()[i], q.detach()), (lr, tuple(q.shape))
            assert torch.equal(opt.state[p]["momentum_buffer"][i],
                               ref.state[q]["momentum_buffer"]), (lr, tuple(q.shape))


def test_fold_sgd_padded_instance_keeps_its_state_bitwise():
    """A stacked step under FoldSGD where instance 2's batch is all padding:
    its parameters and momentum keep their bits; instance 1's are those of
    the same step of instance 1 alone at its lr."""
    args = TD.WearGaitArgs(**{**KW, "alpha": 0.0})
    splits = TV._folds_and_splits(args)
    datas = [TD.split_to_device(s, False, args.seed, "cpu") for s in splits]
    data = TV.stack_folds(datas, "cpu")
    settings = StepSettings(n_streams=3, wm="gcl", synchronized=True,
                            private_grads="sum_plus_own")
    ctxs = [make_loss_ctx(settings, [np.bincount(d.ys[k].numpy()[d.train_pool[:, k]],
                                                 minlength=2) for k in range(3)])
            for d in datas]
    lrs = [3e-3, 1e-3]

    def state_and_runner(n):
        make_opt = functools.partial(FoldSGD, lr=torch.tensor(lrs[:n]))
        state, _ = TV.init_stacked_state(TD.build_model(args, True), make_opt, None, n, "cpu")
        return state, TV.VmapEpochRunner(settings)

    idx, valid = TV.stack_index_batches([d.train_pool for d in datas],
                                        [np.arange(len(d.train_pool)) for d in datas], 64)
    idx, valid = torch.from_numpy(idx), torch.from_numpy(valid)
    state, runner = state_and_runner(2)
    alone, runner1 = state_and_runner(1)
    xs1, ys1 = tuple(x[:1] for x in data.xs), tuple(y[:1] for y in data.ys)
    for step, pad in enumerate((False, True)):  # a real step first: momentum exists
        v = valid[:, step].clone()
        if pad:
            v[1] = 0.0
        before = {n: (p.detach().clone(), state.optimizer.state[p]["momentum_buffer"].clone()
                      if p in state.optimizer.state else None)
                  for n, p in state.params.items()}
        batch = TV._gather(data.xs, data.ys, idx[:, step], v, (0, 1, 2))
        state, metrics = runner.train_step(state, batch, TV.stack_ctx(ctxs), pad)
        batch1 = TV._gather(xs1, ys1, idx[:1, step], v[:1], (0, 1, 2))
        alone, _ = runner1.train_step(alone, batch1, TV.stack_ctx(ctxs[:1]), False)
    assert metrics["n"][1] == 0
    for name, p in state.params.items():
        old_p, old_buf = before[name]
        buf = state.optimizer.state[p]["momentum_buffer"]
        assert torch.equal(p.detach()[1], old_p[1]) and torch.equal(buf[1], old_buf[1]), name
        assert not torch.equal(p.detach()[0], old_p[0]), name
        q = alone.params[name]
        torch.testing.assert_close(p.detach()[0], q.detach()[0], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("k", [2, 3])
def test_cagrad_solver_per_matrix_c(k):
    """The solver with c per matrix: each matrix's w the bits of a call of
    its own with that c, directly and under vmap with a batched c (and a
    batched c over one matrix); a c of the wrong shape raises."""
    rng = np.random.default_rng(11 + k)
    j = torch.tensor(rng.normal(size=(3, k, 20)), dtype=torch.float32)
    grams = j @ j.transpose(1, 2)
    cvals = [0.1, 0.5, 25.0]
    c = torch.tensor(cvals)
    own = torch.stack([CS.cagrad_solve(g, cv) for g, cv in zip(grams, cvals)])
    assert torch.equal(CS.cagrad_solve(grams, c), own)
    assert torch.equal(torch.func.vmap(CS.cagrad_solve)(grams, c), own)
    # a batched c over one matrix: the batched call's bits (held to the
    # single calls above) on that matrix repeated
    first = CS.cagrad_solve(grams[0].expand(len(cvals), k, k), c)
    assert torch.equal(torch.func.vmap(lambda cv: CS.cagrad_solve(grams[0], cv))(c), first)
    assert torch.equal(first[0], own[0])
    coef = CS.cagrad_c_coef(grams, c)
    assert torch.equal(coef, torch.stack([CS.cagrad_c_coef(g, cv)
                                          for g, cv in zip(grams, cvals)]))
    with pytest.raises(ValueError, match="one value a matrix"):
        CS.cagrad_solve(grams, c[:2])
