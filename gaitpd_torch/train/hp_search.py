"""A hyperparameter grid as one stacked run: every (grid row, fold) instance
of a configuration trains in the same step. Port of gaitpd/train/
hp_search.py (the reference retunes lr and the GCL margins by hand and
relaunches: train/configs.py:13-31, run_all.sh:9-26).

    grid = make_grid([1e-3, 3e-3], alphas=[0.5, 1.0])
    res = run_weargait_hp_vmapped(WearGaitArgs(synthetic=True, epochs=3), grid)  # on the card
    res = run_weargait_hp_vmapped(WearGaitArgs(synthetic=True, baseline="taca",
                                               device="cpu"), make_grid([1e-3, 1e-2]))
    res = run_fbg_fog_hp_vmapped(FbgFogArgs(dataset="fog", synthetic=True, epochs=2,
                                            device="cpu"), [{}, {"lr": 1e-2}])

The stacked runner of gaitpd_torch/train/vmap_cv.py trains them: instance
i = (row h, fold f), h-major, fold-minor, trains fold f's data under
grid[h]. The folds are stacked on the device once and repeated there H
times (no host copy an instance). Each knob is an operand on the instance
axis:
- lr: one ``torch.optim.SGD`` where every row has the same lr, so a row of
  the args' values runs ``run_cv_vmapped``'s own optimizer; else
  ``FoldSGD`` with an lr an instance (gaitpd_torch/train/optim.py);
- gcl_m, gcl_s: ``gcl_m_scale`` and ``gcl_s_scale`` in each instance's
  loss context (gaitpd_torch/train/step.py::branch_loss);
- alpha, CAGrad's strength: ``cagrad_c`` in each instance's method state,
  set for every row when any row sweeps it (gaitpd_torch/learning/mtl.py::
  CAGrad), which the solver kernel reads one value a matrix, one launch
  for all instances.
Each instance keeps its fold's random streams in the sequential driver
(numpy seed + 1000 fi, ``torch.Generator(seed + fi)``), the same in every
row, and a stopped instance's best is frozen, as in ``run_cv_vmapped``; so
a row of the args' values reproduces ``run_cv_vmapped`` (tests/
test_torch_hp_search.py). Each runner returns gaitpd's grid ranked by the
mean over the folds of each instance's best, ``{"table", "n_folds",
"grid_size"}``, and prints it.

With ``fused`` the flagship's instances run the fused forward
(gaitpd_torch/models/fused.py), as run_cv_vmapped's folds do.
With a mesh (``args.mesh``, gaitpd_torch/runtime/mesh.py) the instance axis
shards over its ranks as run_cv_vmapped's folds do: each rank trains its
contiguous block of instances, with no collective in a step, and the bests
are gathered in instance order; an instance count the mesh does not divide
is printed and every rank runs them all.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from gaitpd_torch.config import FBG_FOG_DIMS, FBG_FOG_TRAIN, normalize_dataset_name
from gaitpd_torch.data import weargait as WG
from gaitpd_torch.data.fbg_fog import build_fusion_fold
from gaitpd_torch.learning.mtl import make_method
from gaitpd_torch.runtime.device import resolve_device
from gaitpd_torch.runtime.mesh import FoldShard, shard_folds
from gaitpd_torch.train import vmap_cv as VC
from gaitpd_torch.train.cv import fbg_label_dict, fog_label_dict, generate_class_stratified_folds
from gaitpd_torch.train.fbg_fog_driver import (
    MODALITY_MODES,
    FbgFogArgs,
    augment_config,
    choose_model,
    fold_to_device,
)
from gaitpd_torch.train.fbg_fog_driver import check_supported as check_fbg_fog_supported
from gaitpd_torch.train.fbg_fog_driver import get_reader as get_fbg_fog_reader
from gaitpd_torch.train.loop import DeviceFoldData, EarlyStopper
from gaitpd_torch.train.optim import FoldSGD, sgd_torch
from gaitpd_torch.train.step import StepSettings, make_loss_ctx
from gaitpd_torch.train.weargait_driver import (
    DROPOUT_BASELINES,
    MODALITIES,
    WearGaitArgs,
    baseline_adapters,
    build_model,
    split_to_device,
    weargait_aug_config,
)

Grid = List[Dict[str, float]]


def make_grid(
    lrs: Optional[Sequence[float]] = None,
    gcl_ms: Optional[Sequence[float]] = None,
    gcl_ss: Optional[Sequence[float]] = None,
    alphas: Optional[Sequence[float]] = None,
) -> Grid:
    """Cartesian product of the supplied per-knob value lists; knobs whose
    list is None or empty are left out of the entries (the runners take
    the args' values). ``alphas`` sweeps CAGrad's strength c."""
    axes = {"lr": lrs, "gcl_m": gcl_ms, "gcl_s": gcl_ss, "alpha": alphas}
    axes = {k: v for k, v in axes.items() if v}
    if not axes:
        return [{}]
    names = list(axes)
    return [dict(zip(names, vals)) for vals in itertools.product(*axes.values())]


def _check_alpha_axis(args, mtl, grid: Grid) -> bool:
    """Whether the grid sweeps CAGrad's strength; refuses an alpha axis that
    would be ignored (alpha rides only in CAGrad's state) and strengths <= 0
    (c <= 0 is a degenerate CAGrad, not CAGrad off)."""
    wants = any("alpha" in hp for hp in grid)
    ok = mtl is not None and args.mtl_method in ("cagrad", "log_cagrad")
    if wants and not ok:
        raise ValueError("an 'alpha' HP axis needs CAGrad enabled "
                         "(--alpha > 0 and --mtl_method cagrad|log_cagrad)")
    bad = [hp["alpha"] for hp in grid if "alpha" in hp and hp["alpha"] <= 0]
    if bad:
        raise ValueError(f"alpha HP values must be > 0 (got {bad}); use --alpha 0 "
                         "without an alpha axis to disable CAGrad")
    return wants and ok


def _per_instance(grid: Grid, key: str, default: float, n_folds: int, device,
                  shard: Optional[FoldShard] = None) -> torch.Tensor:
    """Each instance's value of ``key`` (its row's, else ``default``), h-major:
    (H·nf,) f32 on ``device``, or ``shard``'s block of them."""
    values = np.repeat([hp.get(key, default) for hp in grid], n_folds)
    if shard is not None:
        values = shard.take(values)
    return torch.tensor(values, dtype=torch.float32, device=device)


def _slice_tree(tree, shard: FoldShard):
    """Every tensor of a stacked tree cut to ``shard``'s block of instances."""
    if isinstance(tree, dict):
        return {k: _slice_tree(v, shard) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_slice_tree(v, shard) for v in tree)
    return tree[shard.start:shard.stop]


def _local(stacked: VC.StackedFoldData, shard: FoldShard) -> VC.StackedFoldData:
    """The stacked instances of ``shard``'s block."""
    return VC.StackedFoldData(
        xs=_slice_tree(stacked.xs, shard), ys=_slice_tree(stacked.ys, shard),
        eval_xs=_slice_tree(stacked.eval_xs, shard), eval_ys=_slice_tree(stacked.eval_ys, shard),
        train_pools=shard.take(stacked.train_pools), eval_pools=shard.take(stacked.eval_pools))


def _repeat_folds(stacked: VC.StackedFoldData, h: int) -> VC.StackedFoldData:
    """The stacked folds repeated ``h`` times on their device: instance
    h·nf + f holds fold f."""

    def rep(ts):
        return tuple(t.repeat((h,) + (1,) * (t.dim() - 1)) for t in ts)

    return VC.StackedFoldData(xs=rep(stacked.xs), ys=rep(stacked.ys), eval_xs=rep(stacked.eval_xs),
                              eval_ys=rep(stacked.eval_ys), train_pools=stacked.train_pools * h,
                              eval_pools=stacked.eval_pools * h)


def _grid_ctx(fold_ctxs, grid: Grid, gcl_m: float, gcl_s: float, device):
    """The folds' loss contexts for every row, each stream's with the row's
    ``gcl_m_scale`` and ``gcl_s_scale``, stacked h-major."""
    ctxs = []
    for hp in grid:
        scales = {"gcl_m_scale": torch.tensor(hp.get("gcl_m", gcl_m), dtype=torch.float32,
                                              device=device),
                  "gcl_s_scale": torch.tensor(hp.get("gcl_s", gcl_s), dtype=torch.float32,
                                              device=device)}
        ctxs.extend(tuple({**stream, **scales} for stream in c) for c in fold_ctxs)
    return VC.stack_ctx(ctxs)


def _grid_optimizer(grid: Grid, lr: float, n_folds: int, momentum: float, weight_decay: float,
                    device, shard: Optional[FoldShard] = None) -> Callable:
    """``make_optimizer`` of the stacked leaves: ``sgd_torch`` where every row
    trains at one lr, else ``FoldSGD`` at each instance's."""
    lrs = {hp.get("lr", lr) for hp in grid}
    if len(lrs) == 1:
        return functools.partial(sgd_torch, lr=lrs.pop(), momentum=momentum,
                                 weight_decay=weight_decay)
    return functools.partial(FoldSGD, lr=_per_instance(grid, "lr", lr, n_folds, device, shard),
                             momentum=momentum, weight_decay=weight_decay)


def _train_grid(runner: VC.VmapEpochRunner, state: VC.StackedState, stacked: VC.StackedFoldData,
                ctx, heads, grid: Grid, n_folds: int, shard: FoldShard, *, epochs: int,
                patience: int, seed: int, batch_size: int, score: Callable,
                pools: Optional[Callable] = None,
                fresh_optimizer: Optional[Callable] = None,
                on_epoch: Optional[VC.VmapEpochHook] = None, verbose: bool = False,
                label: str = "") -> np.ndarray:
    """The epochs of every instance (run_cv_vmapped's loop, without
    checkpoints or the masked table): ``score(ev)`` -> each instance's
    selection metric; ``pools(ep)`` -> each instance's train pools (default:
    the stacked ones); ``fresh_optimizer(leaves)`` replaces the optimizer at
    each epoch's start. ``stacked``, ``ctx`` and the state hold ``shard``'s
    block of the instances. Returns each instance's best, (H, nf)."""
    h = len(grid)
    device = stacked.xs[0].device
    rngs, gens = VC._instance_streams(
        shard.take([(seed, fi) for _ in grid for fi in range(1, n_folds + 1)]), device)
    stoppers = [EarlyStopper(patience=patience) for _ in range(shard.stop - shard.start)]
    eval_idx, eval_valid, eval_counts = VC._eval_indices(stacked, batch_size)
    mask = (True,) * len(heads)
    for ep in range(1, epochs + 1):
        state.epoch = ep - 1
        if fresh_optimizer is not None:
            state.optimizer = fresh_optimizer(list(state.params.values()))
        train_pools = stacked.train_pools if pools is None else shard.take(pools(ep))
        idx, valid = VC.stack_index_batches(
            train_pools, [r.permutation(len(p)) for r, p in zip(rngs, train_pools)], batch_size)
        live = [not st.stop for st in stoppers]  # a stopped instance draws no more
        state, tr = VC.run_train_epoch(runner, state, stacked, idx, valid, ctx, heads, gens, live)
        ev = VC.run_eval_epoch(runner, state, state.params, stacked, eval_idx, eval_valid, ctx,
                               heads, state.epoch, mask, gens,
                               [n if on else 0 for n, on in zip(eval_counts, live)])
        for st, v in zip(stoppers, score(ev)):
            if not st.stop:  # a stopped instance's best is frozen
                st.update(float(v))
        if on_epoch is not None:
            on_epoch(ep, tr, ev)
        if verbose:
            best = np.asarray([s.best for s in stoppers])
            if shard.mesh is None:
                print(f"[hp-vmap] Ep {ep:03d} | {label}per-HP mean best = "
                      f"{np.array2string(best.reshape(h, n_folds).mean(axis=1), precision=1)}")
            else:
                print(f"[hp-vmap] Ep {ep:03d} | {label}instances {shard.start}-{shard.stop - 1} "
                      f"best = {np.array2string(best, precision=1)}")
        if all(st.stop for st in stoppers):
            print(f"[hp-vmap] all instances early-stopped at epoch {ep}")
            break
    return np.asarray(shard.gather([s.best for s in stoppers])).reshape(h, n_folds)


def _ranked(grid: Grid, best: np.ndarray, metric: str, title: str) -> dict:
    """gaitpd's ranked table of the rows by their mean best over the folds,
    printed: the ranked grid is the command's product."""
    table = [{"hp": grid[i], f"{metric}_mean": float(best[i].mean()),
              f"{metric}_std": float(best[i].std()), "per_fold": [float(x) for x in best[i]]}
             for i in range(len(grid))]
    table.sort(key=lambda r: -r[f"{metric}_mean"])
    print(f"\n=== {title} ===")
    for r in table:
        print(f"{r['hp']}  ->  {r[f'{metric}_mean']:.2f}% ± {r[f'{metric}_std']:.2f}%")
    return {"table": table, "n_folds": best.shape[1], "grid_size": len(grid)}


def run_weargait_hp_vmapped(args: WearGaitArgs, grid: Grid,
                            on_epoch: Optional[VC.VmapEpochHook] = None) -> dict:
    """Every (row, fold) instance of a WearGait configuration in one stacked
    run (gaitpd/train/hp_search.py:101-302): the flagship (under CAGrad, or
    any MTL method without an alpha axis), every ``baseline`` (SGD on the
    mean of its branch losses, no method, as run_cv_vmapped) and
    ``single_mod``; ranked by the mean best macro accuracy. Rows may set any
    of lr, gcl_m, gcl_s, alpha (the args' values otherwise)."""
    device = resolve_device(args.device)  # raise before any work
    if args.single_mod is not None:
        return _weargait_single_mod_hp_vmapped(args, grid, on_epoch)
    async_mode = args.async_loading
    sync_flag = not async_mode
    splits = VC._folds_and_splits(args)
    nf, h = len(splits), len(grid)
    shard = shard_folds(h * nf, args.mesh, "[hp-vmap]", "instances")
    datas = [split_to_device(s, async_mode, args.seed, "cpu") for s in splits]
    stacked = _local(_repeat_folds(VC.stack_folds(datas, device), h), shard)

    aug_specs, aug_params = weargait_aug_config(args)
    settings = StepSettings(
        n_streams=3, wm=args.wm, synchronized=sync_flag, gcl_m=args.gcl_m, gcl_s=args.gcl_s,
        noise_mul=args.noise_mul, drw_warmup=args.drw_warmup, consistency_lambda=0.0,
        private_grads="sum_plus_own", dropout=args.baseline in DROPOUT_BASELINES,
        modality_dropout=args.modality_dropout, augment=aug_specs,
    )
    fold_ctxs = [make_loss_ctx(settings, [np.bincount(s.train[m].y[d.train_pool[:, k]],
                                                      minlength=args.num_classes)
                                          for k, m in enumerate(MODALITIES)],
                               device=device, aug_params=aug_params)
                 for s, d in zip(splits, datas)]
    ctx = _slice_tree(_grid_ctx(fold_ctxs, grid, args.gcl_m, args.gcl_s, device), shard)

    # the method for the flagship only, as run_cv_vmapped
    mtl = None
    if args.baseline is None and args.alpha > 0:
        kwargs = {"c": args.alpha} if args.mtl_method in ("cagrad", "log_cagrad") else {}
        mtl = make_method(args.mtl_method, 3, **kwargs)
    sweep_alpha = _check_alpha_axis(args, mtl, grid)
    make_optimizer = _grid_optimizer(grid, args.lr, nf, 0.9, 1e-4, device, shard)
    state, partition = VC.init_stacked_state(build_model(args, sync_flag), make_optimizer, mtl,
                                             shard.stop - shard.start, device)
    if sweep_alpha:
        state.mtl_state["cagrad_c"] = _per_instance(grid, "alpha", args.alpha, nf, device,
                                                    shard)
    runner = VC.VmapEpochRunner(settings, mtl, partition, *baseline_adapters(args))

    def pools(ep):  # each fold's pools reseeded every epoch, as run_fold
        return [WG.async_pool(s.train, np.random.default_rng(args.seed + ep))
                for s in splits] * h

    best = _train_grid(
        runner, state, stacked, ctx, (0, 1, 2), grid, nf, shard, epochs=args.epochs,
        patience=args.patience, seed=args.seed, batch_size=args.batch_size,
        score=lambda ev: ev["acc_batchmean"].mean(axis=1) if async_mode else ev["ens_acc"],
        pools=pools if async_mode else None, on_epoch=on_epoch, verbose=args.verbose)
    return _ranked(grid, best, "macro", "HP grid ranked by mean CV macro")


def _weargait_single_mod_hp_vmapped(args: WearGaitArgs, grid: Grid,
                                    on_epoch: Optional[VC.VmapEpochHook] = None) -> dict:
    """The grid over WearGait's single-modality mode (gaitpd/train/
    hp_search.py:305-480): the chosen stream through the shared backbone and
    its head, a fresh SGD every epoch that keeps each instance's lr, pooled
    eval accuracy. Knobs lr, gcl_m, gcl_s; an alpha axis raises (the mode
    has no method)."""
    _check_alpha_axis(args, None, grid)
    device = resolve_device(args.device)
    async_mode = args.async_loading
    k = MODALITIES.index(args.single_mod)
    splits = VC._folds_and_splits(args)
    nf, h = len(splits), len(grid)
    datas = []
    for s in splits:
        d = split_to_device(s, async_mode, args.seed, "cpu")
        datas.append(DeviceFoldData(
            xs=d.xs[k:k + 1], ys=d.ys[k:k + 1], train_pool=d.train_pool[:, k:k + 1],
            eval_pool=d.eval_pool[:, k:k + 1], eval_xs=d.eval_xs[k:k + 1],
            eval_ys=d.eval_ys[k:k + 1]))
    shard = shard_folds(h * nf, args.mesh, "[hp-vmap]", "instances")
    stacked = _local(_repeat_folds(VC.stack_folds(datas, device), h), shard)
    aug_specs, aug_params = weargait_aug_config(args, n_streams=1)
    settings = StepSettings(n_streams=1, wm=args.wm, synchronized=False, gcl_m=args.gcl_m,
                            gcl_s=args.gcl_s, noise_mul=args.noise_mul,
                            drw_warmup=args.drw_warmup, augment=aug_specs)
    fold_ctxs = [make_loss_ctx(settings, [np.bincount(
        s.train[args.single_mod].y[d.train_pool[:, 0]], minlength=args.num_classes)],
        device=device, aug_params=aug_params) for s, d in zip(splits, datas)]
    ctx = _slice_tree(_grid_ctx(fold_ctxs, grid, args.gcl_m, args.gcl_s, device), shard)
    make_optimizer = _grid_optimizer(grid, args.lr, nf, 0.9, 1e-4, device, shard)
    state, _ = VC.init_stacked_state(build_model(args, not async_mode), make_optimizer, None,
                                     shard.stop - shard.start, device)

    def pools(ep):
        return [WG.async_pool(s.train, np.random.default_rng(args.seed + ep))[:, k:k + 1]
                for s in splits] * h

    # the reference builds a fresh SGD every epoch (weargait_train.py:273-276)
    best = _train_grid(
        VC.VmapEpochRunner(settings), state, stacked, ctx, (0,), grid, nf, shard,
        epochs=args.epochs,
        patience=args.patience, seed=args.seed, batch_size=args.batch_size,
        score=lambda ev: ev["acc"][:, 0], pools=pools if async_mode else None,
        fresh_optimizer=make_optimizer, on_epoch=on_epoch, verbose=args.verbose,
        label=f"{args.single_mod} ")
    return _ranked(grid, best, "macro", f"HP grid ranked by mean CV {args.single_mod} accuracy")


def run_fbg_fog_hp_vmapped(args: FbgFogArgs, grid: Grid,
                           on_epoch: Optional[VC.VmapEpochHook] = None, reader=None) -> dict:
    """The FBG/FoG driver's grid (gaitpd/train/hp_search.py:483-688): every
    (row, fold) instance of one modality in one stacked run, ranked by each
    instance's best selection metric (the ensemble's accuracy when
    synchronized multimodal, the mean branch accuracy otherwise). Knobs lr
    (else the dataset's), gcl_m, gcl_s, alpha (CAGrad, multimodal only).
    ``all`` and ``both`` run each concrete modality's grid in turn and
    return {modality: result}. ``reader``: as fbg_fog_driver.main's."""
    check_fbg_fog_supported(args)
    device = resolve_device(args.device)  # raise before any work
    if args.modality in ("all", "both"):
        # the modes are different architectures: a grid each, as the driver
        # loops over them
        out = {}
        for mod in MODALITY_MODES[args.modality]:
            print(f"\n>>> HP-vmap MODE: {mod.upper()} <<<")
            out[mod] = run_fbg_fog_hp_vmapped(dataclasses.replace(args, modality=mod), grid,
                                              on_epoch, reader)
        return out

    dataset = normalize_dataset_name(args.dataset)
    dims, tp = FBG_FOG_DIMS[dataset], FBG_FOG_TRAIN[dataset]
    epochs = args.epochs or tp.epochs
    batch_size = args.batch_size or tp.batch_size
    multimodal = args.modality == "multimodal"
    n_streams = 2 if multimodal else 1
    heads = tuple(range(n_streams))
    reader = get_fbg_fog_reader(args) if reader is None else reader
    label_dict = fbg_label_dict(reader) if dataset == "fbg" else fog_label_dict(reader)
    folds = generate_class_stratified_folds(label_dict, np.random.default_rng(args.seed))
    if args.n_folds_cap:
        folds = folds[: args.n_folds_cap]
    nf, h = len(folds), len(grid)
    datas = [fold_to_device(build_fusion_fold(
        dataset, reader, tr, ev, synchronized=args.synchronized_loading, seed=args.seed,
        pad_skel=dims.pose_length, pad_sens=dims.sensor_length, modality=args.modality),
        args.modality, "cpu") for tr, ev in folds]
    shard = shard_folds(h * nf, args.mesh, "[hp-vmap]", "instances")
    stacked = _local(_repeat_folds(VC.stack_folds(datas, device), h), shard)
    aug_specs, aug_params = augment_config(args, dims.skeleton_input_dim, args.modality)
    settings = StepSettings(
        n_streams=n_streams, wm=args.wm, synchronized=args.synchronized_loading,
        ldam_s=args.ldam_s, gcl_m=args.gcl_m, gcl_s=args.gcl_s, noise_mul=args.noise_mul,
        drw_warmup=args.drw_warmup,
        consistency_lambda=args.consistency_lambda if multimodal else 0.0,
        private_grads="sum", augment=aug_specs)
    fold_ctxs = [make_loss_ctx(settings, VC._class_counts(d, heads, dims.num_classes),
                               device=device, aug_params=aug_params, ldam_max_m=args.ldam_m)
                 for d in datas]
    ctx = _slice_tree(_grid_ctx(fold_ctxs, grid, args.gcl_m, args.gcl_s, device), shard)
    mtl = None
    if multimodal and args.alpha > 0:
        kwargs = ({"c": args.alpha, "max_norm": args.max_norm}
                  if args.mtl_method in ("cagrad", "log_cagrad") else {})
        mtl = make_method(args.mtl_method, n_streams, **kwargs)
    sweep_alpha = _check_alpha_axis(args, mtl, grid)
    make_optimizer = _grid_optimizer(grid, tp.learning_rate, nf, tp.momentum, tp.weight_decay,
                                     device, shard)
    state, partition = VC.init_stacked_state(choose_model(args, dims), make_optimizer, mtl,
                                             shard.stop - shard.start, device)
    if sweep_alpha:
        state.mtl_state["cagrad_c"] = _per_instance(grid, "alpha", args.alpha, nf, device,
                                                    shard)

    def score(ev):
        if multimodal and args.synchronized_loading:
            return ev["ens_acc"]
        return ev["acc"].mean(axis=1) if multimodal else ev["acc"][:, 0]

    best = _train_grid(VC.VmapEpochRunner(settings, mtl, partition), state, stacked, ctx, heads,
                       grid, nf, shard, epochs=epochs, patience=tp.patience, seed=args.seed,
                       batch_size=batch_size, score=score, on_epoch=on_epoch,
                       verbose=args.verbose)
    return _ranked(grid, best, "acc", "HP grid ranked by mean CV accuracy")
