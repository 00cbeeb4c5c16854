"""Cross-validation with every fold in one step: WearGait's flagship under
any of the 17 MTL methods (CAGrad by default, or the mean of the branch
losses at alpha 0), its seven baselines and its single-modality mode, with
every draw of the recipe; the FBG/FoG driver's folds of each mode; and the
FBG/FoG baselines' seed sweeps, every (seed, fold) instance of one
configuration in one step. Port of gaitpd/train/vmap_cv.py (reference
train/weargait_train.py:533-645 and fbg_fog_train.py:410-436, sequential
fold loops; run_all.sh's seed axis).

    res = run_cv_vmapped(WearGaitArgs(synthetic=True, epochs=3))  # on the card
    res = run_cv_vmapped(WearGaitArgs(synthetic=True, mtl_method="nashmtl", device="cpu"))
    res = run_cv_vmapped(WearGaitArgs(synthetic=True, baseline="taca", device="cpu"))
    res = run_cv_vmapped(WearGaitArgs(synthetic=True, single_mod="imu", device="cpu"))
    res = run_fbg_fog_vmapped(FbgFogArgs(dataset="fog", synthetic=True, epochs=3))
    res = run_baseline_seeds_vmapped("fog", "focal", "", [0, 1], synthetic=True,
                                     epochs=2, device="cpu")

The folds' models are small and independent, and the card waits on the host
in a step of one fold (PERF.md §5), so the fold becomes a leading axis of
every parameter and batch: a step trains F folds at once. The model code
stays as it is: one fold's forward and loss go through ``torch.func.vmap``
over ``torch.func.functional_call``, autograd runs outside the vmap on the
stacked parameters, and the kernels' vmap rules make each forward one launch
for all folds (gaitpd_torch/ops/stream_block.py, ops/cheap_xattn.py), each
backward one launch a task pass. The K task passes give the per-task
matrix J (F, K, P); the method's ``combine_flat`` (gaitpd_torch/learning/
mtl.py) runs under ``torch.func.vmap`` over J, the losses (F, K), the
stacked method state and the folds' generators, so its Gram matrices
(F, K, K) go to its solver in one launch (gaitpd_torch/ops/solver_folds.py)
and its clip and ``sum_plus_own`` act per fold. SGD's updates are
elementwise, so one optimizer over the stacked parameters updates each
fold as its own would; the baselines' Adam and AdamW keep a state and a
step count a fold (gaitpd_torch/train/optim.py::FoldAdam).

Folds differ in size: their windows are zero-padded to the largest fold's
count, and each fold's index pools stay its own, so a padded row is never
gathered. Batch counts are padded to the largest fold's with batches that
are all padding; in such a batch a fold keeps its parameters, optimizer
state and method state bitwise, through a per-fold mask on the device (the
sequential step skips the batch on the host). A step makes no host
synchronisation.

Each fold keeps the sequential driver's random streams
(gaitpd_torch/train/weargait_driver.py::run_fold, fbg_fog_driver.py::
train_one_fold, baseline_drivers.py::train_fold): its numpy generator
(seed + 1000 fi) orders its epochs, async mode reseeds its pools each epoch,
and its ``torch.Generator(seed + fi)`` takes the step's draws (augmentation,
modality dropout, the baselines' dropout, the GCL noise, then RLW's,
PCGrad's or GradDrop's draw) through
gaitpd_torch/runtime/fold_draws.py, one draw a fold at that fold's shape.
A fold draws where its sequential run would: in a train batch that is not
all padding, in an eval batch of its own count, and not after its early
stop. So each generator ends where the sequential run leaves it, and each
fold reproduces the sequential run of that fold, up to the order of
summation (tests/test_torch_vmap_cv.py, test_torch_vmap_cv_baselines.py,
test_torch_vmap_mtl.py, test_torch_vmap_fbg_fog.py).
A fold that has run out of patience keeps training with the others, its
best snapshot frozen and its draws off, as gaitpd's.

The fused flagship (``fused``, gaitpd_torch/models/fused.py) runs here as
the unfused one does: its backbone is one stream-block launch for every
fold's three streams, and the CAGrad solver one launch for every fold.

With a mesh (``args.mesh``, gaitpd_torch/runtime/mesh.py) the folds shard
over its ranks as gaitpd's ``shard_map`` shards them: each rank runs its
contiguous block of folds with their own generators, with no collective in
a step, and the per-fold results are gathered in fold order at the end. A
fold count the mesh does not divide is printed and every rank runs all
folds, as gaitpd runs them on one device. A rank's stacked checkpoint holds
its block (gaitpd_torch.runtime.mesh.FoldShard.checkpoint_root).

Rematerialisation (``settings.remat``): under ``"nothing"`` the checkpoint
goes around the vmapped fold loss, since torch refuses one inside
``torch.func.vmap`` over ``functional_call``, so the augmentation and the
losses are recomputed with the forward, every fold's generator replayed
(gaitpd_torch/runtime/remat.py); under ``"dots"`` the elementwise ops'
checkpoints sit inside the vmap, as in the sequential step.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call, vmap

from gaitpd_torch.config import FBG_FOG_DIMS, FBG_FOG_TRAIN, normalize_dataset_name
from gaitpd_torch.data import weargait as WG
from gaitpd_torch.data.fbg_fog import build_fusion_fold
from gaitpd_torch.data.sampler import batch_index_matrix
from gaitpd_torch.learning.mtl import FlatPartition, build_flat_partition, combine_flat, make_method
from gaitpd_torch.runtime.device import resolve_device
from gaitpd_torch.runtime.fold_draws import FoldDraws, fold_tokens
from gaitpd_torch.runtime.mesh import shard_folds
from gaitpd_torch.runtime.remat import checkpoint_replaying
from gaitpd_torch.train import metrics as M
from gaitpd_torch.train.baseline_drivers import BaselineArgs, _adapters, _build_model, _hp
from gaitpd_torch.train.baseline_drivers import get_reader as get_baseline_reader
from gaitpd_torch.train.cv import (
    FOG_EXCLUDED_SUBJECTS,
    build_subj2label,
    fbg_label_dict,
    fog_label_dict,
    generate_class_stratified_folds,
    make_fixed_balanced_folds_no_overlap,
)
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
from gaitpd_torch.train.optim import FoldAdam, sgd_torch
from gaitpd_torch.train.step import (
    EvalApply,
    StepSettings,
    TrainApply,
    make_eval_step,
    make_loss_ctx,
    make_multitask_loss_fn,
)
from gaitpd_torch.train.weargait_driver import (
    DROPOUT_BASELINES,
    MASK_COMBOS,
    MODALITIES,
    WearGaitArgs,
    baseline_adapters,
    build_model,
    get_streams,
    split_to_device,
    weargait_aug_config,
)

# Called after every epoch as on_epoch(epoch, train, eval): aggregate_folds's
# dicts of (F, ...) arrays.
VmapEpochHook = Callable[[int, Dict[str, np.ndarray], Dict[str, np.ndarray]], None]


# ---------------------------------------------------------------------------
# Stacking fold data
# ---------------------------------------------------------------------------


def _pad_stack(arrays: List[np.ndarray]) -> np.ndarray:
    """(N_f, ...) arrays zero-padded on axis 0 to the largest N and stacked
    to (F, N_max, ...)."""
    n_max = max(a.shape[0] for a in arrays)
    out = np.zeros((len(arrays), n_max) + arrays[0].shape[1:], arrays[0].dtype)
    for f, a in enumerate(arrays):
        out[f, : a.shape[0]] = a
    return out


@dataclasses.dataclass
class StackedFoldData:
    """Every fold on the device with a leading fold axis."""

    xs: Tuple[torch.Tensor, ...]  # per stream: (F, N_max, T, C)
    ys: Tuple[torch.Tensor, ...]  # per stream: (F, N_max)
    eval_xs: Tuple[torch.Tensor, ...]
    eval_ys: Tuple[torch.Tensor, ...]
    train_pools: List[np.ndarray]  # per fold (host): (N_tr_f, K)
    eval_pools: List[np.ndarray]


def stack_folds(datas: Sequence[DeviceFoldData], device) -> StackedFoldData:
    """The folds' data (on any device) stacked and moved to ``device``, one
    copy a stream."""

    def stack(field):
        k = len(getattr(datas[0], field))
        return tuple(
            torch.from_numpy(_pad_stack([getattr(d, field)[i].cpu().numpy() for d in datas]))
            .to(device) for i in range(k))

    return StackedFoldData(
        xs=stack("xs"), ys=stack("ys"), eval_xs=stack("eval_xs"), eval_ys=stack("eval_ys"),
        train_pools=[d.train_pool for d in datas],
        eval_pools=[d.eval_pool for d in datas],
    )


def stack_index_batches(pools: Sequence[np.ndarray], orders: Sequence[np.ndarray],
                        batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-fold sample orders -> (F, n_b_max, B, K) gather indices and
    (F, n_b_max, B) validity, on the host; a fold with fewer batches gets
    batches that are all padding."""
    idxs, valids = [], []
    for pool, order in zip(pools, orders):
        idx_flat, valid_flat = batch_index_matrix(order, batch_size)
        nb, b = idx_flat.shape
        idxs.append(pool[idx_flat.reshape(-1)].reshape(nb, b, -1))
        valids.append(valid_flat)
    nb_max = max(i.shape[0] for i in idxs)
    f, b, k = len(idxs), idxs[0].shape[1], idxs[0].shape[2]
    idx = np.zeros((f, nb_max, b, k), np.int64)
    valid = np.zeros((f, nb_max, b), np.float32)
    for i, (ix, va) in enumerate(zip(idxs, valids)):
        idx[i, : ix.shape[0]] = ix
        valid[i, : va.shape[0]] = va
    return idx, valid


def _stack_tree(trees):
    """Equal-structured trees of tuples and dicts of tensors -> one tree
    whose leaves are the trees' leaves stacked on a leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {key: _stack_tree([t[key] for t in trees]) for key in first}
    if isinstance(first, (tuple, list)):
        return tuple(_stack_tree(list(parts)) for parts in zip(*trees))
    return torch.stack(trees)


def stack_ctx(ctxs: Sequence[Tuple[Dict[str, torch.Tensor], ...]]):
    """Per-fold loss contexts -> one with a leading fold axis on every entry
    (the augmentation strengths in ``ctx[0]["aug"]`` too)."""
    return _stack_tree(list(ctxs))


def aggregate_folds(metrics: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """gaitpd_torch.train.loop._aggregate for each fold: losses (F, n_b, K),
    correct (F, n_b, K), n (F, n_b) [, ens_correct (F, n_b)] -> loss, acc,
    acc_batchmean (F, K) [and ens_acc (F,)], the batches with n == 0 left out."""
    losses, correct, n = (np.asarray(metrics[k]) for k in ("losses", "correct", "n"))
    real = n > 0  # (F, n_b)
    n_real = np.maximum(1, real.sum(axis=1))  # (F,)
    loss = (losses * real[..., None]).sum(1) / n_real[:, None]
    acc = correct.sum(1) / np.maximum(1.0, n.sum(1))[:, None] * 100.0
    per_batch_acc = correct / np.maximum(n[..., None], 1.0)
    acc_bm = (per_batch_acc * real[..., None]).sum(1) / n_real[:, None] * 100.0
    out = {"loss": loss, "acc": acc, "acc_batchmean": acc_bm}
    if "ens_correct" in metrics:
        ens = np.asarray(metrics["ens_correct"])
        out["ens_acc"] = ens.sum(1) / np.maximum(1.0, n.sum(1)) * 100.0
    return out


# ---------------------------------------------------------------------------
# The stacked state and its steps
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StackedState:
    """Every fold's parameters, stacked: ``params[name]`` is (F, *shape) of
    the model's parameter ``name``, a leaf the optimizer updates in place."""

    model: torch.nn.Module  # one fold's module: the structure functional_call runs
    params: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    mtl_state: Dict[str, torch.Tensor]
    epoch: int = 0


def init_stacked_state(models, make_optimizer, mtl_method, n_folds: int,
                       device) -> Tuple[StackedState, Optional[FlatPartition]]:
    """The stacked state of ``n_folds`` folds. ``models``: one module, which
    every fold starts from (the sequential drivers build each fold's model
    from one seed), or one a fold (a seed sweep's folds start from their
    seeds' models). Each fold also starts from ``mtl_method``'s initial
    state; everything is stacked on ``device``, with one optimizer
    (``make_optimizer(leaves)``) over the stacked leaves, and the flat
    partition of one fold's parameters."""
    if isinstance(models, torch.nn.Module):
        models = [models] * n_folds
    if len(models) != n_folds:
        raise ValueError(f"{len(models)} models for {n_folds} folds")
    model = models[0].to(device)
    named = [dict(m.named_parameters()) for m in models]
    params = {name: torch.stack([n[name].detach().to(device) for n in named]).requires_grad_()
              for name in named[0]}
    partition, mtl_state = None, {}
    if mtl_method is not None:
        partition = build_flat_partition(model, model.shared_modules, model.task_modules)
        mtl_state = _stack_tree([mtl_method.init_state(device) for _ in range(n_folds)])
    state = StackedState(model=model, params=params,
                         optimizer=make_optimizer(list(params.values())), mtl_state=mtl_state)
    return state, partition


class _FoldModule:
    """One fold's module under vmap: ``model`` called with the fold's slice
    of the stacked parameters."""

    def __init__(self, model: torch.nn.Module, params: Dict[str, torch.Tensor]):
        self.model, self.params = model, params

    def __call__(self, *xs, **kwargs):
        return functional_call(self.model, self.params, xs, kwargs)


def _fold_generator(generators, active, token):
    """The generator argument of one fold's step under the vmap: the folds'
    generators, drawing where ``active`` (default: every fold); None
    without generators."""
    if generators is None:
        return None
    return FoldDraws(generators, [True] * len(generators) if active is None else active, token)


class VmapEpochRunner:
    """Train and eval epochs over stacked folds: one fold's loss and eval
    step (gaitpd_torch.train.step) and ``mtl_method``'s combine under
    ``torch.func.vmap``, F folds a call. ``mtl_method`` None trains on the
    mean (or sum, per ``settings.loss_reduction``) of the branch losses.
    ``train_apply`` and ``eval_apply`` are gaitpd_torch.train.loop.
    EpochRunner's. A step given the folds' generators (one a fold) draws
    from each fold's own where ``active`` says (gaitpd_torch/runtime/
    fold_draws.py)."""

    def __init__(self, settings: StepSettings, mtl_method=None,
                 partition: Optional[FlatPartition] = None,
                 train_apply: Optional[TrainApply] = None,
                 eval_apply: Optional[EvalApply] = None):
        self.settings = settings
        self.mtl_method = mtl_method
        self.partition = partition
        # "nothing" checkpoints the vmapped loss as a whole (_losses)
        inner = (dataclasses.replace(settings, remat="none") if settings.remat == "nothing"
                 else settings)
        self.loss_fn = make_multitask_loss_fn(inner, train_apply)
        self.eval_step = make_eval_step(settings, eval_apply)
        self.reduce = torch.mean if settings.loss_reduction == "mean" else torch.sum

    def _losses(self, state: StackedState, xs, ys, valid, ctx, generators=None, active=None):
        epoch = state.epoch
        tokens = fold_tokens(valid.shape[0], valid.device)

        def run(gens, *xs):
            def fold_loss(params, xs, ys, valid, ctx, token):
                return self.loss_fn(_FoldModule(state.model, params), xs, ys, valid, ctx,
                                    _fold_generator(gens, active, token), epoch)

            return vmap(fold_loss)(state.params, xs, ys, valid, ctx, tokens)

        if self.settings.remat != "nothing":
            return run(generators, *xs)
        if generators is None:
            return checkpoint_replaying(lambda _, *xs: run(None, *xs), [], *xs)
        return checkpoint_replaying(run, generators, *xs)

    def _combine(self, state: StackedState, jmat, losses, generators, active):
        """``combine_flat`` of every fold under the vmap: J (F, K, P) and the
        losses (F, K) -> the final flat gradients (F, P) and the new stacked
        method state; a method's draw from each fold's generator, after the
        forward's."""
        method, partition = self.mtl_method, self.partition
        private_grads = self.settings.private_grads

        def fold_combine(jmat, losses, mtl_state, token):
            final, new_state, _ = combine_flat(method, jmat, losses, partition, mtl_state,
                                               private_grads,
                                               _fold_generator(generators, active, token))
            return final, new_state

        tokens = fold_tokens(jmat.shape[0], jmat.device)
        return vmap(fold_combine)(jmat, losses, state.mtl_state, tokens)

    def train_step(self, state: StackedState, batch, ctx, padded: bool,
                   generators: Optional[Sequence[torch.Generator]] = None,
                   active: Optional[Sequence[bool]] = None,
                   stepped: Optional[Sequence[bool]] = None,
                   adam_factors: Optional[torch.Tensor] = None):
        """One step of every fold. ``padded``: whether some fold's batch is
        all padding (known on the host); such a fold keeps its parameters,
        its optimizer's state (momentum; Adam's moments and count) and its
        method state. ``generators``: the folds' generators, each drawing
        where ``active`` (host bools, default: every fold) is True. Under a
        FoldAdam, ``stepped`` (host bools: the folds whose batch is not all
        padding) and ``adam_factors`` (this step's row of its ``plan``) are
        what run_train_epoch knows on the host; left out, they are read here
        (``stepped`` from the device, where ``padded``)."""
        xs, ys, valid = batch["xs"], batch["ys"], batch["valid"]
        names = list(state.params)
        params = [state.params[n] for n in names]
        # (F, K), per head (F, B, C)
        ls, logits = self._losses(state, xs, ys, valid, ctx, generators, active)
        if self.mtl_method is None:
            grads = torch.autograd.grad(self.reduce(ls, 1).sum(), params, allow_unused=True)
        else:
            if self.partition.names != tuple(names):
                raise ValueError("the flat partition does not describe this module")
            n_folds, k = ls.shape
            rows = []
            for i in range(k):
                g = torch.autograd.grad(ls[:, i].sum(), params, retain_graph=i < k - 1,
                                        allow_unused=True)
                rows.append(torch.cat([(torch.zeros_like(p) if gi is None else gi)
                                       .reshape(n_folds, -1) for gi, p in zip(g, params)], 1))
            final, new_mtl_state = self._combine(state, torch.stack(rows, 1), ls.detach(),
                                                 generators, active)
            sizes = [int(np.prod(s)) for s in self.partition.shapes]
            grads = [f.reshape(p.shape) for f, p in zip(final.split(sizes, 1), params)]
        stepped_mask = valid.sum(1) > 0  # (F,), on the device
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        opt = state.optimizer
        if isinstance(opt, FoldAdam):
            if stepped is None:
                stepped = (stepped_mask.cpu().numpy() if padded
                           else [True] * stepped_mask.shape[0])
            opt.step(stepped, stepped_mask, adam_factors)
        else:
            kept = None
            if padded:
                kept = [(p, p.detach().clone(), opt.state.get(p, {}).get("momentum_buffer"))
                        for p in params]
                kept = [(p, old, None if buf is None else buf.clone()) for p, old, buf in kept]
            opt.step()
            if kept is not None:
                with torch.no_grad():
                    for p, old, buf in kept:
                        fold = stepped_mask.reshape((-1,) + (1,) * (p.dim() - 1))
                        p.copy_(torch.where(fold, p, old))
                        new_buf = opt.state[p]["momentum_buffer"]
                        new_buf.copy_(torch.where(
                            fold, new_buf, torch.zeros_like(new_buf) if buf is None else buf))
        if self.mtl_method is not None:
            if padded:  # gaitpd's pick: an idle fold's state as it was
                new_mtl_state = {k: torch.where(
                    stepped_mask.reshape((-1,) + (1,) * (v.dim() - 1)), v, state.mtl_state[k])
                    for k, v in new_mtl_state.items()}
            state.mtl_state = new_mtl_state
        v = valid.to(torch.float32)
        corr = torch.stack([((lg.detach().argmax(-1) == y) * v).sum(1)
                            for lg, y in zip(logits, ys)], 1)
        return state, {"losses": ls.detach(), "correct": corr, "n": v.sum(1)}

    @torch.no_grad()
    def eval_step_folds(self, state: StackedState, params, batch, ctx, epoch, mask,
                        generators: Optional[Sequence[torch.Generator]] = None,
                        active: Optional[Sequence[bool]] = None, collect: bool = False):
        """Every fold's eval forward on its batch; the GCL noise, where the
        settings draw it, from each fold's generator where ``active``. With
        ``collect``, also each head's predictions (F, K, B) and the
        ensemble's (F, B)."""
        keys = ("losses", "correct", "ens_correct", "n") + (("preds", "pred_ens") if collect
                                                            else ())

        def fold_eval(params, xs, ys, valid, ctx, token):
            out = self.eval_step(_FoldModule(state.model, params),
                                 {"xs": xs, "ys": ys, "valid": valid}, ctx,
                                 _fold_generator(generators, active, token), epoch, mask)
            return {k: out[k] for k in keys}

        valid = batch["valid"]
        tokens = fold_tokens(valid.shape[0], valid.device)
        return vmap(fold_eval)(params, batch["xs"], batch["ys"], valid, ctx, tokens)


def _gather(data_xs, data_ys, idx, valid, head_inputs):
    """Every fold's batch: idx (F, B, K) per-stream rows of each fold's
    stacked data."""
    folds = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return {
        "xs": tuple(x[folds, idx[..., i]] for i, x in enumerate(data_xs)),
        "ys": tuple(data_ys[i][folds, idx[..., i]] for i in head_inputs),
        "valid": valid,
    }


def _epoch_on_device(idx: np.ndarray, valid: np.ndarray, device):
    """(F, n_b, B, K) and (F, n_b, B) host arrays -> batch-major device
    tensors, one copy each, and for each batch the host's count of folds
    whose batch is all padding."""
    empty = (valid.sum(2) == 0).sum(0)
    return (torch.from_numpy(np.ascontiguousarray(idx.transpose(1, 0, 2, 3))).to(device),
            torch.from_numpy(np.ascontiguousarray(valid.transpose(1, 0, 2))).to(device),
            [int(e) for e in empty])


def _to_host(outs: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    """Per-batch metrics of (F, ...) -> (F, n_b, ...) host arrays, one copy a
    metric."""
    return {k: torch.stack([o[k] for o in outs], 1).cpu().numpy() for k in outs[0]}


def run_train_epoch(runner: VmapEpochRunner, state: StackedState, data: StackedFoldData,
                    idx: np.ndarray, valid: np.ndarray, ctx, head_inputs,
                    generators: Optional[Sequence[torch.Generator]] = None,
                    live: Optional[Sequence[bool]] = None):
    """One epoch of every fold; a batch that is all padding in every fold
    (the power-of-two tail) is skipped on the host, as the sequential step
    skips it. With ``generators``, a fold draws in each batch that is not
    all padding while it is ``live`` (default: every fold): where its
    sequential run takes a step."""
    idx_d, valid_d, empty = _epoch_on_device(idx, valid, data.xs[0].device)
    n_folds, n_heads = idx.shape[0], len(head_inputs)
    live = [True] * n_folds if live is None else list(live)
    stepped = valid.sum(2) > 0  # (F, n_b), on the host
    # a FoldAdam's bias corrections for the whole epoch: one copy
    plan = state.optimizer.plan(stepped) if isinstance(state.optimizer, FoldAdam) else None
    outs = []
    for b in range(idx_d.shape[0]):
        if empty[b] == n_folds:
            zeros = torch.zeros((n_folds, n_heads), device=valid_d.device)
            outs.append({"losses": zeros, "correct": zeros, "n": zeros[:, 0]})
            continue
        batch = _gather(data.xs, data.ys, idx_d[b], valid_d[b], head_inputs)
        active = [bool(on and s) for on, s in zip(live, stepped[:, b])]
        state, m = runner.train_step(state, batch, ctx, empty[b] > 0, generators, active,
                                     stepped[:, b], None if plan is None else plan[b])
        outs.append(m)
    return state, aggregate_folds(_to_host(outs))


def run_eval_epoch(runner: VmapEpochRunner, state: StackedState, params, data: StackedFoldData,
                   idx: np.ndarray, valid: np.ndarray, ctx, head_inputs, epoch: int, mask,
                   generators: Optional[Sequence[torch.Generator]] = None,
                   draw_batches: Optional[Sequence[int]] = None, collect: bool = False):
    """One eval pass of every fold. With ``generators``, fold f draws in its
    first ``draw_batches[f]`` batches (default: all): its own batch count,
    where its sequential eval runs every batch of its own, or 0 for a fold
    whose sequential run has stopped. With ``collect`` the result also
    holds the predictions, ``preds`` (F, n_b, K, B) and ``pred_ens`` (F,
    n_b, B), read back with the metrics."""
    idx_d, valid_d, _ = _epoch_on_device(idx, valid, data.eval_xs[0].device)
    n_batches = idx_d.shape[0]
    if draw_batches is None:
        draw_batches = [n_batches] * idx.shape[0]
    outs = [runner.eval_step_folds(
        state, params, _gather(data.eval_xs, data.eval_ys, idx_d[b], valid_d[b], head_inputs),
        ctx, epoch, mask, generators, [b < n for n in draw_batches], collect)
        for b in range(n_batches)]
    host = _to_host(outs)
    out = aggregate_folds(host)
    if collect:
        out.update(preds=host["preds"], pred_ens=host["pred_ens"])
    return out


# ---------------------------------------------------------------------------
# Stacked checkpoint / resume (every fold in one snapshot)
# ---------------------------------------------------------------------------


def vmap_checkpoint_path(root) -> Path:
    """``<root>/vmap/latest``: the stacked snapshot of every fold."""
    return Path(root) / "vmap" / "latest"


def save_vmap_checkpoint(root, state: StackedState, stoppers: Sequence[EarlyStopper],
                         extras: dict, epoch: int, rngs: Sequence[np.random.Generator],
                         generators: Sequence[torch.Generator]) -> Path:
    """One ``torch.save`` file holds every fold: the stacked parameters, the
    optimizer's state (the momentum), the MTL state, the epoch (1-based, the
    last finished), each fold's early-stop counters and random streams'
    states, and the driver's ``extras`` (the flagship's stacked best
    parameters and per-modality accuracies). Replaced whole, so a run cut
    while writing leaves the previous snapshot; ``latest.json`` beside it is
    a mirror for people to read."""
    path = vmap_checkpoint_path(root)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "params": {k: v.detach().cpu() for k, v in state.params.items()},
        "optimizer": state.optimizer.state_dict(),
        "mtl_state": {k: v.cpu() for k, v in state.mtl_state.items()},
        "extras": extras,
        "epoch": int(epoch),
        "best": [float(s.best) for s in stoppers],
        "no_improve": [int(s.no_improve) for s in stoppers],
        "rngs": [r.bit_generator.state for r in rngs],
        "generators": [g.get_state() for g in generators],
        "generator_device": generators[0].device.type,
    }
    tmp = path.with_name(path.name + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    meta = {k: payload[k] for k in ("epoch", "best", "no_improve")}
    tmp = path.with_name("latest.json.tmp")
    tmp.write_text(json.dumps(meta))
    os.replace(tmp, path.with_name("latest.json"))
    return path


def load_vmap_snapshot(root, map_location="cpu") -> Optional[dict]:
    """The stacked snapshot's payload, or None if there is none."""
    path = vmap_checkpoint_path(root)
    if not path.exists():
        return None
    return torch.load(path, map_location=map_location, weights_only=True)


def restore_vmap_checkpoint(root, state: StackedState, stoppers: Sequence[EarlyStopper],
                            rngs: Sequence[np.random.Generator],
                            generators: Sequence[torch.Generator]) -> Optional[dict]:
    """Load the stacked snapshot into ``state``, ``stoppers``, ``rngs`` and
    ``generators`` in place and return its payload (``epoch``, ``extras``);
    None if there is none. Raises ValueError on another fold count or a
    generator of another kind of device."""
    payload = load_vmap_snapshot(root)
    if payload is None:
        return None
    if len(payload["best"]) != len(stoppers):
        raise ValueError(f"{vmap_checkpoint_path(root)} holds {len(payload['best'])} folds, "
                         f"this run {len(stoppers)}")
    if payload["generator_device"] != generators[0].device.type:
        raise ValueError(
            f"{vmap_checkpoint_path(root)} was written by a run on "
            f"{payload['generator_device']!r}, and this run's generators are on "
            f"{generators[0].device.type!r}: resume on the device kind that wrote it")
    with torch.no_grad():
        for name, p in state.params.items():
            p.copy_(payload["params"][name])
    state.optimizer.load_state_dict(payload["optimizer"])
    device = next(iter(state.params.values())).device
    state.mtl_state = {k: v.to(device) for k, v in payload["mtl_state"].items()}
    for st, best, ni in zip(stoppers, payload["best"], payload["no_improve"]):
        st.best, st.no_improve = float(best), int(ni)
    for r, s in zip(rngs, payload["rngs"]):
        r.bit_generator.state = s
    for g, s in zip(generators, payload["generators"]):
        g.set_state(s)
    return payload


# ---------------------------------------------------------------------------
# The WearGait drivers
# ---------------------------------------------------------------------------


def _folds_and_splits(args: WearGaitArgs):
    streams, pd_ids, hc_ids = get_streams(args)
    subj2label = build_subj2label(pd_ids, hc_ids)
    folds = make_fixed_balanced_folds_no_overlap(
        pd_ids, hc_ids, n_folds=args.n_folds, per_class=args.test_per_class, seed=args.seed)
    if args.n_folds_cap:
        folds = folds[: args.n_folds_cap]
    return [WG.prepare_split(streams, tr, te, subj2label, win=args.win_len, hop=args.hop_len)
            for tr, te in folds]


def _instance_streams(instances: Sequence[Tuple[int, int]], device):
    """Each (seed, fold number) instance's numpy generator (seed + 1000 fi)
    and torch.Generator (seed + fi), as the sequential drivers build them."""
    rngs = [np.random.default_rng(seed + 1000 * fi) for seed, fi in instances]
    gens = [torch.Generator(device=device).manual_seed(seed + fi) for seed, fi in instances]
    return rngs, gens


def _random_streams(args, folds, device):
    """``_instance_streams`` of ``args.seed``'s folds: ``folds`` lists their
    numbers, or counts them from 1."""
    ids = range(1, folds + 1) if isinstance(folds, int) else folds
    return _instance_streams([(args.seed, fi) for fi in ids], device)


def _eval_indices(stacked: StackedFoldData, batch_size: int):
    """The eval pass's stacked indices and validity, and each fold's own
    batch count (the power-of-two tail of its sequential eval included)."""
    orders = [np.arange(len(p)) for p in stacked.eval_pools]
    idx, valid = stack_index_batches(stacked.eval_pools, orders, batch_size)
    counts = [batch_index_matrix(o, batch_size)[0].shape[0] for o in orders]
    return idx, valid, counts


def run_cv_vmapped(args: WearGaitArgs, on_epoch: Optional[VmapEpochHook] = None):
    """weargait_driver.run_cv with every fold in one step (gaitpd/train/
    vmap_cv.py:235-484): the flagship or any ``baseline`` (no MTL method,
    SGD for all, as run_fold), with the recipe's draws; the same summary
    dict, and ``per_fold_macro``. With ``ckpt_dir`` one stacked snapshot of
    every fold is written each epoch; ``resume`` continues from it. With
    ``args.mesh`` the folds shard over its ranks (module docstring)."""
    device = resolve_device(args.device)  # raise before any work
    if args.single_mod is not None:
        return _weargait_single_mod_vmapped(args, on_epoch)
    async_mode = args.async_loading
    sync_flag = not async_mode
    splits = _folds_and_splits(args)
    shard = shard_folds(len(splits), args.mesh)
    fold_ids = shard.take(range(1, len(splits) + 1))
    splits = shard.take(splits)
    ckpt_dir = shard.checkpoint_root(args.ckpt_dir)
    f = len(splits)
    datas = [split_to_device(s, async_mode, args.seed, "cpu") for s in splits]
    stacked = stack_folds(datas, device)

    aug_specs, aug_params = weargait_aug_config(args)
    settings = StepSettings(
        n_streams=3, wm=args.wm, synchronized=sync_flag, gcl_m=args.gcl_m, gcl_s=args.gcl_s,
        noise_mul=args.noise_mul, drw_warmup=args.drw_warmup, consistency_lambda=0.0,
        private_grads="sum_plus_own", dropout=args.baseline in DROPOUT_BASELINES,
        modality_dropout=args.modality_dropout, augment=aug_specs,
    )
    ctx = stack_ctx([
        make_loss_ctx(settings, [np.bincount(s.train[m].y[d.train_pool[:, k]],
                                             minlength=args.num_classes)
                                 for k, m in enumerate(MODALITIES)], device=device,
                      aug_params=aug_params)
        for s, d in zip(splits, datas)])

    # the MTL method for the flagship only; the baselines train on the mean
    # of the branch losses (run_fold); c is CAGrad's strength, other methods
    # take no c
    mtl = None
    if args.baseline is None and args.alpha > 0:
        kwargs = {"c": args.alpha} if args.mtl_method in ("cagrad", "log_cagrad") else {}
        mtl = make_method(args.mtl_method, 3, **kwargs)
    make_optimizer = functools.partial(sgd_torch, lr=args.lr, momentum=0.9, weight_decay=1e-4)
    state, partition = init_stacked_state(build_model(args, sync_flag), make_optimizer, mtl, f,
                                          device)
    runner = VmapEpochRunner(settings, mtl, partition, *baseline_adapters(args))
    heads = tuple(range(3))

    rngs, gens = _random_streams(args, fold_ids, device)
    stoppers = [EarlyStopper(patience=args.patience) for _ in range(f)]
    best_params = {k: v.detach().cpu().clone() for k, v in state.params.items()}
    best_per_mod = np.zeros((f, 3))

    start_epoch = 1
    if ckpt_dir and args.resume:
        payload = restore_vmap_checkpoint(ckpt_dir, state, stoppers, rngs, gens)
        if payload is not None:
            best_params = payload["extras"]["best_params"]
            best_per_mod = payload["extras"]["best_per_mod"].numpy().copy()
            start_epoch = payload["epoch"] + 1
            print(f"[vmap-cv] resumed from epoch {start_epoch}")

    eval_idx, eval_valid, eval_counts = _eval_indices(stacked, args.batch_size)
    for ep in range(start_epoch, args.epochs + 1):
        state.epoch = ep - 1
        pools = stacked.train_pools
        if async_mode:  # each fold's pools reseeded every epoch, as run_fold
            pools = [WG.async_pool(s.train, np.random.default_rng(args.seed + ep))
                     for s in splits]
        idx, valid = stack_index_batches(
            pools, [r.permutation(len(p)) for r, p in zip(rngs, pools)], args.batch_size)
        live = [not st.stop for st in stoppers]  # a stopped fold draws no more
        state, tr = run_train_epoch(runner, state, stacked, idx, valid, ctx, heads, gens, live)
        ev = run_eval_epoch(runner, state, state.params, stacked, eval_idx, eval_valid, ctx,
                            heads, state.epoch, (True,) * 3, gens,
                            [n if on else 0 for n, on in zip(eval_counts, live)])
        macros = ev["acc_batchmean"].mean(axis=1) if async_mode else ev["ens_acc"]
        # a fold out of patience is frozen: the sequential driver stops it
        improved = [(not st.stop) and st.update(float(v)) for st, v in zip(stoppers, macros)]
        if any(improved):
            rows = torch.tensor([i for i, imp in enumerate(improved) if imp])
            for name, p in state.params.items():
                best_params[name][rows] = p.detach()[rows.to(p.device)].cpu()
            best_per_mod[rows.numpy()] = ev["acc_batchmean"][rows.numpy()]
        if ckpt_dir:
            save_vmap_checkpoint(ckpt_dir, state, stoppers,
                                 {"best_params": best_params,
                                  "best_per_mod": torch.from_numpy(best_per_mod)},
                                 ep, rngs, gens)
        if on_epoch is not None:
            on_epoch(ep, tr, ev)
        if args.verbose:
            print(f"[vmap-cv] Ep {ep:03d} | macro="
                  f"{np.array2string(np.asarray(macros), precision=1)} best="
                  f"{np.array2string(np.asarray([s.best for s in stoppers]), precision=1)} "
                  f"live_folds={sum(not st.stop for st in stoppers)}")
        if all(st.stop for st in stoppers):
            print(f"[vmap-cv] all folds early-stopped at epoch {ep}")
            break

    # --- masked relaxed-input eval at each fold's best parameters ----------
    best = {k: v.to(device) for k, v in best_params.items()}
    # run_fold's masked eval runs (and draws) where the fold ever improved
    mask_draws = [n if st.best > 0 else 0 for n, st in zip(eval_counts, stoppers)]
    mask_fold_scores: Dict[str, List[float]] = {}
    for mk, tup in MASK_COMBOS.items():
        r = run_eval_epoch(runner, state, best, stacked, eval_idx, eval_valid, ctx, heads,
                           state.epoch, tup, gens, mask_draws)
        if async_mode:
            scores = r["acc_batchmean"][:, np.asarray(tup, bool)].mean(axis=1)
        else:
            scores = r["ens_acc"]
        mask_fold_scores[mk] = shard.gather([float(s) for s in scores])

    fold_macro = shard.gather([st.best for st in stoppers])
    best_per_mod = np.asarray(shard.gather(list(best_per_mod)))
    print("\n=== Summary (vmapped CV) ===")
    print(f"Macro acc mean ± std: {np.mean(fold_macro):.2f}% ± {np.std(fold_macro):.2f}%")
    print("\n=== Masked accuracy at best epoch (avg across folds) ===")
    for mk, arr in mask_fold_scores.items():
        a = np.asarray(arr, float)
        print(f"[{mk:5}] {a.mean():5.2f}% ± {a.std():4.2f}%  over {len(a)} folds")
    return {
        "macro": (float(np.mean(fold_macro)), float(np.std(fold_macro))),
        "per_fold_macro": [float(x) for x in fold_macro],
        "per_mod": {m: float(best_per_mod[:, i].mean()) for i, m in enumerate(MODALITIES)},
        "masks": {k: float(np.mean(v)) for k, v in mask_fold_scores.items()},
        "per_fold_masks": mask_fold_scores,
    }


def _weargait_single_mod_vmapped(args: WearGaitArgs, on_epoch: Optional[VmapEpochHook] = None):
    """weargait_driver.run_single_mod_fold for every fold at once (gaitpd/
    train/vmap_cv.py:487-668): the chosen stream through the shared backbone
    and its head, a fresh SGD state every epoch, pooled eval accuracy, no
    masked table. Checkpoints hold the stacked snapshot, without extras."""
    device = resolve_device(args.device)
    async_mode = args.async_loading
    k = MODALITIES.index(args.single_mod)
    splits = _folds_and_splits(args)
    shard = shard_folds(len(splits), args.mesh)
    fold_ids = shard.take(range(1, len(splits) + 1))
    splits = shard.take(splits)
    ckpt_dir = shard.checkpoint_root(args.ckpt_dir)
    f = len(splits)
    datas = []
    for s in splits:
        d = split_to_device(s, async_mode, args.seed, "cpu")
        datas.append(DeviceFoldData(
            xs=d.xs[k:k + 1], ys=d.ys[k:k + 1], train_pool=d.train_pool[:, k:k + 1],
            eval_pool=d.eval_pool[:, k:k + 1], eval_xs=d.eval_xs[k:k + 1],
            eval_ys=d.eval_ys[k:k + 1]))
    stacked = stack_folds(datas, device)
    aug_specs, aug_params = weargait_aug_config(args, n_streams=1)
    settings = StepSettings(n_streams=1, wm=args.wm, synchronized=False, gcl_m=args.gcl_m,
                            gcl_s=args.gcl_s, noise_mul=args.noise_mul,
                            drw_warmup=args.drw_warmup, augment=aug_specs)
    ctx = stack_ctx([make_loss_ctx(settings, [np.bincount(
        s.train[args.single_mod].y[d.train_pool[:, 0]], minlength=args.num_classes)],
        device=device, aug_params=aug_params) for s, d in zip(splits, datas)])
    make_optimizer = functools.partial(sgd_torch, lr=args.lr, momentum=0.9, weight_decay=1e-4)
    state, _ = init_stacked_state(build_model(args, not async_mode), make_optimizer, None, f,
                                  device)
    runner = VmapEpochRunner(settings)
    heads = (0,)
    rngs, gens = _random_streams(args, fold_ids, device)
    stoppers = [EarlyStopper(patience=args.patience) for _ in range(f)]

    start_epoch = 1
    if ckpt_dir and args.resume:
        payload = restore_vmap_checkpoint(ckpt_dir, state, stoppers, rngs, gens)
        if payload is not None:
            start_epoch = payload["epoch"] + 1
            print(f"[vmap-cv] resumed from epoch {start_epoch}")

    eval_idx, eval_valid, eval_counts = _eval_indices(stacked, args.batch_size)
    for ep in range(start_epoch, args.epochs + 1):
        state.epoch = ep - 1
        # the reference builds a fresh SGD optimizer every epoch
        # (weargait_train.py:273-276): momentum starts from zero again
        state.optimizer = make_optimizer(list(state.params.values()))
        pools = stacked.train_pools
        if async_mode:
            pools = [WG.async_pool(s.train, np.random.default_rng(args.seed + ep))[:, k:k + 1]
                     for s in splits]
        idx, valid = stack_index_batches(
            pools, [r.permutation(len(p)) for r, p in zip(rngs, pools)], args.batch_size)
        live = [not st.stop for st in stoppers]
        state, tr = run_train_epoch(runner, state, stacked, idx, valid, ctx, heads, gens, live)
        ev = run_eval_epoch(runner, state, state.params, stacked, eval_idx, eval_valid, ctx,
                            heads, state.epoch, (True,), gens,
                            [n if on else 0 for n, on in zip(eval_counts, live)])
        vas = ev["acc"][:, 0]  # pooled accuracy (weargait_train.py:292-296)
        for st, v in zip(stoppers, vas):
            if not st.stop:
                st.update(float(v))
        if ckpt_dir:
            save_vmap_checkpoint(ckpt_dir, state, stoppers, {}, ep, rngs, gens)
        if on_epoch is not None:
            on_epoch(ep, tr, ev)
        if args.verbose:
            print(f"[vmap-cv] Ep {ep:03d} | {args.single_mod} val="
                  f"{np.array2string(np.asarray(vas), precision=1)} best="
                  f"{np.array2string(np.asarray([s.best for s in stoppers]), precision=1)}")
        if all(st.stop for st in stoppers):
            print(f"[vmap-cv] all folds early-stopped at epoch {ep}")
            break

    fold_macro = shard.gather([st.best for st in stoppers])
    print("\n=== Summary (vmapped CV, single_mod) ===")
    print(f"Macro acc mean ± std: {np.mean(fold_macro):.2f}% ± {np.std(fold_macro):.2f}%")
    return {
        "macro": (float(np.mean(fold_macro)), float(np.std(fold_macro))),
        "per_fold_macro": [float(x) for x in fold_macro],
        "per_mod": {m: (float(np.mean(fold_macro)) if m == args.single_mod else 0.0)
                    for m in MODALITIES},
        "masks": {},
    }


# ---------------------------------------------------------------------------
# The FBG/FoG drivers: the multitask models' folds, the baselines' seed sweeps
# ---------------------------------------------------------------------------


def _class_counts(data: DeviceFoldData, streams, num_classes: int) -> list:
    """Each stream's class counts over the fold's train pool."""
    return [np.bincount(data.ys[k].numpy()[data.train_pool[:, k]], minlength=num_classes)
            for k in streams]


def _collected(data: DeviceFoldData, preds: torch.Tensor, pred_ens: torch.Tensor,
               n_batches: int, batch_size: int, head_inputs):
    """One fold's collected eval predictions, as the sequential
    run_eval_epoch(collect=True) returns them: its first ``n_batches`` of
    ``preds`` (n_b, K, B) and ``pred_ens`` (n_b, B) flattened to its valid
    samples in eval order, and their labels."""
    idx_flat, valid_flat = batch_index_matrix(np.arange(len(data.eval_pool)), batch_size)
    vmask = valid_flat.reshape(-1) > 0
    rows = data.eval_pool[idx_flat.reshape(-1)][vmask]
    return ([preds[:n_batches, k].reshape(-1).numpy()[vmask] for k in range(preds.shape[1])],
            [data.eval_ys[src].numpy()[rows[:, src]] for src in head_inputs],
            pred_ens[:n_batches].reshape(-1).numpy()[vmask])


def run_fbg_fog_vmapped(args: FbgFogArgs, on_epoch: Optional[VmapEpochHook] = None,
                        reader=None):
    """fbg_fog_driver.main with every class-stratified fold of each mode in
    one step (gaitpd/train/vmap_cv.py:751-790); the same summary dict. With
    ``ckpt_dir`` one stacked snapshot a mode under ``<ckpt_dir>/<mode>``,
    which ``resume`` continues. ``reader``: as main's. With ``args.mesh``
    each mode's folds shard over its ranks (module docstring)."""
    check_fbg_fog_supported(args)
    resolve_device(args.device)  # raise before any work
    dataset = normalize_dataset_name(args.dataset)
    reader = get_fbg_fog_reader(args) if reader is None else reader
    label_dict = fbg_label_dict(reader) if dataset == "fbg" else fog_label_dict(reader)
    folds = generate_class_stratified_folds(label_dict, np.random.default_rng(args.seed))
    if args.n_folds_cap:
        folds = folds[: args.n_folds_cap]
    summary = {}
    for mod in MODALITY_MODES[args.modality]:
        ckpt = str(Path(args.ckpt_dir) / mod) if args.ckpt_dir else None
        print(f"\n>>> MODE: {mod.upper()} (vmapped folds) <<<")
        results = _fbg_fog_folds_vmapped(
            reader, folds, dataclasses.replace(args, modality=mod, ckpt_dir=ckpt), on_epoch)
        mean_sk, mean_se, mean_av = np.asarray(results).mean(axis=0)
        if mod == "multimodal" and args.synchronized_loading:
            print(f"mean Ensemble Acc: {mean_av:.2f}%")
        else:
            print(f"mean skel={mean_sk:.2f}%, sensor={mean_se:.2f}%, avg={mean_av:.2f}%")
        summary[mod] = dict(skel=mean_sk, sensor=mean_se, avg=mean_av)
    return summary


def _fbg_fog_folds_vmapped(reader, folds, args: FbgFogArgs,
                           on_epoch: Optional[VmapEpochHook] = None) -> list:
    """Every fold of one mode at once (gaitpd/train/vmap_cv.py:793-1045):
    fbg_fog_driver.train_one_fold's model, SGD, loss context, method (CAGrad
    at K = 2 by default, any other under the stacked combine) and random
    streams a fold. Returns [(skel, sensor, best avg)] a fold from its best
    epoch's collected predictions, which the stacked snapshot carries."""
    device = resolve_device(args.device)
    dataset = normalize_dataset_name(args.dataset)
    dims, tp = FBG_FOG_DIMS[dataset], FBG_FOG_TRAIN[dataset]
    epochs = args.epochs or tp.epochs
    batch_size = args.batch_size or tp.batch_size
    multimodal = args.modality == "multimodal"
    sync_multimodal = multimodal and args.synchronized_loading
    n_streams = 2 if multimodal else 1
    heads = tuple(range(n_streams))
    shard = shard_folds(len(folds), args.mesh)
    fold_ids = shard.take(range(1, len(folds) + 1))
    ckpt_dir = shard.checkpoint_root(args.ckpt_dir)
    datas = [fold_to_device(build_fusion_fold(
        dataset, reader, tr, ev, synchronized=args.synchronized_loading, seed=args.seed,
        pad_skel=dims.pose_length, pad_sens=dims.sensor_length, modality=args.modality),
        args.modality, "cpu") for tr, ev in shard.take(folds)]
    f = len(datas)
    stacked = stack_folds(datas, device)
    aug_specs, aug_params = augment_config(args, dims.skeleton_input_dim, args.modality)
    settings = StepSettings(
        n_streams=n_streams, wm=args.wm, synchronized=args.synchronized_loading,
        ldam_s=args.ldam_s, gcl_m=args.gcl_m, gcl_s=args.gcl_s, noise_mul=args.noise_mul,
        drw_warmup=args.drw_warmup,
        consistency_lambda=args.consistency_lambda if multimodal else 0.0,
        private_grads="sum", augment=aug_specs)
    ctx = stack_ctx([make_loss_ctx(settings, _class_counts(d, heads, dims.num_classes),
                                   device=device, aug_params=aug_params, ldam_max_m=args.ldam_m)
                     for d in datas])
    mtl = None
    if multimodal and args.alpha > 0:
        kwargs = ({"c": args.alpha, "max_norm": args.max_norm}
                  if args.mtl_method in ("cagrad", "log_cagrad") else {})
        mtl = make_method(args.mtl_method, n_streams, **kwargs)
    make_optimizer = functools.partial(sgd_torch, lr=tp.learning_rate, momentum=tp.momentum,
                                       weight_decay=tp.weight_decay)
    state, partition = init_stacked_state(choose_model(args, dims), make_optimizer, mtl, f,
                                          device)
    runner = VmapEpochRunner(settings, mtl, partition)
    rngs, gens = _random_streams(args, fold_ids, device)
    stoppers = [EarlyStopper(patience=tp.patience) for _ in range(f)]
    eval_idx, eval_valid, eval_counts = _eval_indices(stacked, batch_size)
    # the best epoch's predictions at fixed shapes, so the snapshot holds them
    n_b, b_sz = eval_idx.shape[1], eval_idx.shape[2]
    best = {"best_preds": torch.zeros((f, n_b, n_streams, b_sz), dtype=torch.int64),
            "best_pred_ens": torch.zeros((f, n_b, b_sz), dtype=torch.int64),
            "has_best": torch.zeros(f, dtype=torch.bool)}

    start_epoch = 1
    if ckpt_dir and args.resume:
        payload = restore_vmap_checkpoint(ckpt_dir, state, stoppers, rngs, gens)
        if payload is not None:
            best = {k: payload["extras"][k] for k in best}
            start_epoch = payload["epoch"] + 1
            print(f"[vmap-cv] resumed from epoch {start_epoch}")

    for ep in range(start_epoch, epochs + 1):
        state.epoch = ep - 1
        idx, valid = stack_index_batches(
            stacked.train_pools, [r.permutation(len(p)) for r, p in zip(rngs, stacked.train_pools)],
            batch_size)
        live = [not st.stop for st in stoppers]  # a stopped fold draws no more
        state, tr = run_train_epoch(runner, state, stacked, idx, valid, ctx, heads, gens, live)
        ev = run_eval_epoch(runner, state, state.params, stacked, eval_idx, eval_valid, ctx,
                            heads, state.epoch, (True,) * n_streams, gens,
                            [n if on else 0 for n, on in zip(eval_counts, live)], collect=True)
        if sync_multimodal:
            avgs = ev["ens_acc"]
        elif multimodal:
            avgs = ev["acc"].mean(axis=1)
        else:
            avgs = ev["acc"][:, 0]
        # a fold out of patience is frozen: the sequential driver stops it
        improved = [(not st.stop) and st.update(float(v)) for st, v in zip(stoppers, avgs)]
        if any(improved):
            rows = torch.tensor([i for i, imp in enumerate(improved) if imp])
            best["best_preds"][rows] = torch.from_numpy(ev["preds"])[rows]
            best["best_pred_ens"][rows] = torch.from_numpy(ev["pred_ens"])[rows]
            best["has_best"][rows] = True
        if ckpt_dir:
            save_vmap_checkpoint(ckpt_dir, state, stoppers, best, ep, rngs, gens)
        if on_epoch is not None:
            on_epoch(ep, tr, ev)
        if args.verbose:
            print(f"[vmap-cv] Ep {ep:03d}/{epochs} | avg="
                  f"{np.array2string(np.asarray(avgs), precision=1)} best="
                  f"{np.array2string(np.asarray([s.best for s in stoppers]), precision=1)}")
        if all(st.stop for st in stoppers):
            print(f"[vmap-cv] all folds early-stopped at epoch {ep}")
            break

    results = []
    for i, (d, st) in enumerate(zip(datas, stoppers)):
        if not best["has_best"][i]:
            results.append((0.0, 0.0, 0.0))
            continue
        preds, trues, preds_ens = _collected(d, best["best_preds"][i], best["best_pred_ens"][i],
                                             eval_counts[i], batch_size, heads)
        accs = [M.accuracy(p, t) for p, t in zip(preds, trues)]
        sk, se = {"skeleton": (accs[0], 0.0), "sensor": (0.0, accs[0])}.get(args.modality,
                                                                           tuple(accs))
        results.append((sk, se, float(st.best)))
        if args.verbose:
            if sync_multimodal:
                M.print_report(trues[0], preds_ens, f"Fold {fold_ids[i]} Best Ensemble")
            else:
                M.print_report(trues[0], preds[0], f"Fold {fold_ids[i]} Best Stream0")
    return shard.gather(results)


def run_fusion_seeds_vmapped(dataset: str, fusion_type: str, seeds: Sequence[int], **kw):
    """run_baseline_seeds_vmapped of one fusion type (gaitpd/train/
    vmap_cv.py:1048-1050)."""
    return run_baseline_seeds_vmapped(dataset, "fusion", fusion_type, seeds, **kw)


def run_baseline_seeds_vmapped(dataset: str, kind: str, variant: str, seeds: Sequence[int], *,
                               synced: bool = False, wm: str = "ce",
                               epochs: Optional[int] = None, batch_size: Optional[int] = None,
                               n_folds_cap: Optional[int] = None, synthetic: bool = False,
                               verbose: bool = False, device=None,
                               on_epoch: Optional[VmapEpochHook] = None) -> dict:
    """Every (seed, fold) instance of one FBG/FoG baseline configuration in
    one step (gaitpd/train/vmap_cv.py:1053-1269): ``kind`` fusion (of
    ``variant``'s fusion type; Adam, the mean of the CE losses) or deepav,
    focal, taca (AdamW with decay 1e-4 and the clip 1.0, their sum), each
    instance as baseline_drivers.train_fold trains it: its seed's reader,
    folds (FBG with the FoG exclusions), model and random streams.
    Returns {seed: {"skel", "sensor", "avg"}}, the means over its folds."""
    dataset = normalize_dataset_name(dataset)
    dims = FBG_FOG_DIMS[dataset]
    bargs = BaselineArgs(kind=kind, dataset=dataset, fusion_type=variant, synced=synced, wm=wm,
                         epochs=epochs, batch_size=batch_size, synthetic=synthetic,
                         device=device)
    dev = resolve_device(device)  # raise before any work
    hp = _hp(bargs, dataset)
    # one joint head when synced, but the share-latent fusion's two
    # (reference fusion_train.py:168-173)
    two_heads = (not synced) or (kind == "fusion" and variant == "share_latent")
    head_inputs = (0, 1) if two_heads else (0,)

    instances, models = [], []  # (seed, fold number, host data), a model each
    for seed in seeds:
        sargs = dataclasses.replace(bargs, seed=seed)
        reader = get_baseline_reader(sargs)
        # baseline_drivers.main passes the FoG exclusions for FBG too
        label_dict = (fbg_label_dict(reader, exclude=FOG_EXCLUDED_SUBJECTS) if dataset == "fbg"
                      else fog_label_dict(reader))
        folds = generate_class_stratified_folds(label_dict, np.random.default_rng(seed))
        model = _build_model(sargs, dims, hp, synced)
        for fi, (tr, te) in enumerate(folds[:n_folds_cap] if n_folds_cap else folds, 1):
            fold = build_fusion_fold(dataset, reader, tr, te, synchronized=synced, seed=seed,
                                     pad_skel=dims.pose_length, pad_sens=hp["sensor_length"],
                                     modality="multimodal")
            instances.append((seed, fi, fold_to_device(fold, "multimodal", "cpu")))
            models.append(model)
    f = len(instances)
    datas = [d for _, _, d in instances]
    stacked = stack_folds(datas, dev)
    settings = StepSettings(n_streams=len(head_inputs), wm=wm if wm in ("ce", "class_wt") else "ce",
                            synchronized=synced,
                            loss_reduction="mean" if kind == "fusion" else "sum")
    ctx = stack_ctx([make_loss_ctx(settings, _class_counts(d, head_inputs, dims.num_classes),
                                   device=dev) for d in datas])
    if kind == "fusion":  # reference fusion_train.py:202, no clip
        make_optimizer = functools.partial(FoldAdam, n_folds=f, lr=hp["lr"])
    else:
        make_optimizer = functools.partial(FoldAdam, n_folds=f, lr=hp["lr"], weight_decay=1e-4,
                                           grad_clip=1.0)
    state, _ = init_stacked_state(models, make_optimizer, None, f, dev)
    runner = VmapEpochRunner(settings, None, None, *_adapters(bargs, hp))
    rngs, gens = _instance_streams([(seed, fi) for seed, fi, _ in instances], dev)
    stoppers = [EarlyStopper(patience=hp["patience"]) for _ in range(f)]
    best_payload = [None] * f
    eval_idx, eval_valid, eval_counts = _eval_indices(stacked, hp["batch"])

    for ep in range(1, hp["epochs"] + 1):
        state.epoch = ep - 1
        idx, valid = stack_index_batches(
            stacked.train_pools, [r.permutation(len(p)) for r, p in zip(rngs, stacked.train_pools)],
            hp["batch"])
        live = [not st.stop for st in stoppers]
        state, tr = run_train_epoch(runner, state, stacked, idx, valid, ctx, head_inputs, gens,
                                    live)
        ev = run_eval_epoch(runner, state, state.params, stacked, eval_idx, eval_valid, ctx,
                            head_inputs, state.epoch, (True, True), gens,
                            [n if on else 0 for n, on in zip(eval_counts, live)], collect=True)
        scores = ev["acc"].mean(axis=1)  # the joint head's, or the mean of the two heads'
        improved = [(not st.stop) and st.update(float(v)) for st, v in zip(stoppers, scores)]
        for i, imp in enumerate(improved):
            if imp:
                preds = torch.from_numpy(ev["preds"][i])
                best_payload[i] = _collected(datas[i], preds, torch.from_numpy(ev["pred_ens"][i]),
                                             eval_counts[i], hp["batch"], head_inputs)[:2]
        if on_epoch is not None:
            on_epoch(ep, tr, ev)
        if verbose:
            print(f"[vmap-sweep {kind}:{variant}] Ep {ep:03d}/{hp['epochs']} best="
                  f"{np.array2string(np.asarray([s.best for s in stoppers]), precision=1)}")
        if all(st.stop for st in stoppers):
            break

    per_seed: Dict[int, list] = {}
    for (seed, _, _), payload in zip(instances, best_payload):
        row = (0.0, 0.0, 0.0)
        if payload is not None:
            accs = [M.accuracy(p, t) for p, t in zip(*payload)]
            row = (accs[0], 0.0, accs[0]) if len(accs) == 1 else (*accs, 0.5 * sum(accs))
        per_seed.setdefault(seed, []).append(row)
    out = {}
    for seed, rows in per_seed.items():
        sk, se, av = np.asarray(rows).mean(axis=0)
        out[seed] = {"skel": float(sk), "sensor": float(se), "avg": float(av)}
    return out
