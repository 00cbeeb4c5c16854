"""Fold and epoch training: the fold's windows on the device once, a loop
of steps over a per-epoch index matrix, early stopping, masked
relaxed-input evaluation. Port of gaitpd/train/loop.py:32-268.

Where gaitpd scans a compiled step over the epoch, the port runs a Python
loop of eager steps. The epoch's (n_batches, B, K) index matrix goes to the
device in one copy; each step gathers its batch there. Metrics stay on the
device until the epoch ends and are read back in one copy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from gaitpd_torch.data.sampler import batch_index_matrix
from gaitpd_torch.learning.mtl import FlatPartition, build_flat_partition
from gaitpd_torch.train.step import StepSettings, TrainState, make_eval_step, make_train_step


@dataclasses.dataclass
class DeviceFoldData:
    """One fold resident on the device: per-stream tensors + host index pools."""

    xs: Tuple[torch.Tensor, ...]  # per stream: (N_k, T_k, C_k)
    ys: Tuple[torch.Tensor, ...]  # per stream: (N_k,)
    train_pool: np.ndarray  # (N_tr, K) int32 rows of per-stream indices
    eval_pool: np.ndarray  # (N_ev, K)
    eval_xs: Tuple[torch.Tensor, ...]
    eval_ys: Tuple[torch.Tensor, ...]


def _gather_batch(xs, ys, idx, valid, n_valid):
    """idx: (B, K) tensor of per-stream indices -> batch dict."""
    return {
        "xs": tuple(x[idx[:, i]] for i, x in enumerate(xs)),
        "ys": tuple(y[idx[:, i]] for i, y in enumerate(ys)),
        "valid": valid,
        "n_valid": n_valid,
    }


def _epoch_indices(pool: np.ndarray, order: np.ndarray, batch_size: int, device):
    """(idx (n_batches, B, K) on the device, valid (n_batches, B) on the
    device, valid counts per batch on the host)."""
    idx_flat, valid_flat = batch_index_matrix(order, batch_size)
    n_batches = idx_flat.shape[0]
    idx = pool[idx_flat.reshape(-1)].reshape(n_batches, batch_size, -1).astype(np.int64)
    counts = [int(c) for c in valid_flat.sum(axis=1)]
    return torch.from_numpy(idx).to(device), torch.from_numpy(valid_flat).to(device), counts


class EpochRunner:
    """Train and eval epochs for one model configuration: a loop of
    ``make_train_step`` / ``make_eval_step`` calls."""

    def __init__(self, settings: StepSettings, mtl_method=None,
                 partition: Optional[FlatPartition] = None):
        self.settings = settings
        self.train_step = make_train_step(settings, mtl_method, partition)
        self.eval_step = make_eval_step(settings)

    def train_epoch(self, state, xs, ys, idx, valid, counts, generator, ctx):
        metrics = []
        for b, n in enumerate(counts):
            state, m = self.train_step(state, _gather_batch(xs, ys, idx[b], valid[b], n),
                                       generator, ctx)
            metrics.append(m)
        return state, metrics

    def eval_epoch(self, module, xs, ys, idx, valid, counts, generator, ctx, epoch, mask):
        module.eval()
        return [self.eval_step(module, _gather_batch(xs, ys, idx[b], valid[b], n), ctx,
                               generator, epoch, mask)
                for b, n in enumerate(counts)]


@dataclasses.dataclass
class EpochResult:
    loss: np.ndarray  # (K,) mean per-stream loss over batches
    acc: np.ndarray  # (K,) accuracy
    acc_batchmean: np.ndarray  # (K,) mean of per-batch accs (weargait style)
    steps: int = 0  # batches with at least one valid sample
    ens_acc: Optional[float] = None


def _to_host(outs: Sequence[Dict[str, torch.Tensor]], keys) -> Dict[str, np.ndarray]:
    """Stack the per-batch device metrics and copy them to the host once."""
    return {k: torch.stack([o[k] for o in outs]).cpu().numpy() for k in keys}


def _aggregate(metrics: Dict[str, np.ndarray]) -> EpochResult:
    """Aggregate per-batch metrics, excluding the fully padded (n == 0)
    batches of the power-of-two quantization."""
    losses = metrics["losses"]  # (n_batches, K)
    correct = metrics["correct"]  # (n_batches, K)
    n = metrics["n"]  # (n_batches,)
    real = n > 0
    n_real = max(1, int(real.sum()))
    return EpochResult(
        loss=losses[real].sum(0) / n_real,
        acc=correct.sum(0) / max(1.0, n.sum()) * 100.0,
        acc_batchmean=(correct[real] / np.maximum(n[real, None], 1.0)).sum(0) / n_real * 100.0,
        steps=int(real.sum()),
    )


def run_train_epoch(
    runner: EpochRunner,
    state: TrainState,
    data: DeviceFoldData,
    order: np.ndarray,
    batch_size: int,
    generator: Optional[torch.Generator],
    ctx,
) -> Tuple[TrainState, EpochResult]:
    idx, valid, counts = _epoch_indices(data.train_pool, order, batch_size, data.xs[0].device)
    state.module.train()
    state, metrics = runner.train_epoch(state, data.xs, data.ys, idx, valid, counts,
                                        generator, ctx)
    return state, _aggregate(_to_host(metrics, ("losses", "correct", "n")))


def run_eval_epoch(
    runner: EpochRunner,
    state: TrainState,
    data: DeviceFoldData,
    batch_size: int,
    generator: Optional[torch.Generator],
    ctx,
    mask: Optional[Sequence[bool]] = None,
) -> EpochResult:
    order = np.arange(len(data.eval_pool))
    idx, valid, counts = _epoch_indices(data.eval_pool, order, batch_size,
                                        data.eval_xs[0].device)
    if mask is None:
        mask = [True] * len(data.eval_xs)
    outs = runner.eval_epoch(state.module, data.eval_xs, data.eval_ys, idx, valid, counts,
                             generator, ctx, state.epoch, mask)
    host = _to_host(outs, ("losses", "correct", "n", "ens_correct"))
    res = _aggregate(host)
    res.ens_acc = float(host["ens_correct"].sum() / max(1.0, host["n"].sum()) * 100.0)
    return res


def init_train_state(
    model: nn.Module,
    make_optimizer: Callable[[Any], torch.optim.Optimizer],
    mtl_method,
    device,
) -> Tuple[TrainState, Optional[FlatPartition]]:
    """Move ``model`` (already initialised by its generator) to ``device``
    and build its optimizer, MTL state and flat partition."""
    model = model.to(device)
    optimizer = make_optimizer(model.parameters())
    mtl_state = mtl_method.init_state() if mtl_method is not None else {}
    partition = None
    if mtl_method is not None:
        partition = build_flat_partition(model, model.shared_modules, model.task_modules)
    return TrainState(module=model, optimizer=optimizer, mtl_state=mtl_state, epoch=0), partition


class EarlyStopper:
    """Best-metric tracking with patience (reference fbg_fog_train.py:297-361,
    weargait_train.py:567-610)."""

    def __init__(self, patience: int):
        self.patience = patience
        self.best = 0.0
        self.no_improve = 0

    def update(self, metric: float) -> bool:
        """Returns True if improved; sets .stop when patience exhausted."""
        if metric > self.best:
            self.best = metric
            self.no_improve = 0
            return True
        self.no_improve += 1
        return False

    @property
    def stop(self) -> bool:
        return self.no_improve >= self.patience
