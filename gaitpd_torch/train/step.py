"""Train and eval steps for N-stream multitask models.
Port of gaitpd/train/step.py:33-377.

* The loss (ce / class_wt / ldam / gcl) is set by ``StepSettings``; the
  per-fold class statistics (margins, weights) are tensors in ``ctx``, and
  the DRW switch is a comparison with the host-side epoch.
* Multitask weighting goes through gaitpd_torch.learning.mtl: one forward,
  K per-task backward passes, the CAGrad solver kernel, then the optimizer.
* The relaxed-input eval zero-fills the disabled streams and ensembles only
  the enabled heads, for any of the 7 WearGait subsets.

Batches carry a ``valid`` mask, so padded batches are exact, and
``n_valid``, its count on the host: a fully padded batch is a no-op decided
without waiting for the device. Options of the reference that the port does
not have yet (augmentation, modality dropout, rematerialisation, dropout,
the two-stream consistency term) raise NotImplementedError when set.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from gaitpd_torch.learning import losses as L
from gaitpd_torch.learning.mtl import FlatPartition, mtl_grads

WEIGHTING_MODES = ("ce", "class_wt", "ldam", "gcl")


@dataclasses.dataclass
class TrainState:
    """The module and its optimizer are updated in place by a train step."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    mtl_state: Dict[str, Any]
    epoch: int = 0  # drives the DRW schedule


@dataclasses.dataclass(frozen=True)
class StepSettings:
    """Configuration of a step (gaitpd/train/step.py:40-81).

    n_streams counts output heads."""

    n_streams: int
    wm: str = "gcl"  # ce | class_wt | ldam | gcl
    synchronized: bool = False
    ldam_s: float = 30.0
    gcl_m: float = 0.2
    gcl_s: float = 25.0
    noise_mul: float = 0.0
    drw_warmup: int = 0
    consistency_lambda: float = 0.0
    private_grads: str = "sum"  # see gaitpd_torch.learning.mtl.mtl_grads
    loss_reduction: str = "mean"  # combined scalar without MTL: mean|sum
    dropout: bool = False
    modality_dropout: float = 0.0
    remat: str = "none"
    augment: Optional[Tuple[Any, ...]] = None

    def __post_init__(self):
        if self.wm not in WEIGHTING_MODES:
            raise ValueError(f"wm must be one of {WEIGHTING_MODES}, got {self.wm!r}")
        if self.consistency_lambda:
            raise NotImplementedError(
                "the symmetric-KL consistency term serves the two-stream FBG/FoG "
                "models, not ported yet (ROADMAP Queue 1, item 11)")
        if self.augment is not None or self.modality_dropout:
            raise NotImplementedError(
                "train-time augmentation and modality dropout are not ported yet "
                "(ROADMAP Queue 1, item 8)")
        if self.remat != "none":
            raise NotImplementedError(
                "rematerialisation policies are not ported yet (ROADMAP Queue 1, item 14)")
        if self.dropout:
            raise NotImplementedError(
                "dropout serves only the DeepAV-Lite and TACA baselines, not ported yet "
                "(ROADMAP Queue 1, item 13)")


def branch_loss(
    settings: StepSettings,
    logits: torch.Tensor,
    labels: torch.Tensor,
    ctx: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator],
    valid: Optional[torch.Tensor],
) -> torch.Tensor:
    """One modality's classification loss (reference
    train/fbg_fog_train.py:97-144, weargait_train.py:111-130)."""
    if settings.wm == "ce":
        return L.cross_entropy(logits, labels, None, valid)
    if settings.wm == "class_wt":
        return L.cross_entropy(logits, labels, ctx["cls_w"], valid)
    if settings.wm == "ldam":
        return L.ldam_loss(logits, labels, ctx["ldam_m"], s=settings.ldam_s,
                           weight=ctx["cls_w"], valid=valid)
    return L.gcl_loss(logits, labels, ctx["gcl_m"], generator, m=settings.gcl_m,
                      s=settings.gcl_s, noise_mul=settings.noise_mul,
                      weight=ctx["drw_w"], valid=valid)


def make_loss_ctx(
    settings: StepSettings,
    counts: Sequence[Sequence[int]],
    device=None,
) -> Tuple[Dict[str, torch.Tensor], ...]:
    """Per-stream loss-context tensors from training class counts. The DRW
    weights (``drw_base``) replace ones once the epoch reaches
    ``drw_warmup`` (reference train/utilities.py:197-202)."""
    out = []
    for c in counts:
        out.append({
            "cls_w": L.inv_freq_weights(c).to(device),
            "ldam_m": L.ldam_margins(c, max_m=0.5).to(device),
            "gcl_m": L.gcl_margins(c).to(device),
            "drw_base": L.inv_freq_weights(c).to(device),
        })
    return tuple(out)


def _resolve_drw(settings: StepSettings, ctx, epoch: int):
    """Apply the DRW schedule: ones before warmup, inv-freq after."""
    resolved = []
    for c in ctx:
        drw = c["drw_base"] if epoch >= settings.drw_warmup else torch.ones_like(c["drw_base"])
        resolved.append({**c, "drw_w": drw})
    return tuple(resolved)


def make_multitask_loss_fn(settings: StepSettings) -> Callable:
    """loss_fn(module, xs, ys, valid, ctx, generator, epoch) -> ((K,) losses,
    logits tuple)."""

    def loss_fn(module, xs, ys, valid, ctx, generator, epoch):
        logits = module(*xs)
        if not isinstance(logits, (tuple, list)):
            logits = (logits,)
        ctx_r = _resolve_drw(settings, ctx, epoch)
        ls = [
            branch_loss(settings, logits[k], ys[k], ctx_r[k], generator, valid)
            for k in range(settings.n_streams)
        ]
        return torch.stack(ls), tuple(logits)

    return loss_fn


def _batch_metrics(logits, ys, valid, losses):
    """Per-stream correct counts and the batch size, on the device
    (reference fbg_fog_train.py:154-156, weargait_train.py:312-317)."""
    v = valid.to(torch.float32)
    corr = [((lg.argmax(-1) == y) * v).sum() for lg, y in zip(logits, ys)]
    return {"losses": losses, "correct": torch.stack(corr), "n": v.sum()}


def _padded_metrics(settings: StepSettings, device) -> Dict[str, torch.Tensor]:
    """What a fully padded batch reports: zero loss, nothing correct, n = 0."""
    zeros = torch.zeros(settings.n_streams, device=device)
    return {"losses": zeros, "correct": zeros.clone(), "n": torch.zeros((), device=device)}


def make_train_step(settings: StepSettings, mtl_method=None,
                    partition: Optional[FlatPartition] = None) -> Callable:
    """train_step(state, batch, generator, ctx) -> (state, metrics).

    Without ``mtl_method`` the gradient is that of the mean (or sum, per
    ``loss_reduction``) of the branch losses; otherwise it comes from
    gaitpd_torch.learning.mtl.mtl_grads. A fully padded batch (quantized
    epoch tails) leaves parameters, momentum and MTL state unchanged."""
    loss_fn = make_multitask_loss_fn(settings)
    reduce = torch.mean if settings.loss_reduction == "mean" else torch.sum

    def train_step(state: TrainState, batch, generator, ctx):
        xs, ys, valid = batch["xs"], batch["ys"], batch["valid"]
        if batch["n_valid"] == 0:
            return state, _padded_metrics(settings, valid.device)
        module = state.module
        named = list(module.named_parameters())
        params = [p for _, p in named]
        if mtl_method is None:
            ls, logits = loss_fn(module, xs, ys, valid, ctx, generator, state.epoch)
            grads = torch.autograd.grad(reduce(ls), params, allow_unused=True)
            ls = ls.detach()
        else:
            if partition is None or partition.names != tuple(n for n, _ in named):
                raise ValueError("the flat partition does not describe this module")
            grads, ls, logits, state.mtl_state, _info = mtl_grads(
                mtl_method,
                lambda: loss_fn(module, xs, ys, valid, ctx, generator, state.epoch),
                params,
                partition,
                state.mtl_state,
                private_grads=settings.private_grads,
            )
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        state.optimizer.step()
        metrics = _batch_metrics([lg.detach() for lg in logits], ys, valid, ls)
        return state, metrics

    return train_step


def make_eval_step(settings: StepSettings) -> Callable:
    """Masked relaxed-input eval step.

    ``mask``: one bool per model input, on the host. Disabled streams are
    zero-filled before the forward pass (the model still runs every branch,
    reference weargait_train.py:355-382) and their heads are left out of the
    softmax ensemble (weargait_train.py:397-415): summing only the enabled
    heads gives the same floats as the reference's sum of 0/1-weighted heads.
    Returns per-stream losses and correct counts, the ensemble's correct
    count, n, and the predictions."""

    @torch.no_grad()
    def eval_step(module, batch, ctx, generator, epoch, mask):
        mask = [bool(m) for m in mask]
        xs = tuple(x if mask[k] else torch.zeros_like(x) for k, x in enumerate(batch["xs"]))
        ys, valid = batch["ys"], batch["valid"]
        logits = module(*xs)
        if not isinstance(logits, (tuple, list)):
            logits = (logits,)
        ctx_r = _resolve_drw(settings, ctx, epoch)
        ls = torch.stack([
            branch_loss(settings, logits[k], ys[k], ctx_r[k], generator, valid)
            for k in range(settings.n_streams)
        ])
        v = valid.to(torch.float32)
        corr = torch.stack([((lg.argmax(-1) == y) * v).sum() for lg, y in zip(logits, ys)])
        on = [torch.softmax(lg, -1) for lg, m in zip(logits, mask) if m]
        if on:
            p_ens = torch.stack(on).sum(0) / float(len(on))
        else:
            p_ens = torch.zeros_like(logits[0])
        pred_ens = p_ens.argmax(-1)
        return {
            "losses": ls,
            "correct": corr,
            "ens_correct": ((pred_ens == ys[0]) * v).sum(),
            "n": v.sum(),
            "preds": torch.stack([lg.argmax(-1) for lg in logits]),
            "pred_ens": pred_ens,
            "logits": torch.stack(logits),
        }

    return eval_step
