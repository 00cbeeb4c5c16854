"""Train and eval steps for N-stream multitask models.
Port of gaitpd/train/step.py:33-377.

* The loss (ce / class_wt / ldam / gcl) is set by ``StepSettings``; the
  per-fold class statistics (margins, weights) are tensors in ``ctx``, and
  the DRW switch is a comparison with the host-side epoch.
* Multitask weighting goes through gaitpd_torch.learning.mtl: one forward,
  K per-task backward passes, the method's combine (a solver kernel for
  CAGrad, MGDA, FairGrad and NashMTL), then the optimizer.
* Relaxed-input training: with ``augment`` each input stream is augmented
  (gaitpd_torch.data.augment; the strengths ride in ``ctx[0]["aug"]``), then
  with ``modality_dropout`` p each stream is zero-filled with probability
  p, one draw a stream a batch; when every stream is dropped, one chosen
  uniformly is kept. Both stay on the device, with no host
  synchronisation.
* The relaxed-input eval zero-fills the disabled streams and ensembles only
  the enabled heads, for any of the 7 WearGait subsets.
* The forward goes through apply adapters (``make_apply_adapters``): the
  train forward of a model with dropout gets ``train=True`` and the step's
  generator, the eval forward never drops.

Randomness. A train step draws from its one ``torch.Generator`` in this
order: the augmentation (stream by stream: gate, channel, noise), the
modality dropout (keep, forced), the forward's dropout, the GCL noise, then
the MTL methods that draw (RLW, PCGrad, GradDrop). The draws happen once a
step: ``mtl_grads`` calls the loss once, so all K per-task backward passes
see the same augmented inputs.

The two-stream consistency term: in synchronized GCL mode with two heads
(the FBG/FoG model), ``0.5 * consistency_lambda`` times the symmetric KL
between the heads' predictions is added to each branch loss
(gaitpd/train/step.py:233-243). It couples the heads, so each task pass of
``mtl_grads`` reaches both streams: both halves of the backbone's
cotangent are live, where without it (async mode) each task's rows of the
other stream are zero.

Batches carry a ``valid`` mask, so padded batches are exact, and
``n_valid``, its count on the host: a fully padded batch is a no-op decided
without waiting for the device.

Rematerialisation (``remat``, gaitpd_torch/runtime/remat.py): only the
train forward (``train_apply``) is recomputed, as in gaitpd; the
augmentation, modality dropout and the losses run once.

Data parallelism (``make_train_step``'s ``sharding``, gaitpd_torch/runtime/
mesh.py): every rank gets the global batch, takes its contiguous rows and
ends the step with the single-process step's parameters, up to the order of
f32 summation. The loss normalisers are summed over the mesh before the
division (gaitpd_torch.learning.losses.sharded_batch), then the per-task
matrix J and the losses (or, without a method, the gradients) and the
metrics; the method combines the global J on every rank. The per-row draws
(augmentation, dropout, GCL noise) are made at the global batch's shape and
sliced (``RowShard``); modality dropout and the methods' draws are made
whole, from the same generator on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from gaitpd_torch.data.augment import augment_stream
from gaitpd_torch.learning import losses as L
from gaitpd_torch.learning.mtl import FlatPartition, mtl_grads
from gaitpd_torch.runtime import fold_draws
from gaitpd_torch.runtime.fold_draws import RowShard
from gaitpd_torch.runtime.remat import REMAT_POLICIES, rematerialise

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
    consistency_lambda: float = 0.0  # > 0 adds the symmetric KL in sync GCL mode
    private_grads: str = "sum"  # see gaitpd_torch.learning.mtl.mtl_grads
    loss_reduction: str = "mean"  # combined scalar without MTL: mean|sum
    dropout: bool = False  # the train forward gets train=True and the step's generator
    # relaxed-input training: zero-fill each input stream with this
    # probability, one draw a stream a batch; one stream always stays on
    modality_dropout: float = 0.0
    # rematerialisation of the train forward in the K per-task backward
    # passes: "none" keeps its activations, "dots" keeps the products'
    # outputs and recomputes the elementwise ops, "nothing" recomputes the
    # whole forward in each pass (gaitpd_torch/runtime/remat.py)
    remat: str = "none"  # none | dots | nothing
    # one AugmentSpec (or None) per input stream; the strengths are tensors
    # in ctx[0]["aug"] (make_loss_ctx's aug_params)
    augment: Optional[Tuple[Any, ...]] = None

    def __post_init__(self):
        if self.wm not in WEIGHTING_MODES:
            raise ValueError(f"wm must be one of {WEIGHTING_MODES}, got {self.wm!r}")
        if self.remat not in REMAT_POLICIES:
            raise ValueError(f"remat must be one of {REMAT_POLICIES}, got {self.remat!r}")


# train_apply(module, xs, generator, epoch) and eval_apply(module, xs, epoch)
# -> the model's output: logits, or a tuple of them, one a head
TrainApply = Callable[[nn.Module, Tuple[torch.Tensor, ...], Optional[torch.Generator], int], Any]
EvalApply = Callable[[nn.Module, Tuple[torch.Tensor, ...], int], Any]


def make_apply_adapters(settings: StepSettings) -> Tuple[TrainApply, EvalApply]:
    """The standard adapters (gaitpd/train/step.py:84-101): with
    ``settings.dropout`` the train forward is ``module(*xs, train=True,
    generator=generator)`` and the eval forward ``module(*xs, train=False)``;
    otherwise both are ``module(*xs)``."""
    if settings.dropout:
        def train_apply(module, xs, generator, epoch):
            return module(*xs, train=True, generator=generator)

        def eval_apply(module, xs, epoch):
            return module(*xs, train=False)
    else:
        def train_apply(module, xs, generator, epoch):
            return module(*xs)

        def eval_apply(module, xs, epoch):
            return module(*xs)

    return train_apply, eval_apply


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
    # m and s: the settings', or the context's gcl_m_scale and gcl_s_scale
    # where it has them (gaitpd/train/step.py:126-134): an HP grid's
    # instances each carry their own (gaitpd_torch/train/hp_search.py)
    return L.gcl_loss(logits, labels, ctx["gcl_m"], generator,
                      m=ctx.get("gcl_m_scale", settings.gcl_m),
                      s=ctx.get("gcl_s_scale", settings.gcl_s), noise_mul=settings.noise_mul,
                      weight=ctx["drw_w"], valid=valid)


def make_loss_ctx(
    settings: StepSettings,
    counts: Sequence[Sequence[int]],
    device=None,
    aug_params: Optional[Sequence[Dict[str, torch.Tensor]]] = None,
    ldam_max_m: float = 0.5,
) -> Tuple[Dict[str, torch.Tensor], ...]:
    """Per-stream loss-context tensors from training class counts. The DRW
    weights (``drw_base``) replace ones once the epoch reaches
    ``drw_warmup`` (reference train/utilities.py:197-202); the LDAM margins
    top out at ``ldam_max_m``.

    aug_params: one dict of augmentation strengths per input stream
    (gaitpd_torch.data.augment.make_aug_params), moved to ``device`` into
    ``ctx[0]["aug"]``."""
    out = []
    for c in counts:
        out.append({
            "cls_w": L.inv_freq_weights(c).to(device),
            "ldam_m": L.ldam_margins(c, max_m=ldam_max_m).to(device),
            "gcl_m": L.gcl_margins(c).to(device),
            "drw_base": L.inv_freq_weights(c).to(device),
        })
    if aug_params is not None:
        out[0]["aug"] = tuple({k: torch.as_tensor(v, dtype=torch.float32).to(device)
                               for k, v in p.items()} for p in aug_params)
    return tuple(out)


def _resolve_drw(settings: StepSettings, ctx, epoch: int):
    """Apply the DRW schedule: ones before warmup, inv-freq after."""
    resolved = []
    for c in ctx:
        drw = c["drw_base"] if epoch >= settings.drw_warmup else torch.ones_like(c["drw_base"])
        resolved.append({**c, "drw_w": drw})
    return tuple(resolved)


def draw_modality_dropout(n_in: int, p: float, generator: torch.Generator,
                          device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Modality dropout's draws, in this order: ``keep`` (n_in,) bool, each
    True with probability 1 - p, and ``forced`` () int64 uniform in
    [0, n_in), the stream kept when ``keep`` has none."""
    if generator is None:
        raise ValueError("modality dropout draws from the step's generator: pass one")
    keep = fold_draws.rand((n_in,), generator, device=device) < 1.0 - p
    forced = fold_draws.randint(0, n_in, (), generator, device=device)
    return keep, forced


def modality_dropout(xs: Sequence[torch.Tensor], keep: torch.Tensor,
                     forced: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Zero-fill the streams ``keep`` drops; if it drops all, keep stream
    ``forced`` alone (gaitpd/train/step.py:213-223). ``keep.any()`` stays a
    tensor: no host synchronisation."""
    n_in = len(xs)
    forced_mask = torch.arange(n_in, device=keep.device) == forced
    keep = torch.where(keep.any(), keep, forced_mask)
    return tuple(torch.where(keep[i], x, torch.zeros_like(x)) for i, x in enumerate(xs))


def make_multitask_loss_fn(settings: StepSettings,
                           train_apply: Optional[TrainApply] = None) -> Callable:
    """loss_fn(module, xs, ys, valid, ctx, generator, epoch) -> ((K,) losses,
    logits tuple). The inputs are augmented, then dropped by modality, as
    the settings ask; the forward is ``train_apply`` (default: the standard
    adapter)."""
    if train_apply is None:
        train_apply = make_apply_adapters(settings)[0]
    train_apply = rematerialise(train_apply, settings.remat)

    def loss_fn(module, xs, ys, valid, ctx, generator, epoch):
        if settings.augment is not None:
            xs = tuple(x if spec is None else augment_stream(x, generator, spec, params)
                       for x, spec, params in zip(xs, settings.augment, ctx[0]["aug"]))
        if settings.modality_dropout > 0:
            xs = modality_dropout(xs, *draw_modality_dropout(
                len(xs), settings.modality_dropout, whole(generator), xs[0].device))
        logits = train_apply(module, xs, generator, epoch)
        if not isinstance(logits, (tuple, list)):
            logits = (logits,)
        ctx_r = _resolve_drw(settings, ctx, epoch)
        ls = [
            branch_loss(settings, logits[k], ys[k], ctx_r[k], generator, valid)
            for k in range(settings.n_streams)
        ]
        if (settings.synchronized and settings.consistency_lambda > 0
                and settings.n_streams == 2 and settings.wm == "gcl"):
            # symmetric-KL prediction consistency, half to each branch
            # (reference train/fbg_fog_train.py:80-89,121-124)
            cons = L.symmetric_kl_consistency(logits[0], logits[1], valid)
            ls = [l + 0.5 * settings.consistency_lambda * cons for l in ls]
        return torch.stack(ls), tuple(logits)

    return loss_fn


def whole(generator):
    """The generator of a step's draws that are not per row: a ``RowShard``'s
    own, else ``generator``."""
    return generator.generator if isinstance(generator, RowShard) else generator


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


def _sum_grads(grads, params, total):
    """``total`` of every gradient, in one collective over their
    concatenation."""
    flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                      for g, p in zip(grads, params)])
    return list(total(flat).split([p.numel() for p in params]))


def make_train_step(settings: StepSettings, mtl_method=None,
                    partition: Optional[FlatPartition] = None,
                    train_apply: Optional[TrainApply] = None, sharding=None) -> Callable:
    """train_step(state, batch, generator, ctx) -> (state, metrics).

    Without ``mtl_method`` the gradient is that of the mean (or sum, per
    ``loss_reduction``) of the branch losses; otherwise it comes from
    gaitpd_torch.learning.mtl.mtl_grads. A parameter the forward does not
    reach gets a zero gradient, so weight decay still moves it. A fully
    padded batch (quantized epoch tails) leaves parameters, momentum and MTL
    state unchanged.

    ``sharding``: a gaitpd_torch.runtime.mesh.BatchSharding; the step is
    then data-parallel (module docstring): ``batch`` is the global batch on
    every rank, and ``generator`` is seeded alike on every rank. The metrics
    are the global batch's."""
    loss_fn = make_multitask_loss_fn(settings, train_apply)
    reduce = torch.mean if settings.loss_reduction == "mean" else torch.sum
    total = None if sharding is None else sharding.sum

    def train_step(state: TrainState, batch, generator, ctx):
        xs, ys, valid = batch["xs"], batch["ys"], batch["valid"]
        if batch["n_valid"] == 0:
            return state, _padded_metrics(settings, valid.device)
        draws = generator
        if sharding is not None:
            xs, ys, valid = (tuple(sharding.rows(x) for x in xs),
                             tuple(sharding.rows(y) for y in ys), sharding.rows(valid))
            draws = RowShard(generator, sharding.count, sharding.index)
        module = state.module
        named = list(module.named_parameters())
        params = [p for _, p in named]
        with (contextlib.nullcontext() if total is None else L.sharded_batch(total)):
            if mtl_method is None:
                ls, logits = loss_fn(module, xs, ys, valid, ctx, draws, state.epoch)
                grads = torch.autograd.grad(reduce(ls), params, allow_unused=True)
                ls = ls.detach()
                if total is not None:
                    grads, ls = _sum_grads(grads, params, total), total(ls)
            else:
                if partition is None or partition.names != tuple(n for n, _ in named):
                    raise ValueError("the flat partition does not describe this module")
                grads, ls, logits, state.mtl_state, _info = mtl_grads(
                    mtl_method,
                    lambda: loss_fn(module, xs, ys, valid, ctx, draws, state.epoch),
                    params,
                    partition,
                    state.mtl_state,
                    private_grads=settings.private_grads,
                    generator=generator,
                    total=total,
                )
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        state.optimizer.step()
        metrics = _batch_metrics([lg.detach() for lg in logits], ys, valid, ls)
        if total is not None:
            metrics.update(correct=total(metrics["correct"]), n=total(metrics["n"]))
        return state, metrics

    return train_step


def make_eval_step(settings: StepSettings, eval_apply: Optional[EvalApply] = None) -> Callable:
    """Masked relaxed-input eval step; the forward is ``eval_apply``
    (default: the standard adapter).

    ``mask``: one bool per model input, on the host. Disabled streams are
    zero-filled before the forward pass (the model still runs every branch,
    reference weargait_train.py:355-382) and their heads are left out of the
    softmax ensemble (weargait_train.py:397-415): summing only the enabled
    heads gives the same floats as the reference's sum of 0/1-weighted heads.
    Returns per-stream losses and correct counts, the ensemble's correct
    count, n, and the predictions."""

    if eval_apply is None:
        eval_apply = make_apply_adapters(settings)[1]

    @torch.no_grad()
    def eval_step(module, batch, ctx, generator, epoch, mask):
        mask = [bool(m) for m in mask]
        xs = tuple(x if mask[k] else torch.zeros_like(x) for k, x in enumerate(batch["xs"]))
        ys, valid = batch["ys"], batch["valid"]
        logits = eval_apply(module, xs, epoch)
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
