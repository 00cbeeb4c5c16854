"""Optimizer construction. Port of gaitpd/train/optim.py:16-39.

torch.optim.SGD(lr, momentum=0.9, weight_decay=1e-4) is what the reference
trains with (train/weargait_train.py:560); gaitpd decomposes it into
the equivalent optax chain (grad += wd * p, buf = mu * buf + grad,
p -= lr * buf), whose first momentum buffer is the gradient itself, as
torch's.

``adam_torch`` and ``adamw_torch`` are the FBG/FoG baseline drivers'
optimizers (gaitpd_torch.train.baseline_drivers): optax's
``chain(clip_by_global_norm(grad_clip), adam | adamw)``. The clip is optax's
law, not torch's ``clip_grad_norm_``: below the bound the gradient is
unchanged, at or above it every leaf becomes (g / ‖g‖) · bound, with ‖g‖
the norm over all leaves; a ``torch.where`` on the device, so no step waits
for the host. AdamW decays every parameter, as optax's does without a mask:
p -= lr · (adam + wd · p), which is torch's p · (1 - lr · wd) - lr · adam.
The moments and the update are torch's; the bias corrections are computed
on the host from torch's CPU step count, in double, where optax's are f32 on
the device: a step from equal parameters and gradients agrees with
optax's within two f32 ulps of the largest parameter, 2.4e-7 of it
(tests/test_torch_fbg_fog_baselines.py).

``FoldAdam`` is both for the stacked cross-validation
(gaitpd_torch/train/vmap_cv.py), whose leaves carry a leading fold axis:
gaitpd vmaps the optax update over the folds, so each fold keeps its own
state. Each fold has its own step count, kept on the host from the host's
mask of the folds that step, and each fold's bias corrections are computed
there in double for a whole epoch at once (``plan``: one copy to the device
an epoch, none a step); the clip takes ‖g‖ over each fold's slice of every
leaf; a fold that does not step keeps its parameters, moments and count
bitwise. SGD needs none of this: its update is elementwise and stateless
but for the momentum, so one ``torch.optim.SGD`` over the stacked leaves
updates each fold as its own would.

``FoldSGD`` is SGD with an lr for each instance of stacked leaves, an (F,)
tensor on the device: an HP grid's lr axis (gaitpd_torch/train/
hp_search.py; gaitpd injects each instance's lr into its optax state).
torch's law, g += wd·p, buf = μ·buf + g (the first buf = g), then
p += (-lr_f)·buf as one ``addcmul_``, which rounds once as torch's
``add_(buf, alpha=-lr)`` does: each instance's bits equal its own
``sgd_torch`` step on the CPU (tests/test_torch_hp_search.py). Its state is
torch's ``momentum_buffer``, so the stacked step's pick of an idle fold
(gaitpd_torch/train/vmap_cv.py) holds for it as for SGD.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np
import torch


def sgd_torch(params: Iterable[torch.nn.Parameter], lr: float, momentum: float = 0.9,
              weight_decay: float = 1e-4) -> torch.optim.SGD:
    return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay,
                           nesterov=False)


class FoldSGD(torch.optim.Optimizer):
    """``sgd_torch`` for each instance of stacked leaves, each (F, *shape),
    instance f at ``lr[f]``: ``lr`` an (F,) f32 tensor on the leaves'
    device; momentum and weight decay shared."""

    def __init__(self, params: Iterable[torch.Tensor], lr: torch.Tensor, momentum: float = 0.9,
                 weight_decay: float = 1e-4):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self) -> None:
        group = self.param_groups[0]
        neg_lr = -group["lr"]
        mu, wd = group["momentum"], group["weight_decay"]
        for p in group["params"]:
            if p.grad is None:
                continue
            g = p.grad.add(p, alpha=wd) if wd != 0 else p.grad
            state = self.state[p]
            buf = state.get("momentum_buffer")
            if buf is None:
                buf = state["momentum_buffer"] = torch.clone(g).detach()
            else:
                buf.mul_(mu).add_(g)
            p.addcmul_(buf, neg_lr.reshape((-1,) + (1,) * (p.dim() - 1)))


@torch.no_grad()
def clip_by_global_norm_(grads: Iterable[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: ‖g‖ = sqrt(sum of every leaf's
    sum of squares); each leaf is kept where ‖g‖ < max_norm, else replaced
    by (g / ‖g‖) * max_norm."""
    grads = list(grads)
    if not grads:
        return
    norm = torch.stack([torch.sum(g * g) for g in grads]).sum().sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


def _clip_before_step(opt: torch.optim.Optimizer, grad_clip: float) -> torch.optim.Optimizer:
    """Clips ``opt``'s gradients by their global norm before each update,
    when ``grad_clip`` > 0."""
    if grad_clip > 0:
        opt.register_step_pre_hook(lambda o, args, kwargs: clip_by_global_norm_(
            (p.grad for group in o.param_groups for p in group["params"]
             if p.grad is not None), grad_clip))
    return opt


def adamw_torch(params: Iterable[torch.nn.Parameter], lr: float, weight_decay: float = 1e-2,
                grad_clip: float = 0.0) -> torch.optim.AdamW:
    """optax.chain(clip_by_global_norm(grad_clip) if grad_clip, adamw(lr,
    0.9, 0.999, 1e-8, weight_decay)) (gaitpd/train/optim.py:26-31)."""
    return _clip_before_step(torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                               weight_decay=weight_decay), grad_clip)


def adam_torch(params: Iterable[torch.nn.Parameter], lr: float,
               grad_clip: float = 0.0) -> torch.optim.Adam:
    """optax.chain(clip_by_global_norm(grad_clip) if grad_clip, adam(lr, 0.9,
    0.999, 1e-8)) (gaitpd/train/optim.py:34-39)."""
    return _clip_before_step(torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8),
                             grad_clip)


class FoldAdam(torch.optim.Optimizer):
    """``adam_torch`` (``weight_decay`` 0) or ``adamw_torch`` for each fold of
    fold-stacked leaves, each (F, *shape): per fold, optax's
    chain(clip_by_global_norm(grad_clip) if grad_clip, adam | adamw(lr,
    0.9, 0.999, 1e-8, weight_decay)), with torch's moment updates. Each
    fold's step count lives in the param group (``fold_steps``), so
    ``state_dict`` carries it."""

    def __init__(self, params: Iterable[torch.Tensor], n_folds: int, lr: float,
                 weight_decay: float = 0.0, grad_clip: float = 0.0,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                      grad_clip=grad_clip, fold_steps=[0] * n_folds))

    @property
    def fold_steps(self) -> list:
        return list(self.param_groups[0]["fold_steps"])

    def plan(self, stepped: np.ndarray) -> torch.Tensor:
        """The bias corrections of the steps to come: ``stepped`` (F, n_b),
        host bools of the folds that step in each batch -> (n_b, 2, F) f32 on
        the leaves' device, row b holding each fold's -lr / (1 - b1^t) and
        sqrt(1 - b2^t) at the count t it reaches in batch b (computed in
        double, as torch's Adam does on the host)."""
        group = self.param_groups[0]
        b1, b2 = group["betas"]
        t = np.maximum(1, np.asarray(group["fold_steps"])[:, None]
                       + np.cumsum(np.asarray(stepped, bool), axis=1))
        table = np.stack([-group["lr"] / (1.0 - b1 ** t), np.sqrt(1.0 - b2 ** t)])
        device = group["params"][0].device
        return torch.from_numpy(table.transpose(2, 0, 1).astype(np.float32)).to(device)

    @torch.no_grad()
    def step(self, stepped: Sequence[bool], stepped_mask: Optional[torch.Tensor] = None,
             factors: Optional[torch.Tensor] = None) -> None:
        """Update every fold from the leaves' ``.grad``. ``stepped``: host
        bools, the folds that step; the others keep their leaves, moments
        and counts bitwise. ``stepped_mask``: the same on the device, and
        ``factors``: this step's row of ``plan`` (default: each built here,
        one copy each)."""
        group = self.param_groups[0]
        stepped = [bool(s) for s in stepped]
        b1, b2 = group["betas"]
        lr, eps, wd, clip = group["lr"], group["eps"], group["weight_decay"], group["grad_clip"]
        params = group["params"]
        n = len(stepped)
        if factors is None:
            factors = self.plan(np.asarray(stepped)[:, None])[0]
        if stepped_mask is None:
            stepped_mask = torch.tensor(stepped, device=params[0].device)

        def per_fold(v, like):
            return v.reshape((n,) + (1,) * (like.dim() - 1))

        grads = [p.grad for p in params]
        if clip > 0:  # optax's law, ‖g‖ over each fold's slice of every leaf
            norm = torch.stack([(g * g).reshape(n, -1).sum(1) for g in grads]).sum(0).sqrt()
            keep = norm < clip
            grads = [torch.where(per_fold(keep, g), g, (g / per_fold(norm, g)) * clip)
                     for g in grads]
        for p, g in zip(params, grads):
            state = self.state[p]
            if not state:
                state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            m, v = state["exp_avg"], state["exp_avg_sq"]
            new_p = p.mul(1 - lr * wd) if wd != 0 else p
            new_m = m.lerp(g, 1 - b1)
            new_v = v.mul(b2).addcmul_(g, g, value=1 - b2)
            denom = (new_v.sqrt() / per_fold(factors[1], p)).add_(eps)
            new_p = new_p + new_m / denom * per_fold(factors[0], p)
            if not all(stepped):
                on = per_fold(stepped_mask, p)
                new_p, new_m, new_v = (torch.where(on, a, b) for a, b in
                                       ((new_p, p), (new_m, m), (new_v, v)))
            p.copy_(new_p)
            m.copy_(new_m)
            v.copy_(new_v)
        group["fold_steps"] = [c + s for c, s in zip(group["fold_steps"], stepped)]
