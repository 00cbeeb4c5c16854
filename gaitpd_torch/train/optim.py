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
"""

from __future__ import annotations

from typing import Iterable

import torch


def sgd_torch(params: Iterable[torch.nn.Parameter], lr: float, momentum: float = 0.9,
              weight_decay: float = 1e-4) -> torch.optim.SGD:
    return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay,
                           nesterov=False)


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
