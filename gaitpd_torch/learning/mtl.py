"""Multitask gradient weighting over a per-task gradient matrix: CAGrad.
Port of gaitpd/learning/mtl.py:48-139,389-428,493-568.

The caller computes per-task gradients once: one forward, then K
``torch.autograd.grad`` passes over the same graph (the reference's K
``backward(retain_graph=True)`` calls, multitask_weighting.py:680-688).
Gradients are flattened to a (K, P) matrix J in ``named_parameters()``
order; shared and task-private parameters are flat masks built from the
model's top-level module names. The CAGrad dual weights come from one launch
of the solver kernel (gaitpd_torch/ops/cagrad_solver.py) on the card, so a
step needs no host synchronisation.

The flat order differs from JAX's ``ravel_pytree``; nothing depends on it:
the Gram matrix, the clip norm and the elementwise select below do not
change under a permutation of columns.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
from torch import nn

from gaitpd_torch.ops.cagrad_solver import cagrad_c_coef, cagrad_solve

EPS = 1e-8

# The other methods of gaitpd/learning/mtl.py:141-490, not ported yet.
NOT_PORTED = (
    "stl", "ls", "uw", "scaleinvls", "rlw", "dwa", "pcgrad", "mgda", "graddrop",
    "log_mgda", "imtl", "log_imtl", "nashmtl", "famo", "fairgrad",
)


# ---------------------------------------------------------------------------
# Flat partition of the parameter vector
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FlatPartition:
    """Flat views of the model's parameter partition, in the order of
    ``names`` (the module's ``named_parameters()``).

    shared: (P,) bool — elements of parameters under shared modules;
    task_id: (P,) int64 — owning task of private elements, -1 for shared.
    """

    shared: torch.Tensor
    task_id: torch.Tensor
    n_tasks: int
    names: Tuple[str, ...]
    shapes: Tuple[torch.Size, ...]

    def unravel(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """(P,) -> one tensor per parameter, shaped as the parameter."""
        sizes = [int(torch.Size(s).numel()) for s in self.shapes]
        return [p.reshape(s) for p, s in zip(flat.split(sizes), self.shapes)]


def build_flat_partition(
    module: nn.Module, shared_modules: Sequence[str], task_modules: Sequence[Sequence[str]]
) -> FlatPartition:
    """The flat partition from the top-level module names of ``module``'s
    parameters (``backbone.Conv1dSame_0.weight`` belongs to ``backbone``)."""
    named = list(module.named_parameters())
    device = named[0][1].device if named else None
    shared, task_id = [], []
    for name, p in named:
        top = name.split(".")[0]
        n = p.numel()
        shared.append(torch.full((n,), top in shared_modules, dtype=torch.bool))
        owner = next((t for t, grp in enumerate(task_modules) if top in grp), -1)
        task_id.append(torch.full((n,), owner, dtype=torch.int64))
    return FlatPartition(
        shared=torch.cat(shared).to(device),
        task_id=torch.cat(task_id).to(device),
        n_tasks=len(task_modules),
        names=tuple(name for name, _ in named),
        shapes=tuple(p.shape for _, p in named),
    )


def per_task_grad_matrix(
    loss_fn: Callable, params: Sequence[torch.Tensor], *args
) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """(J, losses, aux): J is the (K, P) per-task gradient matrix of
    ``loss_fn(*args) -> ((K,) losses, aux)`` with respect to ``params``.

    One forward, then K ``autograd.grad`` passes over its graph; a parameter
    that a task's loss does not reach gets a zero row segment."""
    losses, aux = loss_fn(*args)
    k = losses.shape[0]
    rows = []
    for i in range(k):
        grads = torch.autograd.grad(losses[i], params, retain_graph=i < k - 1,
                                    allow_unused=True)
        rows.append(torch.cat([
            (torch.zeros_like(p) if g is None else g).reshape(-1)
            for g, p in zip(grads, params)
        ]))
    return torch.stack(rows), losses.detach(), aux


def _clip_flat(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    """torch.nn.utils.clip_grad_norm_ semantics on a flat vector."""
    norm = torch.linalg.vector_norm(g)
    return g * torch.clamp(max_norm / (norm + 1e-6), max=1.0)


# ---------------------------------------------------------------------------
# Methods
# ---------------------------------------------------------------------------
#
# Each method has init_state() and
#   combine(losses, j_shared, gram, state) -> (shared_flat, private_weights (K,),
#                                              new_state, info)
# ``j_shared`` is J with non-shared columns zeroed; ``gram`` its Gram matrix.


@dataclasses.dataclass(frozen=True)
class _Base:
    n_tasks: int
    max_norm: float = 1.0
    clips: bool = False  # whether clipping has effect (gaitpd/learning/mtl.py:21-25)

    def init_state(self) -> Dict[str, Any]:
        return {}


@dataclasses.dataclass(frozen=True)
class CAGrad(_Base):
    """Conflict-averse gradient descent — the method the reference
    trains with (weargait_train.py:151).

    Per-task grads -> dual weights w on the simplex -> g = ḡ + (c·||ḡ||_G /
    ||g_w||)·g_w, rescaled by 1/(1+c²), scaled by K, then clipped to
    max_norm. Private parameters keep the plain per-task gradient sum."""

    c: float = 0.4
    clips: bool = True
    log_space: bool = False  # LOG_CAGrad (reference :975-1098)

    def combine(self, losses, j_shared, gram, state):
        c = self.c
        if self.log_space:
            inv_l = 1.0 / torch.clamp(losses, min=EPS)
            j_shared = j_shared * inv_l[:, None]
            gram = gram * inv_l[:, None] * inv_l[None, :]
        c_coef = cagrad_c_coef(gram, c)  # c·sqrt(mean(G) + EPS) + EPS
        w = cagrad_solve(gram, c)  # computes the same c_coef on the device
        gw = w @ j_shared
        gw_norm = torch.sqrt(w @ gram @ w + EPS)
        lmbda = c_coef / (gw_norm + EPS)
        g = j_shared.mean(0) + lmbda * gw
        g = g / (1.0 + c**2)
        shared_flat = g * self.n_tasks
        w_priv = (
            1.0 / torch.clamp(losses, min=EPS)
            if self.log_space
            else torch.ones((self.n_tasks,), dtype=losses.dtype, device=losses.device)
        )
        return shared_flat, w_priv, state, {"weights": w, "GTG": gram}


METHODS: Dict[str, Any] = {
    "cagrad": CAGrad,
    "log_cagrad": lambda **kw: CAGrad(log_space=True, **kw),
}


def make_method(name: str, n_tasks: int, **kwargs):
    """Facade mirroring reference WeightMethods (:1318-1339)."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"MTL method {name!r} is not ported yet (ROADMAP Queue 1, item 10); "
            f"the port has {sorted(METHODS)}")
    if name not in METHODS:
        raise ValueError(f"unknown method {name}.")
    return METHODS[name](n_tasks=n_tasks, **kwargs)


# ---------------------------------------------------------------------------
# Top-level entry: losses -> final gradients
# ---------------------------------------------------------------------------


def mtl_grads(
    method,
    loss_fn: Callable,
    params: Sequence[torch.Tensor],
    partition: FlatPartition,
    state,
    *args,
    private_grads: str = "sum",
):
    """The final gradient of each parameter for one multitask step.

    loss_fn(*args) -> ((K,) losses, aux), computed from ``params``.

    private_grads:
      "sum"          — private parameters get Σ_k w_priv_k g_k (FBG/FoG
                       semantics, multitask_weighting.py:680-688);
      "sum_plus_own" — additionally adds each stream's own-task gradient once
                       more (weargait step_cagrad_three semantics,
                       weargait_train.py:217-242).
    Returns (grads, losses, aux, new_state, info); grads is a list in the
    order of ``params``."""
    if private_grads not in ("sum", "sum_plus_own"):
        raise ValueError(f"private_grads must be 'sum' or 'sum_plus_own', got {private_grads!r}")
    jmat, losses, aux = per_task_grad_matrix(loss_fn, params, *args)
    shared = partition.shared
    j_shared = torch.where(shared[None, :], jmat, torch.zeros_like(jmat))
    gram = j_shared @ j_shared.T

    shared_flat, w_priv, new_state, info = method.combine(losses, j_shared, gram, state)
    if method.clips and method.max_norm > 0:
        shared_flat = _clip_flat(shared_flat, method.max_norm)

    priv_flat = w_priv @ jmat
    if private_grads == "sum_plus_own":
        own = torch.zeros_like(priv_flat)
        for t in range(partition.n_tasks):
            own = own + torch.where(partition.task_id == t, jmat[t], torch.zeros_like(own))
        priv_flat = priv_flat + own

    final_flat = torch.where(shared, shared_flat, priv_flat)
    return partition.unravel(final_flat), losses, aux, new_state, info
