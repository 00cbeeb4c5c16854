"""Multitask gradient weighting over a per-task gradient matrix: the 17
methods of gaitpd/learning/mtl.py. Port of gaitpd/learning/mtl.py:48-568.

The caller computes per-task gradients once: one forward, then K
``torch.autograd.grad`` passes over the same graph (the reference's K
``backward(retain_graph=True)`` calls, multitask_weighting.py:680-688).
Gradients are flattened to a (K, P) matrix J in ``named_parameters()``
order; shared and task-private parameters are flat masks built from the
model's top-level module names. The simplex programs of CAGrad, MGDA,
FairGrad and NashMTL are one kernel launch each on the card
(gaitpd_torch/ops/cagrad_solver.py, gaitpd_torch/ops/mtl_solvers.py), and
every state switch is a ``torch.where``, so a step needs no host
synchronisation.

One step is two parts: ``per_task_grad_matrix`` gives J, and
``combine_flat`` turns one fold's J, losses and state into the final flat
gradient and the new state. ``mtl_grads`` calls both; the stacked
cross-validation (gaitpd_torch/train/vmap_cv.py) runs ``combine_flat``
under ``torch.func.vmap`` over the folds, where each solver is one launch
for all of them (gaitpd_torch/ops/solver_folds.py).

Randomness. RLW, PCGrad and GradDrop draw from the step's
``torch.Generator`` (on the device), after the forward and the loss have
drawn theirs (dropout, GCL noise): each draws in ``combine``, which
``combine_flat`` calls after the K backward passes. The draws go through
gaitpd_torch/runtime/fold_draws.py, so that under the vmap each fold draws
from its own generator at the unbatched shape (a ``FoldDraws``), and a
``torch.Generator`` draws as ``torch`` does. Each is split into a draw
and a pure function of the draw (``_rlw_weights``, ``_pcgrad_project``,
``_graddrop_mask``), so that a test can feed gaitpd's own draw to the pure
part. A method that draws raises ValueError without a generator.

State. Uncertainty, DWA, FAMO and NashMTL keep tensors in a dict, built on
the model's device by ``init_state(device)`` and returned anew by each
``combine``.

The flat order differs from JAX's ``ravel_pytree``; nothing depends on it:
the Gram matrix, the clip norm and the elementwise selects below do not
change under a permutation of columns, and GradDrop's draw is one uniform a
column in either order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from gaitpd_torch.ops.cagrad_solver import cagrad_c_coef, cagrad_solve
from gaitpd_torch.ops.mtl_solvers import fairgrad_solve, min_norm_solve, nashmtl_solve
from gaitpd_torch.runtime import fold_draws
from gaitpd_torch.runtime.fold_draws import Generator

EPS = 1e-8


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
# Each method is a frozen dataclass with gaitpd's fields and defaults, and
#   init_state(device) -> dict of tensors
#   combine(losses, j_shared, gram, state, generator=None)
#       -> (shared_flat, private_weights (K,), new_state, info)
# ``j_shared`` is J with non-shared columns zeroed; ``gram`` its Gram matrix.


def _const(like: torch.Tensor, value: float) -> torch.Tensor:
    """A 0-dim tensor on ``like``'s device: dividing by it is an IEEE
    division, where CUDA multiplies by the reciprocal of a Python number."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _ones(like: torch.Tensor, n: int) -> torch.Tensor:
    return torch.ones((n,), dtype=like.dtype, device=like.device)


def _task_weights(values: Optional[Tuple[float, ...]], like: torch.Tensor, n: int) -> torch.Tensor:
    """The (K,) weights ``values`` (ones by default) on ``like``'s device,
    filled there: a copy from the host would synchronise the step."""
    if not values:
        return _ones(like, n)
    return torch.stack([_const(like, float(v)) for v in values])


def _inv_losses(losses: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.clamp(losses, min=EPS)


def _need_generator(generator: Generator, name: str) -> Generator:
    if generator is None:
        raise ValueError(f"{name} draws from the step's generator; got None")
    return generator


@dataclasses.dataclass(frozen=True)
class _Base:
    n_tasks: int
    max_norm: float = 1.0
    clips: bool = False  # whether clipping has effect (gaitpd/learning/mtl.py:21-25)

    def init_state(self, device=None) -> Dict[str, Any]:
        return {}


@dataclasses.dataclass(frozen=True)
class LinearScalarization(_Base):
    """L = Σ w_k l_k (reference multitask_weighting.py:303-322)."""

    task_weights: Optional[Tuple[float, ...]] = None

    def combine(self, losses, j_shared, gram, state, generator=None):
        w = _task_weights(self.task_weights, losses, self.n_tasks)
        return w @ j_shared, w, state, {"weights": w}


@dataclasses.dataclass(frozen=True)
class ScaleInvariantLS(_Base):
    """L = Σ w_k log l_k (reference :325-344)."""

    task_weights: Optional[Tuple[float, ...]] = None

    def combine(self, losses, j_shared, gram, state, generator=None):
        base = _task_weights(self.task_weights, losses, self.n_tasks)
        w = base / torch.clamp(losses, min=EPS)
        return w @ j_shared, w, state, {"weights": base}


@dataclasses.dataclass(frozen=True)
class STL(_Base):
    """Single-task learning (reference :515-528)."""

    main_task: int = 0

    def combine(self, losses, j_shared, gram, state, generator=None):
        # built on the device: writing a Python number into w would copy it
        # from the host and synchronise the step
        tasks = torch.arange(self.n_tasks, device=losses.device)
        w = (tasks == self.main_task).to(losses.dtype)
        return w @ j_shared, w, state, {"weights": w}


def _rlw_weights(draw: torch.Tensor) -> torch.Tensor:
    """RLW's weights from its N(0, 1) draw (K,)."""
    return torch.softmax(draw, dim=-1)


@dataclasses.dataclass(frozen=True)
class RLW(_Base):
    """Random loss weighting, w = softmax(N(0,1)) per step (reference :1101-1112)."""

    def draw(self, losses, generator):
        return fold_draws.randn((self.n_tasks,), _need_generator(generator, "RLW"),
                                dtype=losses.dtype, device=losses.device)

    def combine(self, losses, j_shared, gram, state, generator=None):
        w = _rlw_weights(self.draw(losses, generator))
        return w @ j_shared, w, state, {"weights": w}


@dataclasses.dataclass(frozen=True)
class Uncertainty(_Base):
    """Kendall-Gal uncertainty weighting (reference :531-553). L = Σ 0.5
    (exp(-s_k) l_k + s_k); the log-sigmas are state updated with an internal
    SGD step. The reference's drivers never optimise them, so the default
    lr = 0 keeps them frozen; lr > 0 adapts them."""

    lr: float = 0.0

    def init_state(self, device=None):
        return {"logsigma": torch.zeros((self.n_tasks,), dtype=torch.float32, device=device)}

    def combine(self, losses, j_shared, gram, state, generator=None):
        logs = state["logsigma"]
        w = 0.5 * torch.exp(-logs)
        # d/d s_k [0.5(exp(-s) l + s)] = 0.5 (1 - exp(-s) l)
        gs = 0.5 * (1.0 - torch.exp(-logs) * losses.detach())
        new_state = {"logsigma": logs - self.lr * gs}
        return w @ j_shared, w, new_state, {"weights": torch.exp(-logs)}


@dataclasses.dataclass(frozen=True)
class DynamicWeightAverage(_Base):
    """DWA (reference :1269-1315): weights from the ratio of recent to older
    window-averaged losses; the final loss is (w*l).mean(), so the effective
    per-task weight is w_k / K. The weights switch on once the iteration
    count before this step's increment exceeds the window."""

    iteration_window: int = 25
    temp: float = 2.0

    def init_state(self, device=None):
        return {
            "costs": torch.ones((2 * self.iteration_window, self.n_tasks), dtype=torch.float32,
                                device=device),
            "iter": torch.zeros((), dtype=torch.int32, device=device),
        }

    def combine(self, losses, j_shared, gram, state, generator=None):
        costs = torch.cat([state["costs"][1:], losses.detach()[None, :]], dim=0)
        win = self.iteration_window
        ws = costs[win:].mean(0) / torch.clamp(costs[:win].mean(0), min=EPS)
        ez = torch.exp(ws / _const(ws, self.temp))
        w_new = self.n_tasks * ez / torch.sum(ez)
        w = torch.where(state["iter"] > win, w_new, torch.ones_like(w_new))
        w_eff = w / _const(w, self.n_tasks)  # .mean() reduction
        return w_eff @ j_shared, w_eff, {"costs": costs, "iter": state["iter"] + 1}, {"weights": w}


@dataclasses.dataclass(frozen=True)
class FAMO(_Base):
    """Fast adaptive multitask optimisation (reference :109-147). The logits
    w are adapted from step-to-step loss deltas with an internal Adam whose
    weight decay is coupled into the gradient (torch.optim.Adam's
    weight_decay, :127), folding the reference's separate
    ``update(curr_loss)`` call into the next step's state transition. The
    loss scale 3.0 is the reference's literal, whatever K."""

    gamma: float = 1e-5
    w_lr: float = 0.025

    def init_state(self, device=None):
        def z():
            return torch.zeros((self.n_tasks,), dtype=torch.float32, device=device)

        return {
            "w": z(),
            "m": z(),
            "v": z(),
            "t": torch.zeros((), dtype=torch.int32, device=device),
            "prev_loss": z(),
            "has_prev": torch.zeros((), dtype=torch.bool, device=device),
            "min_losses": z(),
        }

    def _adam_update(self, s, ldet):
        """The deferred update from the previous step's losses."""
        z = torch.softmax(s["w"], dim=-1)
        delta = (torch.log(s["prev_loss"] - s["min_losses"] + EPS)
                 - torch.log(ldet - s["min_losses"] + EPS))
        d = z * (delta - torch.dot(z, delta))  # J_softmax^T delta
        d = d + self.gamma * s["w"]
        t = s["t"] + 1
        m = 0.9 * s["m"] + 0.1 * d
        v = 0.999 * s["v"] + 0.001 * d * d
        tf = t.to(torch.float32)
        mhat = m / (1 - 0.9 ** tf)
        vhat = v / (1 - 0.999 ** tf)
        w = s["w"] - self.w_lr * mhat / (torch.sqrt(vhat) + EPS)
        return w, m, v, t

    def combine(self, losses, j_shared, gram, state, generator=None):
        ldet = losses.detach()
        w_upd, m, v, t = self._adam_update(state, ldet)
        has_prev = state["has_prev"]
        w_logits = torch.where(has_prev, w_upd, state["w"])
        m = torch.where(has_prev, m, state["m"])
        v = torch.where(has_prev, v, state["v"])
        t = torch.where(has_prev, t, state["t"])

        # weighted loss gradient: L = 3 Σ log(D_k) z_k / c
        z = torch.softmax(w_logits, dim=-1)
        d_gap = ldet - state["min_losses"] + EPS
        c = torch.sum(z / d_gap)
        w_eff = 3.0 * z / (c * d_gap)
        new_state = {
            "w": w_logits,
            "m": m,
            "v": v,
            "t": t,
            "prev_loss": ldet,
            "has_prev": torch.ones_like(has_prev),
            "min_losses": state["min_losses"],
        }
        return w_eff @ j_shared, w_eff, new_state, {"weights": z}


@dataclasses.dataclass(frozen=True)
class MGDA(_Base):
    """Min-norm-element weighting (reference :347-427): the Frank-Wolfe
    solver kernel; the solution is scaled by K (:424) and applied to shared
    and private alike through the weighted loss. LOG_MGDA (:506-511) solves
    on the log losses' gradients, L = Σ sol_k log(l_k) / c with
    c = Σ sol_i / l_i, so the private weights are sol_k / (c l_k)."""

    log_space: bool = False

    def combine(self, losses, j_shared, gram, state, generator=None):
        inv_l = _inv_losses(losses)
        if self.log_space:
            j_shared = j_shared * inv_l[:, None]
            gram = gram * inv_l[:, None] * inv_l[None, :]
        sol = min_norm_solve(gram)
        if self.log_space:
            c = torch.clamp(torch.sum(sol * inv_l), min=EPS)
            w_log = sol / c
            return w_log @ j_shared, w_log * inv_l, state, {"weights": sol}
        w_eff = sol * self.n_tasks
        return w_eff @ j_shared, w_eff, state, {"weights": sol}


@dataclasses.dataclass(frozen=True)
class IMTLG(_Base):
    """Impartial MTL, closed-form alpha (reference :1115-1189). The
    (K-1) x (K-1) inverse is ``torch.linalg.inv_ex``, which checks nothing on
    the host."""

    log_space: bool = False

    def combine(self, losses, j_shared, gram, state, generator=None):
        scale = _inv_losses(losses) if self.log_space else torch.ones_like(losses)
        g = j_shared * scale[:, None]
        norms = torch.linalg.vector_norm(g, dim=1, keepdim=True)
        u = g / torch.clamp(norms, min=EPS)
        d = g[0] - g[1:]
        ut = u[0] - u[1:]
        first = g[0] @ ut.T  # (K-1,)
        mat = d @ ut.T  # (K-1, K-1)
        eye = torch.eye(mat.shape[0], dtype=mat.dtype, device=mat.device)
        inv = torch.linalg.inv_ex(mat + EPS * eye).inverse
        alpha_rest = first @ inv
        alpha = torch.cat([(1.0 - alpha_rest.sum())[None], alpha_rest])
        w_eff = alpha * scale
        return w_eff @ j_shared, w_eff, state, {"weights": alpha}


@dataclasses.dataclass(frozen=True)
class NashMTL(_Base):
    """Nash bargaining weights (reference :150-300): α solves G α = 1/α on
    the Gram matrix normalised by its Frobenius norm (the solver kernel),
    taken every ``update_weights_every`` steps; in between the previous α
    stays. The solver runs every step and a ``torch.where`` picks."""

    update_weights_every: int = 1

    def init_state(self, device=None):
        return {
            "prev_alpha": torch.ones((self.n_tasks,), dtype=torch.float32, device=device),
            "step": torch.zeros((), dtype=torch.int32, device=device),
        }

    def combine(self, losses, j_shared, gram, state, generator=None):
        norm_factor = torch.clamp(torch.linalg.matrix_norm(gram), min=EPS)
        alpha_new = nashmtl_solve(gram / norm_factor)
        recompute = (state["step"] % self.update_weights_every) == 0
        alpha = torch.where(recompute, alpha_new, state["prev_alpha"])
        new_state = {"prev_alpha": alpha, "step": state["step"] + 1}
        return alpha @ j_shared, alpha, new_state, {"weights": alpha}


@dataclasses.dataclass(frozen=True)
class CAGrad(_Base):
    """Conflict-averse gradient descent — the method the reference
    trains with (weargait_train.py:151).

    Per-task grads -> dual weights w on the simplex -> g = ḡ + (c·||ḡ||_G /
    ||g_w||)·g_w, rescaled by 1/(1+c²), scaled by K, then clipped to
    max_norm. Private parameters keep the plain per-task gradient sum.
    c is the field, or the state's ``cagrad_c`` (an f32 tensor) where it
    has one, as gaitpd's (gaitpd/learning/mtl.py:407): an HP grid's
    instances each carry their own there (gaitpd_torch/train/hp_search.py)."""

    c: float = 0.4
    clips: bool = True
    log_space: bool = False  # LOG_CAGrad (reference :975-1098)

    def combine(self, losses, j_shared, gram, state, generator=None):
        c = state.get("cagrad_c", self.c)
        if self.log_space:
            inv_l = _inv_losses(losses)
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
        w_priv = _inv_losses(losses) if self.log_space else _ones(losses, self.n_tasks)
        return shared_flat, w_priv, state, {"weights": w, "GTG": gram}


@dataclasses.dataclass(frozen=True)
class FairGrad(_Base):
    """α-fair gradient weights from G w = w^{-1/α} (reference :779-881),
    the solver kernel; the shared gradient is scaled by K and clipped."""

    alpha: float = 1.0
    clips: bool = True

    def combine(self, losses, j_shared, gram, state, generator=None):
        w = fairgrad_solve(gram, self.alpha)
        shared_flat = (w @ j_shared) * self.n_tasks
        return shared_flat, _ones(losses, self.n_tasks), state, {"weights": w, "GTG": gram}


def _pcgrad_project(j_shared: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Each task's row projected off every conflicting row, the rows taken
    in the order ``perm`` (all K, the row itself included), all tasks at
    once: (K, P) -> (K, P)."""
    rows = j_shared.index_select(0, perm)
    pc = j_shared
    for j in range(rows.shape[0]):
        gj = rows[j]
        dot = pc @ gj
        denom = torch.clamp(gj @ gj, min=EPS)
        pc = torch.where((dot < 0)[:, None], pc - (dot / denom)[:, None] * gj[None, :], pc)
    return pc


@dataclasses.dataclass(frozen=True)
class PCGrad(_Base):
    """Project conflicting gradients pairwise (reference :556-650). The task
    order of the projections is a permutation drawn each step (:613);
    private parameters get the plain sum (losses.sum() autograd, :601-608)."""

    reduction: str = "sum"
    clips: bool = True

    def draw(self, losses, generator):
        return fold_draws.randperm(self.n_tasks, _need_generator(generator, "PCGrad"),
                                   device=losses.device)

    def combine(self, losses, j_shared, gram, state, generator=None):
        merged = _pcgrad_project(j_shared, self.draw(losses, generator)).sum(0)
        if self.reduction == "mean":
            merged = merged / _const(merged, self.n_tasks)
        return merged, _ones(losses, self.n_tasks), state, {}


def _graddrop_mask(j_shared: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """GradDrop's keep mask (K, P) from its uniform draw u (P,): a column's
    positive entries are kept where its sign purity p exceeds u, its
    negative ones where p is below."""
    p = 0.5 * (1.0 + j_shared.sum(0) / (j_shared.abs().sum(0) + EPS))
    return ((p > u)[None, :] & (j_shared > 0)) | ((p < u)[None, :] & (j_shared < 0))


@dataclasses.dataclass(frozen=True)
class GradDrop(_Base):
    """Sign-based stochastic gradient masking (reference :884-972): one
    uniform a column, the masked mean scaled by K, clipped."""

    clips: bool = True

    def draw(self, j_shared, generator):
        return fold_draws.rand((j_shared.shape[1],), _need_generator(generator, "GradDrop"),
                               dtype=j_shared.dtype, device=j_shared.device)

    def combine(self, losses, j_shared, gram, state, generator=None):
        mask = _graddrop_mask(j_shared, self.draw(j_shared, generator))
        g = (j_shared * mask).mean(0) * self.n_tasks
        return g, _ones(losses, self.n_tasks), state, {}


METHODS: Dict[str, Any] = {
    "stl": STL,
    "ls": LinearScalarization,
    "uw": Uncertainty,
    "scaleinvls": ScaleInvariantLS,
    "rlw": RLW,
    "dwa": DynamicWeightAverage,
    "pcgrad": PCGrad,
    "mgda": MGDA,
    "graddrop": GradDrop,
    "log_mgda": lambda **kw: MGDA(log_space=True, **kw),
    "cagrad": CAGrad,
    "log_cagrad": lambda **kw: CAGrad(log_space=True, **kw),
    "imtl": IMTLG,
    "log_imtl": lambda **kw: IMTLG(log_space=True, **kw),
    "nashmtl": NashMTL,
    "famo": FAMO,
    "fairgrad": FairGrad,
}


def make_method(name: str, n_tasks: int, **kwargs):
    """Facade mirroring reference WeightMethods (:1318-1339)."""
    if name not in METHODS:
        raise ValueError(f"unknown method {name}.")
    return METHODS[name](n_tasks=n_tasks, **kwargs)


# ---------------------------------------------------------------------------
# Top-level entry: losses -> final gradients
# ---------------------------------------------------------------------------


def combine_flat(
    method,
    jmat: torch.Tensor,
    losses: torch.Tensor,
    partition: FlatPartition,
    state,
    private_grads: str = "sum",
    generator: Generator = None,
):
    """One fold's final flat gradient from its per-task gradient matrix
    ``jmat`` (K, P) and ``losses`` (K,): the method's weighting of the shared
    columns, its clip, and the private columns' rule (see ``mtl_grads``).
    ``generator``: the step's, for the methods that draw; a ``FoldDraws``
    under ``torch.func.vmap`` over the folds.
    Returns (final_flat (P,), new_state, info)."""
    if private_grads not in ("sum", "sum_plus_own"):
        raise ValueError(f"private_grads must be 'sum' or 'sum_plus_own', got {private_grads!r}")
    shared = partition.shared
    j_shared = torch.where(shared[None, :], jmat, torch.zeros_like(jmat))
    gram = j_shared @ j_shared.T

    shared_flat, w_priv, new_state, info = method.combine(losses, j_shared, gram, state,
                                                         generator)
    if method.clips and method.max_norm > 0:
        shared_flat = _clip_flat(shared_flat, method.max_norm)

    priv_flat = w_priv @ jmat
    if private_grads == "sum_plus_own":
        own = torch.zeros_like(priv_flat)
        for t in range(partition.n_tasks):
            own = own + torch.where(partition.task_id == t, jmat[t], torch.zeros_like(own))
        priv_flat = priv_flat + own
    return torch.where(shared, shared_flat, priv_flat), new_state, info


def mtl_grads(
    method,
    loss_fn: Callable,
    params: Sequence[torch.Tensor],
    partition: FlatPartition,
    state,
    *args,
    private_grads: str = "sum",
    generator: Optional[torch.Generator] = None,
    total: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """The final gradient of each parameter for one multitask step.

    loss_fn(*args) -> ((K,) losses, aux), computed from ``params``.
    ``generator``: the step's, for the methods that draw (RLW, PCGrad,
    GradDrop); they draw after ``loss_fn`` has run. ``total``: a
    data-parallel step's sum over the mesh, applied to J and the losses
    before the combine, so that every rank combines the global matrix.

    private_grads:
      "sum"          — private parameters get Σ_k w_priv_k g_k (FBG/FoG
                       semantics, multitask_weighting.py:680-688);
      "sum_plus_own" — additionally adds each stream's own-task gradient once
                       more (weargait step_cagrad_three semantics,
                       weargait_train.py:217-242).
    Returns (grads, losses, aux, new_state, info); grads is a list in the
    order of ``params``."""
    jmat, losses, aux = per_task_grad_matrix(loss_fn, params, *args)
    if total is not None:
        jmat, losses = total(jmat), total(losses)
    final_flat, new_state, info = combine_flat(method, jmat, losses, partition, state,
                                               private_grads, generator)
    return partition.unravel(final_flat), losses, aux, new_state, info
