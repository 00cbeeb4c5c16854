"""The MGDA, FairGrad and NashMTL solvers as one kernel launch each.

``min_norm_solve(gram)`` returns the MGDA min-norm weights on the simplex,
``fairgrad_solve(gram, alpha)`` the FairGrad weights (G w = w^{-1/alpha})
and ``nashmtl_solve(gram)`` the Nash-MTL weights (G a = 1/a, on the Gram
matrix the caller has normalised), for a (K, K) Gram matrix or a batch
(N, K, K) of them. On a CUDA tensor each launches its entry of the
hand-written kernel gaitpd_torch/csrc/mtl_solvers.cu (no host
synchronisation), counted in its own counter (``min_norm_launches``,
``fairgrad_launches``, ``nashmtl_launches``), in its default design (MGDA's
one-thread ``thread`` design stays reachable through ``_solve_kernel`` for
comparison on the card): MGDA's Frank-Wolfe (``stop``) one thread a
matrix, the rows of G on the lanes of a warp at K = 7 and 8, ended once a
step leaves w's bits unchanged (its fixed point, so w is the 250-step
result: ``min_norm_element_stop`` is its plain form); FairGrad's and
NashMTL's damped Newton iterations (``warp``) one warp a matrix, the K
tasks' powers or reciprocals and the multipliers below a pivot on lanes of
their own, the rest on every lane alike. On a CPU tensor each takes
the plain version beside it (``*_reference``), the eager-torch solver of
gaitpd_torch.learning.minnorm. Kernel and plain version run the same IEEE
operations on the same operands, in the same order for every entry, and
agree bit for bit. There is no fallback from one to the other. Under
``torch.func.vmap`` the vmap axis joins the batch of matrices
(gaitpd_torch/ops/solver_folds.py): the stacked cross-validation's F folds
are one launch, counted also in ``*_fold_launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gaitpd_torch.learning.minnorm import fairgrad_weights, min_norm_element, nashmtl_weights
from gaitpd_torch.ops.solver_folds import is_batched, solve_folds

MAX_TASKS = 8  # K is a compile-time constant of the kernel, 1..8
MIN_NORM_STEPS = 250  # MGDA's Frank-Wolfe steps, the reference's
# the designs of FairGrad's and NashMTL's solvers and of MGDA's, as
# ``_solve_kernel`` takes them; the public wrappers launch the last
VARIANTS = ("warp",)
MIN_NORM_VARIANTS = ("thread", "stop")
_METHODS = ("min_norm_solver", "fairgrad_solver", "nashmtl_solver")


def designs(name: str) -> tuple:
    """The designs of solver ``name``, the default last."""
    return MIN_NORM_VARIANTS if name == "min_norm_solver" else VARIANTS


def _design_number(name: str, variant: str) -> int:
    """The number csrc/mtl_solvers.cu gives a design of solver ``name``: 1
    the default, 0 MGDA's thread design."""
    found = designs(name)
    if variant not in found:
        raise ValueError(f"{name} has the designs {found}, not {variant!r}")
    return int(variant == found[-1])

# Kernel launches of each solver; callers may reset them to 0. Of those, the
# launches for every entry of a torch.func.vmap (the folds).
min_norm_launches = 0
fairgrad_launches = 0
nashmtl_launches = 0
min_norm_fold_launches = 0
fairgrad_fold_launches = 0
nashmtl_fold_launches = 0

_bound = {}


# the plain versions: the eager-torch solvers, on the same inputs
min_norm_solve_reference = min_norm_element
fairgrad_solve_reference = fairgrad_weights
nashmtl_solve_reference = nashmtl_weights


def _function(name: str):
    fn = _bound.get(name)
    if fn is None:
        from gaitpd_torch.ops import _build

        fn = getattr(_build.load("mtl_solvers"), name)
        alpha = [ctypes.c_float] if name.startswith("fairgrad_solver") else []
        variant = [ctypes.c_int] if name.endswith("_variant") else []
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       *alpha, *variant, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def launch_config(name: str, variant: str, k: int = 3) -> dict:
    """Threads a block and lanes a matrix of a design of solver ``name`` at
    K = k, as the source launches it, the steps between two compares of
    MGDA's stop (0: none, all 250 steps) and whether the compare's verdict
    is read one block later."""
    from gaitpd_torch.ops import _build

    fn = _build.load("mtl_solvers").mtl_solver_launch_config
    threads, lanes, every, lagged = (ctypes.c_int() for _ in range(4))
    err = fn(_METHODS.index(name), _design_number(name, variant), k, ctypes.byref(threads),
             ctypes.byref(lanes), ctypes.byref(every), ctypes.byref(lagged))
    if err != 0:
        raise RuntimeError(f"mtl_solver_launch_config: cudaError_t {err}")
    return {"variant": variant, "k": k, "threads": threads.value,
            "lanes_per_matrix": lanes.value, "stop_every": every.value,
            "stop_lagged": bool(lagged.value)}


def _check(gram: torch.Tensor, what: str) -> None:
    if gram.dim() not in (2, 3) or gram.shape[-1] != gram.shape[-2]:
        raise ValueError(f"{what}: expected (K, K) or (N, K, K) Gram matrices, "
                         f"got {tuple(gram.shape)}")
    if not 1 <= gram.shape[-1] <= MAX_TASKS:
        raise ValueError(f"{what}: the solver takes 1 <= K <= {MAX_TASKS} tasks, "
                         f"got {gram.shape[-1]}")
    if gram.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {gram.device}")


def _launch(name: str, gram: torch.Tensor, *args) -> torch.Tensor:
    """One launch of csrc/mtl_solvers.cu's entry ``name`` on a CUDA tensor;
    ``args`` are the entry's scalars after k (alpha, the design)."""
    if gram.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, got {gram.dtype}")
    g = gram.detach().contiguous()
    n = 1 if g.dim() == 2 else g.shape[0]
    out = torch.empty(g.shape[:-1], dtype=torch.float32, device=g.device)
    fn = _function(name)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(g.data_ptr(), out.data_ptr(), n, g.shape[-1], *args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err} "
                           f"(gram {tuple(gram.shape)})")
    return out


def _solve_kernel(name: str, gram: torch.Tensor, *alpha: float, variant: Optional[str] = None
                  ) -> torch.Tensor:
    """One launch of ``name`` ("min_norm_solver", "fairgrad_solver" or
    "nashmtl_solver") in the design ``variant`` (of ``designs(name)``; the
    default one by default) on a CUDA tensor, counted by no counter: the
    card's comparison of MGDA's two designs."""
    number = 1 if variant is None else _design_number(name, variant)
    _check(gram, name)
    if gram.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes a CUDA tensor, got {gram.device}")
    if number == 1:
        return _launch(name, gram, *map(float, alpha))
    return _launch(f"{name}_variant", gram, number)


def _count_min_norm_fold() -> None:
    global min_norm_fold_launches
    min_norm_fold_launches += 1


def min_norm_solve(gram: torch.Tensor) -> torch.Tensor:
    """gram: (K, K) or (N, K, K) -> w: (K,) or (N, K) on the simplex.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise; under ``torch.func.vmap``, one call for the vmap axis."""
    global min_norm_launches
    _check(gram, "min_norm_solve")
    if is_batched(gram):
        return solve_folds(min_norm_solve, _count_min_norm_fold, gram)
    if gram.device.type == "cpu":
        return min_norm_solve_reference(gram)
    out = _launch("min_norm_solver", gram)
    min_norm_launches += 1
    return out


def _count_fairgrad_fold() -> None:
    global fairgrad_fold_launches
    fairgrad_fold_launches += 1


def fairgrad_solve(gram: torch.Tensor, alpha: float) -> torch.Tensor:
    """gram: (K, K) or (N, K, K), alpha > 0 -> w: (K,) or (N, K), w >= 1e-6.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise; under ``torch.func.vmap``, one call for the vmap axis."""
    global fairgrad_launches
    _check(gram, "fairgrad_solve")
    if is_batched(gram):
        return solve_folds(fairgrad_solve, _count_fairgrad_fold, gram, alpha)
    if gram.device.type == "cpu":
        return fairgrad_solve_reference(gram, alpha)
    out = _launch("fairgrad_solver", gram, float(alpha))
    fairgrad_launches += 1
    return out


def _count_nashmtl_fold() -> None:
    global nashmtl_fold_launches
    nashmtl_fold_launches += 1


def nashmtl_solve(gram: torch.Tensor) -> torch.Tensor:
    """gram: (K, K) or (N, K, K), normalised -> a: (K,) or (N, K), a >= 1e-6.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise; under ``torch.func.vmap``, one call for the vmap axis."""
    global nashmtl_launches
    _check(gram, "nashmtl_solve")
    if is_batched(gram):
        return solve_folds(nashmtl_solve, _count_nashmtl_fold, gram)
    if gram.device.type == "cpu":
        return nashmtl_solve_reference(gram)
    out = _launch("nashmtl_solver", gram)
    nashmtl_launches += 1
    return out
