"""The MGDA, FairGrad and NashMTL solvers as one kernel launch each.

``min_norm_solve(gram)`` returns the MGDA min-norm weights on the simplex,
``fairgrad_solve(gram, alpha)`` the FairGrad weights (G w = w^{-1/alpha})
and ``nashmtl_solve(gram)`` the Nash-MTL weights (G a = 1/a, on the Gram
matrix the caller has normalised), for a (K, K) Gram matrix or a batch
(N, K, K) of them. On a CUDA tensor each launches its entry of the
hand-written kernel gaitpd_torch/csrc/mtl_solvers.cu (one thread per matrix,
in registers; no host synchronisation), counted in its own counter
(``min_norm_launches``, ``fairgrad_launches``, ``nashmtl_launches``); on a
CPU tensor it takes the plain version beside it (``*_reference``), which is
the eager-torch solver of gaitpd_torch.learning.minnorm. Kernel and plain
version run the same IEEE operations in the same order and agree bit for
bit. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from gaitpd_torch.learning.minnorm import fairgrad_weights, min_norm_element, nashmtl_weights

MAX_TASKS = 8  # K is a compile-time constant of the kernel, 1..8

# Kernel launches of each solver; callers may reset them to 0.
min_norm_launches = 0
fairgrad_launches = 0
nashmtl_launches = 0

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
        alpha = [ctypes.c_float] if name == "fairgrad_solver" else []
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       *alpha, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def _check(gram: torch.Tensor, what: str) -> None:
    if gram.dim() not in (2, 3) or gram.shape[-1] != gram.shape[-2]:
        raise ValueError(f"{what}: expected (K, K) or (N, K, K) Gram matrices, "
                         f"got {tuple(gram.shape)}")
    if not 1 <= gram.shape[-1] <= MAX_TASKS:
        raise ValueError(f"{what}: the solver takes 1 <= K <= {MAX_TASKS} tasks, "
                         f"got {gram.shape[-1]}")
    if gram.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {gram.device}")


def _launch(name: str, gram: torch.Tensor, *alpha: float) -> torch.Tensor:
    """One launch of csrc/mtl_solvers.cu's ``name`` on a CUDA tensor."""
    if gram.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, got {gram.dtype}")
    g = gram.detach().contiguous()
    n = 1 if g.dim() == 2 else g.shape[0]
    out = torch.empty(g.shape[:-1], dtype=torch.float32, device=g.device)
    fn = _function(name)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(g.data_ptr(), out.data_ptr(), n, g.shape[-1], *map(float, alpha), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err} "
                           f"(gram {tuple(gram.shape)})")
    return out


def min_norm_solve(gram: torch.Tensor) -> torch.Tensor:
    """gram: (K, K) or (N, K, K) -> w: (K,) or (N, K) on the simplex.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    global min_norm_launches
    _check(gram, "min_norm_solve")
    if gram.device.type == "cpu":
        return min_norm_solve_reference(gram)
    out = _launch("min_norm_solver", gram)
    min_norm_launches += 1
    return out


def fairgrad_solve(gram: torch.Tensor, alpha: float) -> torch.Tensor:
    """gram: (K, K) or (N, K, K), alpha > 0 -> w: (K,) or (N, K), w >= 1e-6.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    global fairgrad_launches
    _check(gram, "fairgrad_solve")
    if gram.device.type == "cpu":
        return fairgrad_solve_reference(gram, alpha)
    out = _launch("fairgrad_solver", gram, alpha)
    fairgrad_launches += 1
    return out


def nashmtl_solve(gram: torch.Tensor) -> torch.Tensor:
    """gram: (K, K) or (N, K, K), normalised -> a: (K,) or (N, K), a >= 1e-6.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    global nashmtl_launches
    _check(gram, "nashmtl_solve")
    if gram.device.type == "cpu":
        return nashmtl_solve_reference(gram)
    out = _launch("nashmtl_solver", gram)
    nashmtl_launches += 1
    return out
