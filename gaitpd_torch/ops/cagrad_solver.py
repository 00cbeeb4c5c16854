"""The CAGrad dual solver as one kernel launch.

``cagrad_solve(gram, c)`` returns the CAGrad weights w (K,) for the Gram
matrix of the per-task gradients and the strength c, computing
c_coef = c·sqrt(mean(G) + EPS) + EPS itself (gaitpd/learning/mtl.py:412-413).
On a CUDA tensor it launches the hand-written kernel
gaitpd_torch/csrc/cagrad_solver.cu (one thread per matrix, in registers,
no host synchronisation), counted in ``launches``; on a CPU tensor it takes
the plain version beside it, ``cagrad_solve_reference``, which is
gaitpd_torch.learning.minnorm.cagrad_weights in eager torch ops. The two
run the same IEEE operations in the same order and agree bit for bit.
There is no fallback from one to the other. A batch (N, K, K) of matrices
is solved in one call either way.
"""

from __future__ import annotations

import ctypes

import torch

from gaitpd_torch.learning.minnorm import EPS, cagrad_weights, sum_entries

MAX_TASKS = 8  # K is a compile-time constant of the kernel, 1..8

# Kernel launches made by ``cagrad_solve``; callers may reset it to 0.
launches = 0

_bound = None


def cagrad_c_coef(gram: torch.Tensor, c: float) -> torch.Tensor:
    """c·sqrt(mean(G) + EPS) + EPS per matrix, the mean's sum taken in the
    kernel's order: a scalar for (K, K), (N,) for (N, K, K)."""
    g = gram.reshape((-1,) + tuple(gram.shape[-2:]))
    total = sum_entries(g)
    # a tensor divisor: PyTorch's CUDA division by a Python number multiplies
    # by its reciprocal, which is not the kernel's IEEE division
    coef = c * torch.sqrt(total / torch.full_like(total, float(g.shape[-1] ** 2)) + EPS) + EPS
    return coef.reshape(gram.shape[:-2])


def cagrad_solve_reference(gram: torch.Tensor, c: float) -> torch.Tensor:
    """Plain version: the eager-torch solver on the same inputs."""
    return cagrad_weights(gram, cagrad_c_coef(gram, c))


def _library():
    global _bound
    if _bound is None:
        from gaitpd_torch.ops import _build

        fn = _build.load("cagrad_solver").cagrad_solver
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def cagrad_solve(gram: torch.Tensor, c: float) -> torch.Tensor:
    """gram: (K, K) or (N, K, K) -> w: (K,) or (N, K) on the simplex.

    CPU tensors take ``cagrad_solve_reference``; CUDA tensors launch the
    kernel or raise."""
    global launches
    if gram.dim() not in (2, 3) or gram.shape[-1] != gram.shape[-2]:
        raise ValueError(f"expected (K, K) or (N, K, K) Gram matrices, got {tuple(gram.shape)}")
    k = gram.shape[-1]
    if not 1 <= k <= MAX_TASKS:
        raise ValueError(f"the solver takes 1 <= K <= {MAX_TASKS} tasks, got {k}")
    if gram.device.type == "cpu":
        return cagrad_solve_reference(gram, c)
    if gram.device.type != "cuda":
        raise ValueError(f"cagrad_solve: unsupported device {gram.device}")
    if gram.dtype != torch.float32:
        raise TypeError(f"cagrad_solve takes float32, got {gram.dtype}")
    g = gram.detach().contiguous()
    n = 1 if g.dim() == 2 else g.shape[0]
    w = torch.empty(g.shape[:-1], dtype=torch.float32, device=g.device)
    fn = _library()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(g.data_ptr(), w.data_ptr(), n, k, float(c), stream)
    if err != 0:
        raise RuntimeError(f"cagrad_solver kernel launch failed: cudaError_t {err} "
                           f"(gram {tuple(gram.shape)})")
    launches += 1
    return w
