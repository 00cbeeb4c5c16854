"""The CAGrad dual solver as one kernel launch.

``cagrad_solve(gram, c)`` returns the CAGrad weights w (K,) for the Gram
matrix of the per-task gradients and the strength c, computing
c_coef = c·sqrt(mean(G) + EPS) + EPS itself (gaitpd/learning/mtl.py:412-413).
c is a Python number for every matrix, or an f32 tensor on the matrices'
device with one value a matrix (an HP grid's instances, each with its own
c: gaitpd_torch/train/hp_search.py), which the kernel reads from device
memory: no host copy. Equal f32 values of c give equal bits either way.
On a CUDA tensor it launches the hand-written kernel
gaitpd_torch/csrc/cagrad_solver.cu (one warp per matrix, in registers,
its golden-section searches speculated across the lanes; no host
synchronisation), counted in ``launches``; on a CPU tensor it takes
the plain version beside it, ``cagrad_solve_reference``, which is
gaitpd_torch.learning.minnorm.cagrad_weights in eager torch ops. The two
run the same IEEE operations in the same order and agree bit for bit.
There is no fallback from one to the other. A batch (N, K, K) of matrices
is solved in one call either way, and under ``torch.func.vmap`` the vmap
axis joins that batch (gaitpd_torch/ops/solver_folds.py): the stacked
cross-validation's F folds are one launch, counted in ``launches`` and in
``fold_launches``.
"""

from __future__ import annotations

import ctypes
from typing import Union

import torch

from gaitpd_torch.learning.minnorm import EPS, cagrad_weights, sum_entries
from gaitpd_torch.ops.solver_folds import is_batched, solve_folds

MAX_TASKS = 8  # K is a compile-time constant of the kernel, 1..8

# Kernel launches made by ``cagrad_solve``; callers may reset it to 0. Of
# those, the launches for every entry of a torch.func.vmap (the folds), and
# the launches that read c from a tensor, one value a matrix.
launches = 0
fold_launches = 0
per_matrix_launches = 0

_bound = None


def cagrad_c_coef(gram: torch.Tensor, c: Union[float, torch.Tensor]) -> torch.Tensor:
    """c·sqrt(mean(G) + EPS) + EPS per matrix, the mean's sum taken in the
    kernel's order: a scalar for (K, K), (N,) for (N, K, K); under
    ``torch.func.vmap`` each entry's, by the same operations. ``c``: a
    number, or a tensor of shape ``gram.shape[:-2]``."""
    g = gram.reshape((-1,) + tuple(gram.shape[-2:]))
    total = sum_entries(g)
    if isinstance(c, torch.Tensor):
        c = c.reshape(-1)
    # a tensor divisor: PyTorch's CUDA division by a Python number multiplies
    # by its reciprocal, which is not the kernel's IEEE division
    coef = c * torch.sqrt(total / torch.full_like(total, float(g.shape[-1] ** 2)) + EPS) + EPS
    return coef.reshape(gram.shape[:-2])


def cagrad_solve_reference(gram: torch.Tensor, c: Union[float, torch.Tensor]) -> torch.Tensor:
    """Plain version: the eager-torch solver on the same inputs."""
    return cagrad_weights(gram, cagrad_c_coef(gram, c))


def _library():
    global _bound
    if _bound is None:
        from gaitpd_torch.ops import _build

        fn = _build.load("cagrad_solver").cagrad_solver
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def _count_fold() -> None:
    global fold_launches
    fold_launches += 1


def cagrad_solve(gram: torch.Tensor, c: Union[float, torch.Tensor]) -> torch.Tensor:
    """gram: (K, K) or (N, K, K) -> w: (K,) or (N, K) on the simplex; c: a
    number, or an f32 tensor of shape ``gram.shape[:-2]`` on gram's device.

    CPU tensors take ``cagrad_solve_reference``; CUDA tensors launch the
    kernel or raise; under ``torch.func.vmap``, one call for the vmap axis."""
    global launches, per_matrix_launches
    if gram.dim() not in (2, 3) or gram.shape[-1] != gram.shape[-2]:
        raise ValueError(f"expected (K, K) or (N, K, K) Gram matrices, got {tuple(gram.shape)}")
    k = gram.shape[-1]
    if not 1 <= k <= MAX_TASKS:
        raise ValueError(f"the solver takes 1 <= K <= {MAX_TASKS} tasks, got {k}")
    per_matrix = isinstance(c, torch.Tensor)
    if is_batched(gram) or (per_matrix and is_batched(c)):
        return solve_folds(cagrad_solve, _count_fold, gram, c)
    if per_matrix and tuple(c.shape) != tuple(gram.shape[:-2]):
        raise ValueError(f"c of shape {tuple(c.shape)} for Gram matrices {tuple(gram.shape)}: "
                         "one value a matrix")
    if gram.device.type == "cpu":
        return cagrad_solve_reference(gram, c)
    if gram.device.type != "cuda":
        raise ValueError(f"cagrad_solve: unsupported device {gram.device}")
    if gram.dtype != torch.float32:
        raise TypeError(f"cagrad_solve takes float32, got {gram.dtype}")
    g = gram.detach().contiguous()
    n = 1 if g.dim() == 2 else g.shape[0]
    c_ptr, c_scalar = None, 0.0
    if per_matrix:
        if c.device != g.device or c.dtype != torch.float32:
            raise TypeError(f"cagrad_solve takes c as float32 on {g.device}, got {c.dtype} on "
                            f"{c.device}")
        c_dev = c.detach().contiguous()
        c_ptr = c_dev.data_ptr()
    else:
        c_scalar = float(c)
    w = torch.empty(g.shape[:-1], dtype=torch.float32, device=g.device)
    fn = _library()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(g.data_ptr(), w.data_ptr(), n, k, c_scalar, c_ptr, stream)
    if err != 0:
        raise RuntimeError(f"cagrad_solver kernel launch failed: cudaError_t {err} "
                           f"(gram {tuple(gram.shape)})")
    launches += 1
    if per_matrix:
        per_matrix_launches += 1
    return w
