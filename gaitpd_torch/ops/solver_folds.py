"""The simplex solvers under ``torch.func.vmap``: one call for every entry.

The solver wrappers (gaitpd_torch/ops/cagrad_solver.py, ops/mtl_solvers.py)
launch their kernels through ctypes on ``data_ptr()``, which a tensor of a
vmap level does not have. A wrapper given such a tensor calls
``solve_folds``, whose rule (``_FoldSolve.vmap``) moves the vmap axis to
the front, merges it into the kernels' own axis of N matrices, so that F
folds' (K, K) matrices are one call on F matrices, and splits the weights
again. Each matrix is solved by its own lanes, and the plain versions are
elementwise across matrices, so each fold gets the bits of a call of its
own. On CUDA tensors the merged call is one launch, counted by the
wrapper's counter and by ``on_launch`` (the wrapper's fold counter); on CPU
tensors it takes the plain version.

    w = torch.func.vmap(lambda g: min_norm_solve(g))(grams)  # (F, K, K) -> (F, K)
"""

from __future__ import annotations

from typing import Callable

import torch


def is_batched(t: torch.Tensor) -> bool:
    """Whether ``t`` is a tensor of a ``torch.func.vmap`` level."""
    return torch._C._functorch.is_batchedtensor(t)


class _FoldSolve(torch.autograd.Function):
    """``solve(gram, *scalars)``; only its vmap rule is reached in practice.
    Not differentiable: the weights are constants of the step."""

    @staticmethod
    def forward(gram, solve, on_launch, scalars):
        return solve(gram, *scalars)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def vmap(info, in_dims, gram, solve, on_launch, scalars):
        g = gram.movedim(in_dims[0], 0)
        merged = g.reshape((-1,) + tuple(g.shape[-2:]))
        out = solve(merged, *scalars)
        if merged.device.type == "cuda" and not is_batched(merged):
            on_launch()  # an outer vmap's rule counts a nested one
        return out.reshape(g.shape[:-1]), 0


def solve_folds(solve: Callable, on_launch: Callable[[], None], gram: torch.Tensor,
                *scalars: float) -> torch.Tensor:
    """``solve(gram, *scalars)`` for a ``gram`` of a vmap level, one call for
    the whole vmap axis."""
    return _FoldSolve.apply(gram, solve, on_launch, tuple(scalars))

