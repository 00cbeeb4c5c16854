"""The simplex solvers under ``torch.func.vmap``: one call for every entry.

The solver wrappers (gaitpd_torch/ops/cagrad_solver.py, ops/mtl_solvers.py)
launch their kernels through ctypes on ``data_ptr()``, which a tensor of a
vmap level does not have. A wrapper given such a tensor calls
``solve_folds``, whose rule (``_FoldSolve.vmap``) moves the vmap axis to
the front, merges it into the kernels' own axis of N matrices, so that F
folds' (K, K) matrices are one call on F matrices, and splits the weights
again. A tensor argument with a value a matrix (CAGrad's strength c, one an
HP-grid instance) rides as an input of its own: its vmap axis, or a copy
for each entry where it has none, is merged the same way, so matrix m keeps
its own value. Each matrix is solved by its own lanes, and the plain
versions are elementwise across matrices, so each fold gets the bits of a
call of its own. On CUDA tensors the merged call is one launch, counted by
the wrapper's counter and by ``on_launch`` (the wrapper's fold counter); on
CPU tensors it takes the plain version.

    w = torch.func.vmap(lambda g: min_norm_solve(g))(grams)  # (F, K, K) -> (F, K)
    w = torch.func.vmap(cagrad_solve)(grams, cs)  # c (F,): one c a matrix
"""

from __future__ import annotations

from typing import Callable

import torch


def is_batched(t: torch.Tensor) -> bool:
    """Whether ``t`` is a tensor of a ``torch.func.vmap`` level."""
    return torch._C._functorch.is_batchedtensor(t)


def _to_front(t: torch.Tensor, dim, size: int) -> torch.Tensor:
    """``t`` with its vmap axis ``dim`` first, or ``size`` copies of it
    (a view) where it has none."""
    if dim is None:
        return t.expand((size,) + tuple(t.shape))
    return t.movedim(dim, 0)


class _FoldSolve(torch.autograd.Function):
    """``solve(gram, *args)``; only its vmap rule is reached in practice.
    Not differentiable: the weights are constants of the step."""

    @staticmethod
    def forward(solve, on_launch, gram, *args):
        return solve(gram, *args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def vmap(info, in_dims, solve, on_launch, gram, *args):
        g = _to_front(gram, in_dims[2], info.batch_size)
        lead = g.shape[:-2]
        merged = g.reshape((-1,) + tuple(g.shape[-2:]))
        # a tensor argument has one value a matrix: merged as the matrices are
        merged_args = [_to_front(a, d, info.batch_size).expand(lead).reshape(-1)
                       if isinstance(a, torch.Tensor) else a
                       for a, d in zip(args, in_dims[3:])]
        out = solve(merged, *merged_args)
        if merged.device.type == "cuda" and not is_batched(merged):
            on_launch()  # an outer vmap's rule counts a nested one
        return out.reshape(tuple(lead) + tuple(out.shape[1:])), 0


def solve_folds(solve: Callable, on_launch: Callable[[], None], gram: torch.Tensor,
                *args) -> torch.Tensor:
    """``solve(gram, *args)`` for a ``gram`` (or a tensor argument) of a vmap
    level, one call for the whole vmap axis. ``args``: Python numbers, or
    tensors of shape ``gram.shape[:-2]``, one value a matrix."""
    return _FoldSolve.apply(solve, on_launch, gram, *args)
