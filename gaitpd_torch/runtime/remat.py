"""Rematerialisation of the train forward: ``StepSettings.remat``. Port of
gaitpd/train/step.py:66-73,191-198 (``jax.checkpoint`` of ``train_apply``
under ``dots_saveable`` or ``nothing_saveable``).

* ``"nothing"``: the forward runs under one non-reentrant
  ``torch.utils.checkpoint``; nothing inside it is kept, and each of the K
  per-task backward passes recomputes the whole forward (the stream block's
  forward kernel runs 1 + K times a step).
* ``"dots"``: what ``dots_saveable`` keeps is kept as without remat: the
  outputs of the convolutions, matmuls, einsums, linear layers, the stream
  block and the cheap cross-attention. Each elementwise op between them
  (GELU, ReLU, LayerNorm, softmax, ...) runs under a checkpoint of its own
  and is recomputed in each backward pass. A selective-checkpoint policy over
  the whole forward would be the direct translation, but torch refuses a
  second backward pass through a region computed under one ("Trying to
  backward an extra time"), and the K task passes are K backward passes.

Draws. The port draws from explicit generators only (a step's
``torch.Generator``, a sharded batch's ``RowShard``, the stacked folds'
``FoldDraws``, whose checkpoint gaitpd_torch/train/vmap_cv.py places),
which ``preserve_rng_state`` does not cover. A region recomputed under ``"nothing"``
draws from clones of its generators as they were when it first ran, so it
replays the first run's masks bitwise, and the generators themselves advance
once, as without remat. Under ``"dots"`` no draw is recomputed.

    apply = rematerialise(train_apply, "nothing")
    logits = apply(module, xs, generator, epoch)
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils.checkpoint import checkpoint

from gaitpd_torch.runtime.fold_draws import RowShard

REMAT_POLICIES = ("none", "dots", "nothing")

# the elementwise ops of the port's models whose backward reads saved
# activations; under "dots" each call runs under a checkpoint of its own
_ELEMENTWISE = frozenset({
    F.gelu, F.relu, torch.relu, torch.Tensor.relu, F.silu, torch.tanh, torch.Tensor.tanh,
    torch.sigmoid, torch.Tensor.sigmoid, torch.exp, torch.Tensor.exp,
    F.layer_norm, F.normalize, F.softmax, torch.softmax, torch.Tensor.softmax,
    F.log_softmax, torch.log_softmax, torch.Tensor.log_softmax,
})


def _needs_grad(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.requires_grad for a in args)


class _ElementwiseCheckpoints(TorchFunctionMode):
    """Within, each call of an op of ``_ELEMENTWISE`` that builds a graph runs
    under a non-reentrant checkpoint: its inputs are kept, its intermediates
    recomputed in the backward pass. Every other op runs as it does."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _ELEMENTWISE and torch.is_grad_enabled() and _needs_grad(args):
            return checkpoint(func, *args, use_reentrant=False, preserve_rng_state=False,
                              **kwargs)
        return func(*args, **kwargs)


def generators_of(generator) -> List[torch.Generator]:
    """The torch generators a sequential step's generator argument (a
    torch.Generator, a RowShard or None) draws from."""
    if generator is None:
        return []
    return [generator.generator if isinstance(generator, RowShard) else generator]


def with_generators(generator, gens: Sequence[torch.Generator]):
    """``generator`` drawing from ``gens`` (as ``generators_of`` lists them)."""
    if generator is None:
        return None
    if isinstance(generator, RowShard):
        return RowShard(gens[0], generator.count, generator.index)
    return gens[0]


def _clone(g: torch.Generator, state: torch.Tensor) -> torch.Generator:
    c = torch.Generator(device=g.device)
    c.set_state(state)
    return c


def checkpoint_replaying(run: Callable, gens: Sequence[torch.Generator], *inputs):
    """``run(gens, *inputs)`` under a non-reentrant checkpoint. Its first run
    draws from ``gens``; each recomputation from clones of them as they were
    then. The generators' states are read on the host: no synchronisation."""
    gens = list(gens)
    states = [g.get_state() for g in gens]
    fresh = [True]

    def region(*inputs):
        if fresh[0]:
            fresh[0] = False
            return run(gens, *inputs)
        return run([_clone(g, s) for g, s in zip(gens, states)], *inputs)

    return checkpoint(region, *inputs, use_reentrant=False, preserve_rng_state=False)


def rematerialise(train_apply: Callable, policy: str) -> Callable:
    """``train_apply(module, xs, generator, epoch)`` under ``policy`` (one of
    REMAT_POLICIES)."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {REMAT_POLICIES}, got {policy!r}")
    if policy == "none":
        return train_apply
    if policy == "dots":
        def apply(module, xs, generator, epoch):
            with _ElementwiseCheckpoints():
                return train_apply(module, xs, generator, epoch)
        return apply

    def apply(module, xs, generator, epoch):
        def run(gens, *xs):
            return train_apply(module, xs, with_generators(generator, gens), epoch)

        return checkpoint_replaying(run, generators_of(generator), *xs)

    return apply
