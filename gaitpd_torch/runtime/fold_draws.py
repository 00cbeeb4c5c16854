"""Random draws of F folds at once, under ``torch.func.vmap``.

The stacked cross-validation (gaitpd_torch/train/vmap_cv.py) runs one fold's
step under ``torch.func.vmap``, and each fold owns a ``torch.Generator``, so
a draw there has to come from F generators. Every draw site of a step
(dropout, the GCL noise, the augmentation, modality dropout, the draws of
RLW, PCGrad and GradDrop) calls ``rand``, ``randn``, ``randint`` or
``randperm`` here with the generator it was given:

* a ``torch.Generator`` (or None): the plain ``torch`` draw, the same call
  as before, so a sequential run draws bitwise as it did;
* a ``RowShard``, in a data-parallel step: the draw at the global batch's
  shape, this rank's rows of it;
* a ``FoldDraws``, inside the vmap: ``_FoldDrawFunction``'s vmap rule draws
  fold by fold, each from its own generator at the unbatched shape, and
  stacks the draws. So each generator advances exactly as a sequential run
  of its fold advances it, draw for draw.

A fold that a sequential run would not step (a batch that is all padding,
an eval batch past its own count, a fold that has stopped early) is
inactive: it draws nothing, its generator stays as it was, and its rows
hold zeros (dropout keeps every entry, the noise is 0), or for ``randperm``
the identity permutation. The activity is
known on the host, so no draw synchronises with the card. The cost is F
draws and one stack a site, where a sequential step makes one draw.

    gens = [torch.Generator().manual_seed(s) for s in seeds]
    def fold(x, token):
        keep = rand(x.shape, FoldDraws(gens, [True] * len(gens), token)) < 0.9
        return torch.where(keep, x, 0.0)
    out = torch.func.vmap(fold)(xs, fold_tokens(len(gens)))
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch


class FoldDraws:
    """F folds' generators as one generator argument, inside a vmap over the
    folds. ``active[f]`` (host bools): whether fold f draws. ``token``: the
    fold axis's slice of ``fold_tokens(F)``, a batched tensor that carries
    the vmap level into the draw."""

    def __init__(self, generators: Sequence[torch.Generator], active: Sequence[bool],
                 token: torch.Tensor):
        if len(active) != len(generators):
            raise ValueError(f"{len(generators)} generators, {len(active)} activity flags")
        self.generators = tuple(generators)
        self.active = tuple(bool(a) for a in active)
        self.token = token


class RowShard:
    """One rank's rows of a batch sharded over ``count`` ranks
    (gaitpd_torch/runtime/mesh.py): a draw of shape (b, ...) is made from
    ``generator`` at the global batch's shape (count * b, ...), and rows
    [index * b, (index + 1) * b) are this rank's. Every rank draws the global
    batch's numbers from a generator seeded alike, so each row gets the
    number it gets in the single-process step, and the generator advances
    as it does there. Only per-row draws take one (the augmentation, the
    forward's dropout, the GCL noise); a step's other draws use
    ``generator`` itself."""

    def __init__(self, generator: torch.Generator, count: int, index: int):
        self.generator, self.count, self.index = generator, count, index

    def rows(self, draw, shape) -> torch.Tensor:
        b = shape[0]
        full = draw((b * self.count,) + tuple(shape[1:]), self.generator)
        return full[self.index * b:(self.index + 1) * b]


Generator = Union[torch.Generator, FoldDraws, RowShard, None]


def fold_tokens(n_folds: int, device=None) -> torch.Tensor:
    """The token a vmap over ``n_folds`` folds maps over (in_dims 0)."""
    return torch.arange(n_folds, device=device)


def _draw(kind: str, shape, generator: torch.Generator, spec: dict) -> torch.Tensor:
    if kind == "rand":
        return torch.rand(shape, generator=generator, **spec)
    if kind == "randn":
        return torch.randn(shape, generator=generator, **spec)
    if kind == "randperm":
        return torch.randperm(shape[0], generator=generator, device=spec["device"])
    low, high = spec["bounds"]
    return torch.randint(low, high, shape, generator=generator, device=spec["device"])


def _idle(kind: str, shape, spec: dict) -> torch.Tensor:
    """An inactive fold's row: zeros, or the identity permutation."""
    if kind == "randperm":
        return torch.arange(shape[0], device=spec["device"])
    dtype = torch.int64 if kind == "randint" else spec.get("dtype")
    return torch.zeros(shape, dtype=dtype, device=spec["device"])


class _FoldDrawFunction(torch.autograd.Function):
    """A draw of every fold; only its vmap rule draws. Not differentiable."""

    @staticmethod
    def forward(token, draws, kind, shape, spec):
        raise ValueError("a FoldDraws generator draws only under torch.func.vmap over "
                         "its folds (with fold_tokens as an input)")

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def vmap(info, in_dims, token, draws, kind, shape, spec):
        if info.batch_size != len(draws.generators):
            raise ValueError(f"a vmap over {info.batch_size} entries draws from "
                             f"{len(draws.generators)} generators")
        idle = None
        rows = []
        for g, on in zip(draws.generators, draws.active):
            if on:
                rows.append(_draw(kind, shape, g, spec))
                continue
            if idle is None:
                idle = _idle(kind, shape, spec)
            rows.append(idle)
        return torch.stack(rows), 0


def _fold(kind: str, shape, draws: FoldDraws, spec: dict) -> torch.Tensor:
    return _FoldDrawFunction.apply(draws.token, draws, kind, tuple(shape), spec)


def rand(shape, generator: Generator, *, device=None,
         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``torch.rand(shape, generator=generator, ...)``, or one draw a fold."""
    if isinstance(generator, FoldDraws):
        return _fold("rand", shape, generator, {"device": device, "dtype": dtype})
    if isinstance(generator, RowShard):
        return generator.rows(lambda s, g: rand(s, g, device=device, dtype=dtype), shape)
    return torch.rand(shape, generator=generator, device=device, dtype=dtype)


def randn(shape, generator: Generator, *, device=None,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``torch.randn(shape, generator=generator, ...)``, or one draw a fold."""
    if isinstance(generator, FoldDraws):
        return _fold("randn", shape, generator, {"device": device, "dtype": dtype})
    if isinstance(generator, RowShard):
        return generator.rows(lambda s, g: randn(s, g, device=device, dtype=dtype), shape)
    return torch.randn(shape, generator=generator, device=device, dtype=dtype)


def randint(low: int, high: int, shape, generator: Generator, *, device=None) -> torch.Tensor:
    """``torch.randint(low, high, shape, generator=generator, ...)``, or one
    draw a fold."""
    if isinstance(generator, FoldDraws):
        return _fold("randint", shape, generator, {"device": device, "bounds": (low, high)})
    if isinstance(generator, RowShard):
        return generator.rows(lambda s, g: randint(low, high, s, g, device=device), shape)
    return torch.randint(low, high, shape, generator=generator, device=device)


def randperm(n: int, generator: Generator, *, device=None) -> torch.Tensor:
    """``torch.randperm(n, generator=generator, ...)``, or one draw a fold."""
    if isinstance(generator, FoldDraws):
        return _fold("randperm", (n,), generator, {"device": device})
    if isinstance(generator, RowShard):
        raise TypeError("a permutation is not a per-row draw: draw it from RowShard.generator")
    return torch.randperm(n, generator=generator, device=device)
