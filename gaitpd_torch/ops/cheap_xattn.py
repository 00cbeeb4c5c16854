"""Cheap cross-attention softmax(A Bᵀ/√d) B, with its gradient.

Port of gaitpd/ops/pallas_blocks.py:184-281 (the Pallas TPU kernel
``_xattn_kernel`` behind ``cheap_xattn_pallas``, whose custom_vjp backward is
the VJP of gaitpd/ops/attention.py::cheap_cross_attention). On CUDA tensors
``cheap_xattn`` launches the hand-written forward kernel of
gaitpd_torch/csrc/cheap_xattn.cu, counted in ``launches``; where autograd
needs a gradient it goes through ``_CheapXAttnFunction``, whose backward is
the hand-written backward kernel of the same file, counted in
``backward_launches``. On CPU tensors both take the plain version,
``cheap_xattn_reference``, under ordinary autograd. There is no fallback from
one to the other.

Under ``torch.func.vmap`` (the stacked folds of gaitpd_torch/train/vmap_cv.py)
a CUDA call goes through ``_CheapXAttnFunction``'s vmap rule, with or without
a gradient: the vmap axis folds into the problem axis, (F, N, T, d) -> (F·N,
T, d), so all F folds take one forward launch, and autograd outside the vmap
one backward launch. Each problem's arithmetic does not depend on N, so each
fold's rows are the bits of its own launch.

The source holds five variants (the sweep over 128 keys backward only);
``_variant`` chooses one from the sizes (Tq, Tk, d) and passes it to the
entry points, which refuse a variant that does not take the sizes. Beyond
64 keys forward and beyond 128 keys or query rows backward at d <= 64
(T 101, ``--win_len`` 128 and above), the one sweep over key tiles
(``SWEEP_LONG``) runs. Number 2, the two-pass first design, is retired.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gaitpd_torch.ops.stream_block import _batched, _check_cuda

# Kernel launches made by ``cheap_xattn`` and ``cheap_xattn_backward``;
# callers may reset them to 0.
launches = 0
backward_launches = 0

_bound = None

# The kernel variants of csrc/cheap_xattn.cu, numbered as its entry points take
# them: one sweep with d = 12 as a compile-time width (Tk <= 64; backward also
# Tq <= 64), one sweep at any d <= 64 (the same lengths), number 2 retired (the
# two-pass first design), one sweep over up to 128 keys and query
# rows with two lanes a query row (backward only, d <= 64 between the two),
# tiles in shared memory (d > 64, any Tq and Tk, both ways: key tiles of 64
# with an online softmax forward, one block a problem backward), and one
# sweep over key tiles of 128 with an online softmax, two lanes a query row
# (d <= 64: forward beyond 64 keys, backward beyond 128 keys or query rows;
# the backward in two launches, query rows then key rows). Operations bound
# each at the repo's shapes (csrc header).
SWEEP_D12, SWEEP, SWEEP_128, TILED, SWEEP_LONG = 0, 1, 3, 4, 5
VARIANT_NAMES = ("sweep_d12", "sweep", None, "sweep_128", "tiled", "sweep_long")
SWEEP_T = 64  # the most keys (backward: and query rows) the sweep kernels hold
SWEEP_128_T = 128  # the same for the sweep over 128 keys (backward)
REGISTER_D = 64  # the widest row the register kernels hold


def _variant(tq: int, tk: int, d: int, backward: bool = False) -> int:
    """The kernel variant that takes these sizes."""
    if d > REGISTER_D:
        return TILED
    if tk <= SWEEP_T and (not backward or tq <= SWEEP_T):
        return SWEEP_D12 if d == 12 else SWEEP
    if backward and tk <= SWEEP_128_T and tq <= SWEEP_128_T:
        return SWEEP_128
    return SWEEP_LONG


def cheap_xattn_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version in the reference's order
    (gaitpd/ops/attention.py:45-53): scores divided by sqrt(d), softmax over
    the keys, then the product with B.

    a: (N, Tq, d); b: (N, Tk, d) -> (N, Tq, d)."""
    # a tensor divisor: PyTorch's CUDA division by a Python number multiplies
    # by its reciprocal, which is not the reference's (nor the kernel's) division
    sqrt_d = torch.full((), a.shape[-1], dtype=a.dtype, device=a.device).sqrt()
    sim = torch.einsum("btd,bsd->bts", a, b) / sqrt_d
    return torch.einsum("bts,bsd->btd", torch.softmax(sim, dim=-1), b)


def cheap_xattn_backward_reference(
    a: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward: autograd of ``cheap_xattn_reference``
    for the cotangent g (N, Tq, d). Returns (dA, dB)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (a, b)]
        return torch.autograd.grad(cheap_xattn_reference(*leaves), leaves, g)


def _library():
    global _bound
    if _bound is None:
        from gaitpd_torch.ops import _build

        lib = _build.load("cheap_xattn")
        fwd = lib.cheap_xattn_forward
        fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        bwd = lib.cheap_xattn_backward
        bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        config = lib.cheap_xattn_config
        config.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        config.restype = ctypes.c_int
        _bound = (fwd, bwd, config)
    return _bound


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data is not 16-byte aligned: the kernels
    read rows four floats at a time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(a, b):
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"expected a (N, Tq, d) and b (N, Tk, d), got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if a.shape[0] != b.shape[0] or a.shape[2] != b.shape[2]:
        raise ValueError(f"shapes do not agree: a {tuple(a.shape)}, b {tuple(b.shape)}")
    if min(a.shape[1], b.shape[1], a.shape[2]) < 1:
        raise ValueError(f"need Tq, Tk, d >= 1, got a {tuple(a.shape)}, b {tuple(b.shape)}")


def _forward_kernel(a, b, variant=None):
    """The forward kernel of ``variant`` (by default ``_variant``'s)."""
    global launches
    n, tq, d = a.shape
    tk = b.shape[1]
    if variant is None:
        variant = _variant(tq, tk, d)
    out = torch.empty_like(a)
    if n == 0:
        return out
    a, b = _aligned(a), _aligned(b)
    fwd = _library()[0]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fwd(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, tq, tk, d, variant, stream)
    if err != 0:
        raise RuntimeError(f"cheap_xattn kernel launch failed: cudaError_t {err} "
                           f"(a {tuple(a.shape)}, b {tuple(b.shape)})")
    launches += 1
    return out


class _CheapXAttnFunction(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient. Saves
    only A and B: the backward recomputes the softmax. Under
    ``torch.func.vmap`` its vmap rule makes one launch for the whole vmap
    axis, folded into the problems."""

    @staticmethod
    def forward(a, b):
        return _forward_kernel(a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return cheap_xattn_backward(a, b, g.contiguous())

    @staticmethod
    def vmap(info, in_dims, a, b):
        n = info.batch_size
        a, b = (t.movedim(dim, 0) if dim is not None else t.expand(n, *t.shape)
                for t, dim in zip((a, b), in_dims))
        problems, tq, d = a.shape[1:]
        out = cheap_xattn(a.reshape(n * problems, tq, d).contiguous(),
                          b.reshape(n * problems, b.shape[2], d).contiguous())
        return out.reshape(n, problems, tq, d), 0


def cheap_xattn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """softmax(A Bᵀ/√d) B for a (N, Tq, d), b (N, Tk, d) -> (N, Tq, d).

    CPU tensors take ``cheap_xattn_reference``; CUDA tensors launch the
    kernel (f32, contiguous), through ``_CheapXAttnFunction`` where a
    gradient is needed or under ``torch.func.vmap``, or raise."""
    _check(a, b)
    if a.device.type == "cpu":
        return cheap_xattn_reference(a, b)
    if _batched(a) or _batched(b):
        return _CheapXAttnFunction.apply(a, b)
    _check_cuda("cheap_xattn", (a, b))
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _CheapXAttnFunction.apply(a, b)
    return _forward_kernel(a, b)


def cheap_xattn_backward(
    a: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dA, dB), the VJP of ``cheap_xattn`` at (a, b) for the cotangent
    g (N, Tq, d).

    CPU tensors take ``cheap_xattn_backward_reference``; CUDA tensors launch
    the backward kernel (deterministic: no float atomics, each output row
    summed by one block in a fixed order) or raise. ``backward_launches``
    counts calls: ``SWEEP_LONG``'s call is two kernel launches."""
    _check(a, b)
    if g.shape != a.shape:
        raise ValueError(f"cotangent shape {tuple(g.shape)} != {tuple(a.shape)}")
    if a.device.type == "cpu":
        return cheap_xattn_backward_reference(a, b, g)
    _check_cuda("cheap_xattn_backward", (a, b, g))
    return _backward_kernel(a, b, g)


def _backward_kernel(a, b, g, variant=None):
    """The backward kernel of ``variant`` (by default ``_variant``'s)."""
    global backward_launches
    n, tq, d = a.shape
    tk = b.shape[1]
    if variant is None:
        variant = _variant(tq, tk, d, backward=True)
    da, db = torch.empty_like(a), torch.empty_like(b)
    if n == 0:
        return da, db
    a, b, g = _aligned(a), _aligned(b), _aligned(g)
    # row statistics of the sweep over key tiles (its first launch writes
    # them for its second) and of the tiled kernel beyond 64 keys; the
    # others keep theirs on chip
    stats = (torch.empty((n, tq, 3), dtype=torch.float32, device=a.device)
             if variant == SWEEP_LONG or (variant == TILED and tk > SWEEP_T)
             else None)
    bwd = _library()[1]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = bwd(a.data_ptr(), b.data_ptr(), g.data_ptr(), da.data_ptr(), db.data_ptr(),
                  None if stats is None else stats.data_ptr(), n, tq, tk, d, variant, stream)
    if err != 0:
        raise RuntimeError(f"cheap_xattn backward kernel launch failed: cudaError_t {err} "
                           f"(a {tuple(a.shape)}, b {tuple(b.shape)})")
    backward_launches += 1
    return da, db


def launch_config(n: int, tq: int, tk: int, d: int, backward: bool = False) -> dict:
    """The launch that ``cheap_xattn`` (or, with ``backward``,
    ``cheap_xattn_backward``) makes for N problems of (Tq, Tk, d) on the
    current card: the variant, threads a block, dynamic shared memory in
    bytes, the blocks an SM holds at once (CUDA's occupancy calculator) and
    the blocks of the grid; ``SWEEP_LONG``'s backward also its second launch
    under ``keys``. Needs a card."""
    variant = _variant(tq, tk, d, backward)
    out = (ctypes.c_int * 8)()
    err = _library()[2](int(backward), variant, n, tq, tk, d, out)
    if err != 0:
        raise RuntimeError(f"cheap_xattn_config failed: cudaError_t {err}")
    names = ("threads", "smem_bytes", "blocks_per_sm", "blocks")
    config = dict(variant=VARIANT_NAMES[variant], **dict(zip(names, out[:4])))
    if out[4]:  # a second launch
        config["keys"] = dict(zip(names, out[4:]))
    return config
