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

The source holds five variants of each kernel; ``_variant`` chooses one from
the sizes (Tq, Tk, d) and passes it to the entry points, which refuse a
variant that does not take the sizes. The two-pass kernels (``TWO_PASS``)
are chosen only beyond 128 keys (backward: or query rows), which no model's
default path reaches; they stay callable by name at every length, through
``_forward_kernel`` and ``_backward_kernel``, as the yardstick the one-sweep
kernels over 128 keys replaced.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gaitpd_torch.ops.stream_block import _check_cuda

# Kernel launches made by ``cheap_xattn`` and ``cheap_xattn_backward``;
# callers may reset them to 0.
launches = 0
backward_launches = 0

_bound = None

# The kernel variants of csrc/cheap_xattn.cu, numbered as its entry points take
# them: one sweep with d = 12 as a compile-time width (Tk <= 64; backward also
# Tq <= 64), one sweep at any d <= 64 (the same lengths), the two-pass kernels
# (d <= 64 beyond 128 keys or, backward, query rows), one sweep over up to 128
# keys with two lanes a query row (d <= 64 between the two), and tiles in
# shared memory (d > 64, any Tq and Tk, both ways: key tiles of 64 with an
# online softmax forward, one block a problem backward). Operations bound
# each at the repo's shapes (csrc header).
SWEEP_D12, SWEEP, TWO_PASS, SWEEP_128, TILED = range(5)
VARIANT_NAMES = ("sweep_d12", "sweep", "two_pass", "sweep_128", "tiled")
SWEEP_T = 64  # the most keys (backward: and query rows) the sweep kernels hold
SWEEP_128_T = 128  # the same for the sweep over 128 keys
REGISTER_D = 64  # the widest row the register kernels hold


def _variant(tq: int, tk: int, d: int, backward: bool = False) -> int:
    """The kernel variant that takes these sizes."""
    if d > REGISTER_D:
        return TILED
    if tk <= SWEEP_T and (not backward or tq <= SWEEP_T):
        return SWEEP_D12 if d == 12 else SWEEP
    if tk <= SWEEP_128_T and (not backward or tq <= SWEEP_128_T):
        return SWEEP_128
    return TWO_PASS


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
        config.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 4
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
    only A and B: the backward recomputes the softmax."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _forward_kernel(a, b)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return cheap_xattn_backward(a, b, g.contiguous())


def cheap_xattn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """softmax(A Bᵀ/√d) B for a (N, Tq, d), b (N, Tk, d) -> (N, Tq, d).

    CPU tensors take ``cheap_xattn_reference``; CUDA tensors launch the
    kernel (f32, contiguous), through ``_CheapXAttnFunction`` where
    a gradient is needed, or raise."""
    _check(a, b)
    if a.device.type == "cpu":
        return cheap_xattn_reference(a, b)
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
    the backward kernel (deterministic: one block per problem, no float
    atomics) or raise."""
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
    # row statistics of the two-pass kernel and of the tiled one beyond 64
    # keys; the others keep theirs on chip
    stats = (torch.empty((n, tq, 3), dtype=torch.float32, device=a.device)
             if variant == TWO_PASS or (variant == TILED and tk > SWEEP_T) else None)
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
    the blocks of the grid. Needs a card."""
    variant = _variant(tq, tk, d, backward)
    out = [ctypes.c_int(0) for _ in range(4)]
    err = _library()[2](int(backward), variant, n, tq, tk, d, *(ctypes.byref(v) for v in out))
    if err != 0:
        raise RuntimeError(f"cheap_xattn_config failed: cudaError_t {err}")
    return dict(variant=VARIANT_NAMES[variant],
                **dict(zip(("threads", "smem_bytes", "blocks_per_sm", "blocks"),
                           (v.value for v in out))))
