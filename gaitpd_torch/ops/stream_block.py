"""Fused stream block: Conv1d(k, 'SAME') + bias + activation +
AdaptiveAvgPool1d(t_out), the whole SharedBackbone in one op, with its
gradient.

Port of gaitpd/ops/pallas_blocks.py:55-69 (the jnp reference) and
:142-176 (the Pallas TPU kernel and its custom_vjp). On CUDA tensors
``stream_block`` launches the hand-written forward kernel of
gaitpd_torch/csrc/stream_block.cu, counted in ``launches``; where autograd
needs a gradient it goes through ``_StreamBlockFunction``, whose backward is
the hand-written backward kernel of the same file, counted in
``backward_launches``. On CPU tensors both take the plain version,
``stream_block_reference``, under ordinary autograd. There is no fallback
from one to the other.

The forward has four variants and the backward two: ``_variant`` and
``_backward_variant`` choose one from the sizes alone and pass it to the
entry point, which refuses a variant that does not take the sizes.

Folds. ``stream_block_folds`` runs F folds' blocks at once: x (F·B, T,
C_in) fold-major, w (F, K, C_in, C_out), b (F, C_out), each fold's windows
through its own weights, in one launch of the same kernels (the fold is the
grid's z index, csrc/stream_block.cu "FOLDS"); each fold's result has the
bits of a launch of that fold alone. ``stream_block`` under
``torch.func.vmap`` over weights (cross-validation's stacked step,
gaitpd_torch/train/vmap_cv.py) becomes that one launch through
``_StreamBlockFunction``'s vmap rule, and autograd outside the vmap reaches
the fold-stacked backward.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from gaitpd_torch.models.blocks import adaptive_avg_pool_matrix

ACTIVATIONS = {"relu": 0, "gelu": 1}

# The forward's variants, numbered as csrc/stream_block.cu takes them: one
# warp a window with the main path's sizes compiled in (TILE_SIZES, C_in in
# TILE_CIN), the same sizes at any C_in streamed through shared memory in
# chunks (FOCAL's 320 channels), one window a block with each conv output
# computed once (per_frame) for every other size whose block fits
# MAX_SMEM_BYTES, and the first design (generic) for the rest.
WARP_TILE, GENERIC, WIDE, PER_FRAME = range(4)
VARIANT_NAMES = ("warp_tile", "generic", "wide", "per_frame")
# The backward's: the generic kernel (a tile of whole windows a block,
# zero-cotangent windows skipped) for every size but the wide ones.
BWD_GENERIC, BWD_WIDE = range(2)
BACKWARD_VARIANT_NAMES = ("generic", "wide")
# (T, C_out, K, t_out) and the C_in of the warp_tile variant: the flagship's,
# late fusion's and the cheap cross-attention's backbone (12), the shared
# latent (16) and early fusion (36)
TILE_SIZES = (64, 16, 3, 8)
TILE_CIN = (12, 16, 36)
# The C_in from which ``_variant`` and ``_backward_variant`` take the wide
# variants (warp_tile keeps its own C_in); the kernels themselves take any
# C_in at TILE_SIZES. From 17 to 63 the wide forward took 0.87-0.43x of
# per_frame's time and the wide backward 0.65-0.27x of the generic one's,
# at batch 1024 under ReLU and GELU (chip_smoke.py::time_wide_threshold,
# NVIDIA H100 80GB HBM3, 700 W).
WIDE_MIN_CIN = 17
# the shared memory a block may use on the H100 (227 KB)
MAX_SMEM_BYTES = 227 * 1024

# Kernel launches made by ``stream_block`` and ``stream_block_backward``,
# and of those the wide variants'; callers may reset them to 0.
launches = 0
backward_launches = 0
wide_launches = 0
wide_backward_launches = 0
# Of those, the fold-stacked launches (``stream_block_folds`` and its
# backward), whatever their variant.
fold_launches = 0
fold_backward_launches = 0

_bound = None


def _activate(y: torch.Tensor, act: str) -> torch.Tensor:
    return torch.relu(y) if act == "relu" else F.gelu(y)


def stream_block_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           t_out: int = 8, act: str = "relu") -> torch.Tensor:
    """Plain PyTorch version, the same arithmetic as the reference: k shifted
    products over the zero-padded stream, bias, activation, then the product
    with the constant pooling matrix.

    x: (B, T, C_in); w: (K, C_in, C_out); b: (C_out,) -> (B, t_out, C_out)."""
    k = w.shape[0]
    pad = k // 2
    t = x.shape[1]
    xp = F.pad(x, (0, 0, pad, pad))
    y = torch.zeros(x.shape[:2] + (w.shape[-1],), dtype=x.dtype, device=x.device)
    for i in range(k):
        y = y + torch.einsum("btc,cf->btf", xp[:, i : i + t, :], w[i])
    y = _activate(y + b[None, None, :], act)
    pool = adaptive_avg_pool_matrix(t, t_out, x.device)
    return torch.einsum("btf,to->bof", y, pool)


def stream_block_backward_reference(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
    t_out: int = 8, act: str = "relu",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward: autograd of ``stream_block_reference``
    for the cotangent g (B, t_out, C_out). Returns (gx, gw, gb)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, w, b)]
        out = stream_block_reference(*leaves, t_out, act)
        return torch.autograd.grad(out, leaves, g)


def _per_frame_bytes(t: int, cin: int, cout: int, k: int) -> int:
    """Shared memory of a per_frame block (csrc/stream_block.cu::FrameLayout):
    the window's T + K - 1 padded frames, w, b and y (T, C_out), C_in and
    C_out padded to multiples of 4, a frame's stride an odd number of float4."""
    cin4, cout4 = -(-cin // 4) * 4, -(-cout // 4) * 4
    stride = cin4 if (cin4 // 4) % 2 else cin4 + 4
    return 4 * ((t + k - 1) * stride + k * cin4 * cout4 + cout4 + t * cout4)


def _variant(t: int, cin: int, cout: int, k: int, t_out: int) -> int:
    """The forward kernel's variant for windows of (T, C_in), w (K, C_in,
    C_out) and t_out bins."""
    if (t, cout, k, t_out) == TILE_SIZES:
        if cin in TILE_CIN:
            return WARP_TILE
        if cin >= WIDE_MIN_CIN:
            return WIDE
    return PER_FRAME if _per_frame_bytes(t, cin, cout, k) <= MAX_SMEM_BYTES else GENERIC


def _backward_variant(t: int, cin: int, cout: int, k: int, t_out: int) -> int:
    """The backward's variant for the same sizes."""
    if (t, cout, k, t_out) == TILE_SIZES and cin >= WIDE_MIN_CIN:
        return BWD_WIDE
    return BWD_GENERIC


def _bind(lib: ctypes.CDLL):
    """The C interface of a built csrc/stream_block.cu: (forward, backward
    rows, backward, backward config, forward config)."""
    fwd = lib.stream_block_forward
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    fwd_config = lib.stream_block_forward_config
    fwd_config.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)] * 5
    fwd_config.restype = ctypes.c_int
    rows = lib.stream_block_backward_rows
    rows.argtypes = [ctypes.c_int] * 7
    rows.restype = ctypes.c_int
    bwd = lib.stream_block_backward
    bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    config = lib.stream_block_backward_config
    config.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)]
    config.restype = ctypes.c_int
    return fwd, rows, bwd, config, fwd_config


def _library():
    global _bound
    if _bound is None:
        from gaitpd_torch.ops import _build

        _bound = _bind(_build.load("stream_block"))
    return _bound


def _check(x, w, b, t_out, act):
    if act not in ACTIVATIONS:
        raise ValueError(f"act must be one of {sorted(ACTIVATIONS)}, got {act!r}")
    if x.dim() != 3 or w.dim() != 3 or b.dim() != 1:
        raise ValueError("expected x (B, T, C_in), w (K, C_in, C_out), b (C_out,)")
    k, cin, cout = w.shape
    if x.shape[2] != cin or b.shape[0] != cout:
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    if k % 2 != 1:
        raise ValueError(f"kernel size must be odd ('SAME' padding), got {k}")
    if t_out < 1 or x.shape[1] < 1:
        raise ValueError(f"need T >= 1 and t_out >= 1, got T={x.shape[1]}, t_out={t_out}")


def _check_folds(x, w, b, t_out, act) -> int:
    """The fold count F of fold-stacked x (F·B, T, C_in), w (F, K, C_in,
    C_out) and b (F, C_out); raises where they do not agree."""
    if w.dim() != 4 or b.dim() != 2 or w.shape[0] != b.shape[0] or w.shape[0] < 1:
        raise ValueError("expected w (F, K, C_in, C_out) and b (F, C_out) of one fold count, "
                         f"got w {tuple(w.shape)}, b {tuple(b.shape)}")
    folds = w.shape[0]
    if x.dim() != 3 or x.shape[0] % folds != 0:
        raise ValueError(f"x {tuple(x.shape)} is not (F·B, T, C_in) for F = {folds} folds")
    _check(x[: x.shape[0] // folds], w[0], b[0], t_out, act)
    return folds


def _check_cuda(name, tensors):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors must lie on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name} takes float32, got {[t.dtype for t in tensors]}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")


def _sizes(x, w):
    """(folds, windows a fold, T, C_in, K, C_out) of x and a 3-D or
    fold-stacked 4-D w."""
    folds = w.shape[0] if w.dim() == 4 else 1
    k, cin, cout = w.shape[-3:]
    return folds, x.shape[0] // folds, x.shape[1], cin, k, cout


def _forward_kernel(x, w, b, t_out, act, variant=None):
    """The forward kernel of ``variant`` (by default ``_variant``'s), over
    the folds of a 4-D w."""
    global launches, wide_launches, fold_launches
    folds, bsz, t, cin, k, cout = _sizes(x, w)
    if variant is None:
        variant = _variant(t, cin, cout, k, t_out)
    out = torch.empty((folds * bsz, t_out, cout), dtype=torch.float32, device=x.device)
    fwd = _library()[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                  folds, bsz, t, cin, cout, k, t_out, ACTIVATIONS[act], variant, stream)
    if err != 0:
        raise RuntimeError(f"stream_block kernel launch failed: cudaError_t {err} "
                           f"(x {tuple(x.shape)}, w {tuple(w.shape)}, t_out {t_out})")
    launches += 1
    wide_launches += variant == WIDE
    fold_launches += w.dim() == 4
    return out


def _batched(t: torch.Tensor) -> bool:
    """Whether ``t`` is a tensor of a ``torch.func.vmap`` level."""
    return torch._C._functorch.is_batchedtensor(t)


class _StreamBlockFunction(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient. Saves
    only x, w and b: the backward recomputes the convolution. Under
    ``torch.func.vmap`` its vmap rule makes one launch for the whole vmap
    axis: over the windows of every entry where the weights are shared, over
    fold-stacked weights (``stream_block_folds``) where they are not."""

    @staticmethod
    def forward(x, w, b, t_out, act):
        return _forward_kernel(x, w, b, t_out, act)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, b, t_out, act = inputs
        ctx.save_for_backward(x, w, b)
        ctx.t_out, ctx.act = t_out, act

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        backward = stream_block_folds_backward if w.dim() == 4 else stream_block_backward
        gx, gw, gb = backward(x, w, b, g.contiguous(), ctx.t_out, ctx.act)
        return gx, gw, gb, None, None

    @staticmethod
    def vmap(info, in_dims, x, w, b, t_out, act):
        n = info.batch_size
        x_dim, w_dim, b_dim = in_dims[:3]
        xs = x.movedim(x_dim, 0) if x_dim is not None else x.expand(n, *x.shape)
        bsz, t, cin = xs.shape[1:]
        flat = xs.reshape(n * bsz, t, cin).contiguous()
        if w_dim is None and b_dim is None:
            out = stream_block(flat, w, b, t_out, act)
        else:
            ws = w.movedim(w_dim, 0) if w_dim is not None else w.expand(n, *w.shape)
            bs = b.movedim(b_dim, 0) if b_dim is not None else b.expand(n, *b.shape)
            out = stream_block_folds(flat, ws.contiguous(), bs.contiguous(), t_out, act)
        return out.reshape(n, bsz, t_out, out.shape[-1]), 0


def stream_block(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 t_out: int = 8, act: str = "relu") -> torch.Tensor:
    """x: (B, T, C_in); w: (K, C_in, C_out); b: (C_out,) -> (B, t_out, C_out).

    CPU tensors take ``stream_block_reference``; CUDA tensors launch the
    kernel, through ``_StreamBlockFunction`` where a gradient is needed or
    under ``torch.func.vmap``, or raise."""
    _check(x, w, b, t_out, act)
    if x.device.type == "cpu":
        return stream_block_reference(x, w, b, t_out, act)
    if any(_batched(t) for t in (x, w, b)):
        return _StreamBlockFunction.apply(x, w, b, t_out, act)
    _check_cuda("stream_block", (x, w, b))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b)):
        return _StreamBlockFunction.apply(x, w, b, t_out, act)
    return _forward_kernel(x, w, b, t_out, act)


def stream_block_folds_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                                 t_out: int = 8, act: str = "relu") -> torch.Tensor:
    """Plain version of ``stream_block_folds``: ``stream_block_reference``
    over each fold."""
    xs = x.reshape(w.shape[0], -1, *x.shape[1:])
    return torch.cat([stream_block_reference(xf, wf, bf, t_out, act)
                      for xf, wf, bf in zip(xs, w, b)])


def stream_block_folds(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       t_out: int = 8, act: str = "relu") -> torch.Tensor:
    """F folds' stream blocks: x (F·B, T, C_in), fold-major; w (F, K, C_in,
    C_out); b (F, C_out) -> (F·B, t_out, C_out), fold f's windows through
    w[f], b[f].

    CPU tensors take ``stream_block_folds_reference``; CUDA tensors launch
    the kernel once for all folds (through ``_StreamBlockFunction`` where a
    gradient is needed), or raise."""
    _check_folds(x, w, b, t_out, act)
    if x.device.type == "cpu":
        return stream_block_folds_reference(x, w, b, t_out, act)
    _check_cuda("stream_block_folds", (x, w, b))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b)):
        return _StreamBlockFunction.apply(x, w, b, t_out, act)
    return _forward_kernel(x, w, b, t_out, act)


def forward_config(bsz: int, t: int, cin: int, cout: int, k: int, t_out: int,
                   act: str = "relu", folds: int = 1) -> dict:
    """The launch that ``stream_block`` makes for x (B, T, C_in), w (K, C_in,
    C_out) and t_out bins on the current card (``stream_block_folds``, with
    ``folds`` folds of B windows): the variant, threads a block, dynamic
    shared memory in bytes, the blocks an SM holds at once (CUDA's occupancy
    calculator), the blocks of the grid (all folds'), the windows a block,
    and the waves (blocks over the blocks the card holds at once). Needs a
    card."""
    variant = _variant(t, cin, cout, k, t_out)
    out = [ctypes.c_int(0) for _ in range(5)]
    err = _library()[4](variant, folds, bsz, t, cin, cout, k, t_out, ACTIVATIONS[act],
                        *(ctypes.byref(v) for v in out))
    if err != 0:
        raise RuntimeError(f"stream_block_forward_config failed: cudaError_t {err}")
    config = dict(variant=VARIANT_NAMES[variant],
                  **dict(zip(("threads", "smem_bytes", "blocks_per_sm", "blocks", "windows"),
                             (v.value for v in out))))
    config["waves"] = _waves(config["blocks"], config["blocks_per_sm"])
    return config


def _waves(blocks: int, blocks_per_sm: int) -> float:
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    return blocks / (max(1, blocks_per_sm) * sms)


def backward_config(bsz: int, t: int, cin: int, cout: int, k: int, t_out: int,
                    act: str = "relu", folds: int = 1) -> dict:
    """The launch that ``stream_block_backward`` makes for x (B, T, C_in), w
    (K, C_in, C_out) and t_out bins on the current card (with ``folds``
    folds of B windows, ``stream_block_folds_backward``'s): the variant,
    threads a block, dynamic shared memory in bytes, the blocks an SM holds
    at once (CUDA's occupancy calculator), the blocks of the grid (all
    folds'), the windows a block (the wide variant: of its largest window
    range), and the waves; for the wide variant also its first kernel's
    launch (``gz``: the conv and g_z). Needs a card."""
    variant = _backward_variant(t, cin, cout, k, t_out)
    out = (ctypes.c_int * 9)()
    err = _library()[3](variant, folds, bsz, t, cin, cout, k, t_out, ACTIVATIONS[act], out)
    if err != 0:
        raise RuntimeError(f"stream_block_backward_config failed: cudaError_t {err}")
    config = dict(variant=BACKWARD_VARIANT_NAMES[variant],
                  **dict(zip(("threads", "smem_bytes", "blocks_per_sm", "blocks", "windows"),
                             out[:5])))
    config["waves"] = _waves(config["blocks"], config["blocks_per_sm"])
    if variant == BWD_WIDE:
        gz = dict(zip(("windows", "smem_bytes", "blocks_per_sm", "blocks"), out[5:]))
        gz["waves"] = _waves(gz["blocks"], gz["blocks_per_sm"])
        config["gz"] = gz
    return config


def stream_block_backward(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
    t_out: int = 8, act: str = "relu",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gx, gw, gb), the VJP of ``stream_block`` at (x, w, b) for the
    cotangent g (B, t_out, C_out).

    CPU tensors take ``stream_block_backward_reference``; CUDA tensors launch
    the backward kernel of ``_backward_variant`` (deterministic: no float
    atomics; the generic variant skips windows whose cotangent is all zero
    and whose x is finite, exactly) or raise."""
    _check(x, w, b, t_out, act)
    bsz, t, cin = x.shape
    k, _, cout = w.shape
    if tuple(g.shape) != (bsz, t_out, cout):
        raise ValueError(f"cotangent shape {tuple(g.shape)} != {(bsz, t_out, cout)}")
    if x.device.type == "cpu":
        return stream_block_backward_reference(x, w, b, g, t_out, act)
    _check_cuda("stream_block_backward", (x, w, b, g))
    if bsz == 0:
        return torch.zeros_like(x), torch.zeros_like(w), torch.zeros_like(b)
    return _backward_kernel(x, w, b, g, t_out, act)


def stream_block_folds_backward_reference(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
    t_out: int = 8, act: str = "relu",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``stream_block_folds_backward``:
    ``stream_block_backward_reference`` over each fold."""
    folds = w.shape[0]
    xs, gs = x.reshape(folds, -1, *x.shape[1:]), g.reshape(folds, -1, *g.shape[1:])
    parts = [stream_block_backward_reference(xf, wf, bf, gf, t_out, act)
             for xf, wf, bf, gf in zip(xs, w, b, gs)]
    gx, gw, gb = zip(*parts)
    return torch.cat(gx), torch.stack(gw), torch.stack(gb)


def stream_block_folds_backward(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
    t_out: int = 8, act: str = "relu",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gx (F·B, T, C_in), gw (F, K, C_in, C_out), gb (F, C_out)), the VJP of
    ``stream_block_folds`` for the cotangent g (F·B, t_out, C_out): each
    fold's gw and gb sum over its own windows only.

    CPU tensors take ``stream_block_folds_backward_reference``; CUDA tensors
    launch the backward kernel once for all folds, or raise."""
    folds = _check_folds(x, w, b, t_out, act)
    if tuple(g.shape) != (x.shape[0], t_out, w.shape[-1]):
        raise ValueError(f"cotangent shape {tuple(g.shape)} != "
                         f"{(x.shape[0], t_out, w.shape[-1])}")
    if x.device.type == "cpu":
        return stream_block_folds_backward_reference(x, w, b, g, t_out, act)
    _check_cuda("stream_block_folds_backward", (x, w, b, g))
    if x.shape[0] // folds == 0:
        return torch.zeros_like(x), torch.zeros_like(w), torch.zeros_like(b)
    return _backward_kernel(x, w, b, g, t_out, act)


def _backward_kernel(x, w, b, g, t_out, act, variant=None):
    """The backward kernel of ``variant`` (by default ``_backward_variant``'s)
    on checked CUDA tensors, over the folds of a 4-D w."""
    global backward_launches, wide_backward_launches, fold_backward_launches
    folds, bsz, t, cin, k, cout = _sizes(x, w)
    _, rows_of, bwd, _, _ = _library()
    if variant is None:
        variant = _backward_variant(t, cin, cout, k, t_out)
    rows = rows_of(variant, bsz, t, cin, cout, k, t_out)
    if rows < 1:
        raise ValueError(f"stream_block_backward does not take x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, t_out {t_out}")
    gx = torch.empty_like(x)
    gw = torch.empty_like(w)
    gb = torch.empty_like(b)
    partial = torch.empty((folds * rows, k * cin * cout + cout), dtype=torch.float32,
                          device=x.device)
    # the wide variant's g_z (F·B, T, C_out), between its two kernels
    gz = (torch.empty((folds * bsz, t, cout), dtype=torch.float32, device=x.device)
          if variant == BWD_WIDE else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = bwd(x.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(), gx.data_ptr(),
                  gw.data_ptr(), gb.data_ptr(), partial.data_ptr(),
                  None if gz is None else gz.data_ptr(),
                  folds, bsz, t, cin, cout, k, t_out, ACTIVATIONS[act], variant, stream)
    if err != 0:
        raise RuntimeError(f"stream_block backward kernel launch failed: cudaError_t {err} "
                           f"(x {tuple(x.shape)}, w {tuple(w.shape)}, t_out {t_out})")
    backward_launches += 1
    wide_backward_launches += variant == BWD_WIDE
    fold_backward_launches += w.dim() == 4
    return gx, gw, gb
