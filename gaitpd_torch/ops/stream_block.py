"""Fused stream block: Conv1d(k, 'SAME') + bias + activation +
AdaptiveAvgPool1d(t_out), the whole SharedBackbone in one op.

Port of gaitpd/ops/pallas_blocks.py:55-69 (the jnp reference) and
:142-176 (the Pallas TPU kernel). On a CUDA tensor ``stream_block`` launches
the hand-written kernel gaitpd_torch/csrc/stream_block.cu and counts the
launch in ``launches``; on a CPU tensor it takes the plain version,
``stream_block_reference``. There is no fallback from one to the other.

Forward only: the kernel has no backward yet, so the wrapper refuses a CUDA
input that needs a gradient rather than return a result detached from it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gaitpd_torch.models.blocks import adaptive_avg_pool_matrix

ACTIVATIONS = {"relu": 0, "gelu": 1}

# Kernel launches made by ``stream_block``; callers may reset it to 0.
launches = 0

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


def _library():
    global _bound
    if _bound is None:
        from gaitpd_torch.ops import _build

        lib = _build.load("stream_block")
        fn = lib.stream_block_forward
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound = fn
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


def stream_block(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 t_out: int = 8, act: str = "relu") -> torch.Tensor:
    """x: (B, T, C_in); w: (K, C_in, C_out); b: (C_out,) -> (B, t_out, C_out).

    CPU tensors take ``stream_block_reference``; CUDA tensors launch the
    kernel or raise."""
    global launches
    _check(x, w, b, t_out, act)
    if x.device.type == "cpu":
        return stream_block_reference(x, w, b, t_out, act)
    tensors = (x, w, b)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"x, w, b must lie on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"stream_block takes float32, got {[t.dtype for t in tensors]}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("stream_block takes contiguous tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the stream_block kernel has no backward yet; "
                           "call it under torch.no_grad()")
    bsz, t, cin = x.shape
    k, _, cout = w.shape
    out = torch.empty((bsz, t_out, cout), dtype=torch.float32, device=x.device)
    fn = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                 bsz, t, cin, cout, k, t_out, ACTIVATIONS[act], stream)
    if err != 0:
        raise RuntimeError(f"stream_block kernel launch failed: cudaError_t {err} "
                           f"(x {tuple(x.shape)}, w {tuple(w.shape)}, t_out {t_out})")
    launches += 1
    return out
