"""Attention ops: zero-parameter cheap cross-attention and the generic
projected cross-attention core. Port of gaitpd/ops/attention.py.

The cheap cross-attention goes through ``gaitpd_torch.ops.cheap_xattn``: the
hand-written kernels on the card, the plain version on the CPU. Several
directions of one call share one launch: the problems are concatenated along
the batch, and autograd routes the gradients back through the
concatenation. ``scaled_cross_attention`` is a product that the reference
leaves to XLA, so it stays in torch.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import torch

from gaitpd_torch.ops.cheap_xattn import cheap_xattn


def cheap_cross_attention(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One-directional variant: softmax(ABᵀ/√d) B, a (B, Tq, d), b (B, Tk, d).
    reference gaitpd/ops/attention.py:45-53."""
    return cheap_xattn(a.contiguous(), b.contiguous())


def cheap_cross_attention_sym(s: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Symmetric zero-parameter fusion of two (B, T, d) sequences:
    0.5*(softmax(SGᵀ/√d)G + softmax(GSᵀ/√d)S), both directions in one call.
    reference gaitpd/ops/attention.py:32-42."""
    both = cheap_cross_attention(torch.cat([s, g]), torch.cat([g, s]))
    s_star, g_star = both.split(s.shape[0])
    return 0.5 * (s_star + g_star)


def scaled_cross_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    n_heads: int,
    scale_mul: Union[float, torch.Tensor] = 1.0,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head cross-attention core on already-projected q/k/v
    (B, T, d_att): split heads, softmax(scale_mul * qkᵀ/√dk) v, merge heads.
    ``kv_mask`` (B, Tk): key positions where it is 0 get no weight.
    reference gaitpd/ops/attention.py:56-84."""
    b, tq, da = q.shape
    tk = k.shape[1]
    dk = da // n_heads

    def split(x, t):
        return x.reshape(b, t, n_heads, dk).transpose(1, 2)

    qh, kh, vh = split(q, tq), split(k, tk), split(v, tk)
    sqrt_dk = torch.full((), dk, dtype=q.dtype, device=q.device).sqrt()
    logits = torch.einsum("bhtd,bhsd->bhts", qh, kh) / sqrt_dk
    if kv_mask is not None:
        logits = torch.where(kv_mask[:, None, None, :] == 0, -math.inf, logits)
    attn = torch.softmax(scale_mul * logits, dim=-1)
    out = torch.einsum("bhts,bhsd->bhtd", attn, vh)
    return out.transpose(1, 2).reshape(b, tq, da)


def masked_pairwise_enrichment(
    streams: Sequence[torch.Tensor],
    mask: Optional[Union[torch.Tensor, Sequence[bool]]] = None,
) -> List[torch.Tensor]:
    """Relaxed-input pairwise cheap cross-attention: stream i is enriched by
    the mean of cheap_cross_attention(i, j) over the *enabled* partners j.
    reference gaitpd/ops/attention.py:87-113.

    With mask None or all on this is the reference's CheapXAttn3 averaging;
    with a (K,) mask, disabled partners drop out of the average. The K(K-1)
    directed pairs go through one cheap_cross_attention call when the
    streams share a shape, and the averaging keeps the reference's order:
    acc + m_j * x over j, then / max(count, 1)."""
    k = len(streams)
    ref = streams[0]
    if mask is None:  # made on the device: a host copy would synchronise
        mask_f = torch.ones(k, dtype=ref.dtype, device=ref.device)
    else:
        mask_f = torch.as_tensor(mask).to(dtype=ref.dtype, device=ref.device)
    pairs = [(i, j) for i in range(k) for j in range(k) if i != j]
    if len({tuple(s.shape) for s in streams}) == 1:
        attended = cheap_cross_attention(torch.cat([streams[i] for i, _ in pairs]),
                                         torch.cat([streams[j] for _, j in pairs]))
        attended = dict(zip(pairs, attended.split(ref.shape[0])))
    else:
        attended = {(i, j): cheap_cross_attention(streams[i], streams[j]) for i, j in pairs}
    out = []
    for i in range(k):
        acc = torch.zeros_like(streams[i])
        cnt = torch.zeros((), dtype=streams[i].dtype, device=streams[i].device)
        for j in range(k):
            if i == j:
                continue
            acc = acc + mask_f[j] * attended[(i, j)]
            cnt = cnt + mask_f[j]
        out.append(acc / torch.clamp(cnt, min=1.0))
    return out
