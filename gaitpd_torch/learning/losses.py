"""Classification losses as functions of tensors, with valid-sample masks.
Port of gaitpd/learning/losses.py:24-53,95-152,160-203.

Class-count state is precomputed margin and weight tensors; GCL's
half-normal noise comes from an explicit ``torch.Generator``. Every loss
takes an optional ``valid`` (B,) mask so padded batches contribute exactly
zero. ``label_smoothing_ce``, ``focal_loss`` and the other losses of the
reference that no WearGait path calls wait for the paths that call them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-8


def _masked_mean(x: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is None:
        return x.mean()
    valid = valid.to(x.dtype)
    return (x * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def _weighted_nll(logits, labels, weight, valid):
    """torch F.cross_entropy semantics: with a class-weight vector the mean is
    sum(w[y_i] * nll_i) / sum(w[y_i])."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None].long())[:, 0]
    if weight is None and valid is None:
        return nll.mean()
    w = torch.ones_like(nll) if weight is None else weight[labels.long()]
    if valid is not None:
        w = w * valid.to(nll.dtype)
    return (w * nll).sum() / torch.clamp(w.sum(), min=EPS)


def cross_entropy(logits, labels, weight=None, valid=None):
    """Plain / class-weighted CE (reference train/utilities.py:144-152)."""
    return _weighted_nll(logits, labels, weight, valid)


def ldam_margins(cls_num_list, max_m: float = 0.5) -> torch.Tensor:
    """m_j = max_m * n_j^{-1/4} / max_k n_k^{-1/4}.
    reference classification_losses.py:58-59."""
    n = np.asarray(cls_num_list, dtype=np.float64)
    m = 1.0 / np.sqrt(np.sqrt(np.maximum(n, 1.0)))
    m = m * (max_m / m.max())
    return torch.as_tensor(m, dtype=torch.float32)


def ldam_loss(logits, labels, m_list, s: float = 30.0, weight=None, valid=None):
    """LDAM margin loss: subtract the class margin at the target index, scale
    by s, then (weighted) CE. reference classification_losses.py:66-76."""
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(torch.bool)
    out = torch.where(onehot, logits - m_list[labels.long()][:, None], logits)
    return _weighted_nll(s * out, labels, weight, valid)


def gcl_margins(cls_num_list) -> torch.Tensor:
    """m_j = max_k log(n_k) - log(n_j). reference classification_losses.py:83-85."""
    n = np.asarray(cls_num_list, dtype=np.float64)
    logn = np.log(np.maximum(n, 1.0))
    return torch.as_tensor(logn.max() - logn, dtype=torch.float32)


def gcl_loss(
    logits,
    labels,
    m_list,
    generator: Optional[torch.Generator] = None,
    m: float = 0.5,
    s: float = 30.0,
    noise_mul: float = 1.0,
    weight=None,
    valid=None,
):
    """Gaussian-clouded logit loss. reference classification_losses.py:97-109.

    cosine' = cosine - noise_mul * |clip(N(0, 1/3), -1, 1)| / max(m_list) * m_list
    then subtract the target margin ``m`` and apply (weighted) CE on s*out.
    The noise is drawn from ``generator`` (on the logits' device); with
    ``noise_mul == 0`` none is drawn and the loss is exactly the noise-free
    one.

    Deviation from the reference, kept from gaitpd: the reference divides by
    ``m_list.max()`` unguarded, which is NaN for perfectly balanced class
    counts; the denominator is guarded with EPS (identical whenever counts
    differ).
    """
    cosine = logits
    if noise_mul != 0:
        noise = torch.randn(logits.shape, dtype=logits.dtype, device=logits.device,
                            generator=generator) * (1.0 / 3.0)
        noise = torch.abs(torch.clamp(noise, -1.0, 1.0))
        denom = torch.clamp(m_list.max(), min=EPS)
        cosine = logits - noise_mul * noise / denom * m_list[None, :]
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(torch.bool)
    out = torch.where(onehot, cosine - m, cosine)
    return _weighted_nll(s * out, labels, weight, valid)


def symmetric_kl_consistency(logits_a, logits_b, valid=None):
    """Symmetric KL between the two heads' predictive distributions,
    batchmean reduction. reference train/fbg_fog_train.py:81-89."""
    logp_a = F.log_softmax(logits_a, dim=-1)
    logp_b = F.log_softmax(logits_b, dim=-1)
    p_a = torch.exp(logp_a)
    p_b = torch.exp(logp_b)
    kl1 = (p_b * (torch.log(p_b + EPS) - logp_a)).sum(-1)
    kl2 = (p_a * (torch.log(p_a + EPS) - logp_b)).sum(-1)
    return _masked_mean(kl1, valid) + _masked_mean(kl2, valid)


def inv_freq_weights(counts: Sequence[int]) -> torch.Tensor:
    """w_j = (1/(n_j+eps)) normalised to sum to n_classes.
    reference train/utilities.py:129-131."""
    c = torch.as_tensor(np.asarray(counts), dtype=torch.float32)
    w = 1.0 / (c + EPS)
    return w / w.sum() * c.shape[0]
