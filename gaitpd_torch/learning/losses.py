"""Classification losses as functions of tensors, with valid-sample masks.
Port of gaitpd/learning/losses.py:24-203.

Class-count state is precomputed margin and weight tensors; GCL's
half-normal noise comes from an explicit ``torch.Generator``. Every loss
takes an optional ``valid`` (B,) mask so padded batches contribute exactly
zero.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from gaitpd_torch.runtime import fold_draws

EPS = 1e-8

_BATCH_TOTAL: contextvars.ContextVar = contextvars.ContextVar("batch_total", default=None)


@contextlib.contextmanager
def sharded_batch(total: Callable[[torch.Tensor], torch.Tensor]) -> Iterator[None]:
    """Within, each loss divides by ``total`` of its local normaliser (the
    valid count, the class-weight sum): with a data-parallel step's sum over
    the mesh (gaitpd_torch/runtime/mesh.py::BatchSharding.sum), a rank's loss
    is its rows' share of the global batch's loss, and the ranks' losses and
    gradients add up to the single-process step's."""
    token = _BATCH_TOTAL.set(total)
    try:
        yield
    finally:
        _BATCH_TOTAL.reset(token)


def _total(t: torch.Tensor) -> torch.Tensor:
    total = _BATCH_TOTAL.get()
    return t if total is None else total(t)


def _masked_mean(x: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is None and _BATCH_TOTAL.get() is None:
        return x.mean()
    valid = torch.ones_like(x) if valid is None else valid.to(x.dtype)
    return (x * valid).sum() / torch.clamp(_total(valid.sum()), min=1.0)


def _weighted_nll(logits, labels, weight, valid):
    """torch F.cross_entropy semantics: with a class-weight vector the mean is
    sum(w[y_i] * nll_i) / sum(w[y_i])."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None].long())[:, 0]
    if weight is None and valid is None and _BATCH_TOTAL.get() is None:
        return nll.mean()
    w = torch.ones_like(nll) if weight is None else weight[labels.long()]
    if valid is not None:
        w = w * valid.to(nll.dtype)
    return (w * nll).sum() / torch.clamp(_total(w.sum()), min=EPS)


def cross_entropy(logits, labels, weight=None, valid=None):
    """Plain / class-weighted CE (reference train/utilities.py:144-152)."""
    return _weighted_nll(logits, labels, weight, valid)


def label_smoothing_ce(logits, labels, smoothing: float = 0.1, valid=None):
    """KL(log_softmax || smoothed one-hot), batchmean reduction.
    reference classification_losses.py:9-19."""
    c = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), c).to(logp.dtype)
    t = (1.0 - smoothing) * onehot + smoothing / c
    kl = (t * (torch.log(t + EPS) - logp)).sum(-1)
    return _masked_mean(kl, valid)


def weighted_label_smoothing_ce(logits, labels, weight, smoothing: float = 0.1, valid=None):
    """reference classification_losses.py:22-35: the per-class weight
    multiplies the KL columns, then the sum over classes and the mean over
    the batch."""
    c = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), c).to(logp.dtype)
    t = (1.0 - smoothing) * onehot + smoothing / c
    kl = t * (torch.log(t + EPS) - logp) * weight[None, :]
    return _masked_mean(kl.sum(-1), valid)


def focal_loss(logits, labels, gamma: float = 0.0, weight=None, valid=None):
    """reference classification_losses.py:38-52: the focal factor applied to
    the per-sample CE values, then the mean."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None].long())[:, 0]
    if weight is not None:
        nll = nll * weight[labels.long()]
    p = torch.exp(-nll)
    return _masked_mean((1.0 - p) ** gamma * nll, valid)


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
    train_cls: bool = False,
    gamma: float = 0.0,
):
    """Gaussian-clouded logit loss. reference classification_losses.py:97-109.

    cosine' = cosine - noise_mul * |clip(N(0, 1/3), -1, 1)| / max(m_list) * m_list
    then subtract the target margin ``m`` and apply (weighted) CE on s*out,
    or with ``train_cls`` the focal loss of factor ``gamma``.
    The noise is drawn from ``generator`` (on the logits' device; a
    gaitpd_torch.runtime.fold_draws.FoldDraws under the stacked folds'
    vmap); with ``noise_mul == 0`` none is drawn and the loss is exactly
    the noise-free one.

    Deviation from the reference, kept from gaitpd: the reference divides by
    ``m_list.max()`` unguarded, which is NaN for perfectly balanced class
    counts; the denominator is guarded with EPS (identical whenever counts
    differ).
    """
    cosine = logits
    if noise_mul != 0:
        noise = fold_draws.randn(logits.shape, generator, dtype=logits.dtype,
                                 device=logits.device) * (1.0 / 3.0)
        noise = torch.abs(torch.clamp(noise, -1.0, 1.0))
        denom = torch.clamp(m_list.max(), min=EPS)
        cosine = logits - noise_mul * noise / denom * m_list[None, :]
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(torch.bool)
    out = torch.where(onehot, cosine - m, cosine)
    if train_cls:
        return focal_loss(s * out, labels, gamma=gamma, weight=weight, valid=valid)
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


def log_based_weights(counts: Sequence[int], div: float) -> torch.Tensor:
    """reference train/utilities.py:134-141."""
    c = np.asarray(counts, dtype=np.float32)
    raw = np.log(c.max() / c + 0.01) / div
    raw = np.clip(raw, 0.0, None)
    if raw.sum() > 0:
        raw = raw / raw.sum() * len(raw)
    return torch.as_tensor(raw, dtype=torch.float32)


def drw_weight_schedule(counts: Sequence[int], epoch: int, warmup: int,
                        after: str = "eq") -> torch.Tensor:
    """Deferred re-weighting as a function of the epoch: ones before
    ``warmup``, inverse-frequency weights from it on (``after="eq"``, the
    FBG/FoG driver's switch, reference train/utilities.py:197-202) or after
    it (``"gt"``). The epoch is a host number, so no device value is read."""
    w_after = inv_freq_weights(counts)
    on = epoch >= warmup if after == "eq" else epoch > warmup
    return w_after if on else torch.ones_like(w_after)
