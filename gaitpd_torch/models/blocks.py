"""Layers shared by the port's models. Port of gaitpd/models/blocks.py:34-190.

Streams stay time-major, (B, T, C), at every public function, as in the
reference. Submodules carry the flax modules' names (``Conv1dSame_0``,
``LayerNorm_0``, ...) so that gaitpd_torch.params maps a flax variables dict
onto them leaf by leaf.

Initialisers follow torch's defaults, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
kernel and bias, except where the reference names flax's own (``lecun_normal``,
``normal(0.02)``); every draw comes from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gaitpd_torch.runtime import fold_draws


# ---------------------------------------------------------------------------
# Initialisers (torch-law scales)
# ---------------------------------------------------------------------------


def uniform_param(shape, bound: float, generator: torch.Generator) -> nn.Parameter:
    """A parameter drawn from U(-bound, bound)."""
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=generator))


def torch_bound(fan_in: int) -> float:
    """1/sqrt(fan_in): torch's Linear/Conv1d default scale for kernel and bias."""
    return 1.0 / math.sqrt(max(1, fan_in))


# flax's truncated normal keeps draws within two standard deviations; this is
# the standard deviation of the unit normal so truncated, which flax divides by
TRUNCATED_NORMAL_STD = 0.87962566103423978


def lecun_normal_param(shape, fan_in: int, generator: torch.Generator) -> nn.Parameter:
    """flax's ``lecun_normal``: a normal truncated at two standard deviations,
    scaled to standard deviation 1/sqrt(fan_in) (fan_in = K * C_in for a
    conv kernel)."""
    std = math.sqrt(1.0 / max(1, fan_in)) / TRUNCATED_NORMAL_STD
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return nn.Parameter(t)


def normal_param(shape, std: float, generator: torch.Generator) -> nn.Parameter:
    """flax's ``normal(std)``."""
    return nn.Parameter(torch.empty(shape).normal_(0.0, std, generator=generator))


def default_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """The caller's generator, or a fresh one seeded 0."""
    return generator if generator is not None else torch.Generator().manual_seed(0)


# ---------------------------------------------------------------------------
# Adaptive average pooling as a constant matrix
# ---------------------------------------------------------------------------


def adaptive_avg_pool_matrix(t_in: int, t_out: int, device=None) -> torch.Tensor:
    """(t_in, t_out) matrix P with x_pooled = x^T P, matching
    torch.nn.AdaptiveAvgPool1d: bin i averages frames
    [floor(i*t_in/t_out), ceil((i+1)*t_in/t_out)). Bins overlap when t_out
    does not divide t_in. Built with tensor ops on ``device`` (entries
    1 / bin length, a float32 division): no copy from the host, so a train
    step on the card does not wait for one."""
    i = torch.arange(t_out, device=device)
    start = (i * t_in) // t_out
    end = -((-(i + 1) * t_in) // t_out)  # ceil
    t = torch.arange(t_in, device=device)[:, None]
    inside = ((t >= start) & (t < end)).to(torch.float32)
    return inside / (end - start).to(torch.float32)


def adaptive_avg_pool1d(x: torch.Tensor, t_out: int) -> torch.Tensor:
    """(B, T, C) -> (B, t_out, C)."""
    p = adaptive_avg_pool_matrix(x.shape[1], t_out, x.device)
    return torch.einsum("btc,to->boc", x, p)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


class Conv1dSame(nn.Module):
    """Conv1d(k, stride 1, 'SAME' padding) on (B, T, C) streams.

    ``weight`` is stored as torch stores it, (C_out, C_in, K); k must be odd,
    so that 'SAME' pads k//2 frames on each side."""

    FLAX_WRAPPER = "Conv_0"  # the flax module's inner nn.Conv (gaitpd_torch.params)

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, *,
                 generator: torch.Generator):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f"Conv1dSame needs an odd kernel, got {kernel_size}")
        bound = torch_bound(kernel_size * in_ch)
        self.weight = uniform_param((out_ch, in_ch, kernel_size), bound, generator)
        self.bias = uniform_param((out_ch,), bound, generator)

    @property
    def kernel_size(self) -> int:
        return self.weight.shape[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x.transpose(1, 2), self.weight, self.bias,
                     padding=self.kernel_size // 2)
        return y.transpose(1, 2)


class TorchLinear(nn.Module):
    """Dense layer with torch-default init scales; ``weight`` is (out, in).
    Without ``use_bias`` it has no ``bias`` parameter, as the flax tree has
    no such leaf."""

    FLAX_WRAPPER = "Dense_0"

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        bound = torch_bound(in_features)
        self.weight = uniform_param((out_features, in_features), bound, generator)
        if use_bias:
            self.bias = uniform_param((out_features,), bound, generator)
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class CosineLinear(nn.Module):
    """Normalised cosine classifier for GCL heads: L2-normalise features and
    class weights (torch F.normalize's max(norm, eps)), clip the cosine to
    (-1+eps, 1-eps). ``weight`` is (in, out), as the flax module keeps it."""

    def __init__(self, in_features: int, out_features: int, eps: float = 1e-8, *,
                 generator: torch.Generator):
        super().__init__()
        self.eps = eps
        bound = math.sqrt(6.0 / (in_features + out_features))  # xavier uniform
        self.weight = uniform_param((in_features, out_features), bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        x_norm = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                                 min=self.eps)
        w_norm = w / torch.clamp(torch.linalg.vector_norm(w, dim=0, keepdim=True),
                                 min=self.eps)
        return torch.clamp(x_norm @ w_norm, -1.0 + self.eps, 1.0 - self.eps)


class TaskHead(nn.Module):
    """Classification head: plain Linear (CE), LayerNorm+Linear (LDAM) or
    LayerNorm+CosineLinear (GCL)."""

    def __init__(self, in_features: int, num_classes: int, use_norm: bool = False,
                 use_cosine: bool = False, *, generator: torch.Generator):
        super().__init__()
        self.use_norm = use_norm or use_cosine
        self.use_cosine = use_cosine
        if self.use_norm:
            self.LayerNorm_0 = nn.LayerNorm(in_features, eps=1e-5)
        if use_cosine:
            self.CosineLinear_0 = CosineLinear(in_features, num_classes,
                                               generator=generator)
        else:
            self.TorchLinear_0 = TorchLinear(in_features, num_classes,
                                             generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_norm:
            x = self.LayerNorm_0(x)
        if self.use_cosine:
            return self.CosineLinear_0(x)
        return self.TorchLinear_0(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            train: bool) -> torch.Tensor:
    """flax's ``nn.Dropout``: keep each entry with probability 1 - rate and
    divide the kept ones by 1 - rate. The identity when ``train`` is False or
    the rate is 0; otherwise the mask is drawn from ``generator`` (on x's
    device; under the stacked folds' vmap a gaitpd_torch.runtime.fold_draws.
    FoldDraws), never from torch's global generator."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout at train time draws from a generator; got None")
    keep = 1.0 - rate
    mask = fold_draws.rand(x.shape, generator, device=x.device) < keep
    # a tensor divisor: CUDA divides by a Python number through its reciprocal
    return torch.where(mask, x / torch.full((), keep, dtype=x.dtype, device=x.device),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def flatten_features(x: torch.Tensor) -> torch.Tensor:
    """(B, bdim, C) -> (B, bdim*C), in (bdim, C) order as the reference, so
    head weights need no permutation."""
    return x.reshape(x.shape[0], -1)


def flatten_skel(x: torch.Tensor) -> torch.Tensor:
    """(B, T, J, C) -> (B, T, J*C); a 3-D input passes through
    (reference train/utilities.py:28-32)."""
    if x.dim() == 4:
        b, t, j, c = x.shape
        return x.reshape(b, t, j * c)
    return x
