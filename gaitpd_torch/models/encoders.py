"""Per-modality encoders and the shared temporal backbone.
Port of gaitpd/models/encoders.py:25-135, time-major (B, T, C)
throughout.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from gaitpd_torch.models.blocks import Conv1dSame, TorchLinear, adaptive_avg_pool1d, gelu
from gaitpd_torch.ops.stream_block import stream_block


class SensorEncoder(nn.Module):
    """Conv1d(k3, same) + AdaptiveAvgPool1d(output_length), the pool only
    when the input's length equals ``sensor_length`` (as the reference's
    data-shape-dependent branch)."""

    def __init__(self, in_ch: int, out_channels: int, sensor_length: Optional[int] = None,
                 output_length: int = 101, *, generator: torch.Generator):
        super().__init__()
        self.sensor_length = sensor_length
        self.output_length = output_length
        self.Conv1dSame_0 = Conv1dSame(in_ch, out_channels, 3, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv1dSame_0(x)
        if x.shape[1] == self.sensor_length:
            x = adaptive_avg_pool1d(x, self.output_length)
        return x


class SkeletonMLP(nn.Module):
    """Linear -> LayerNorm -> ReLU over each frame."""

    def __init__(self, in_features: int, output_dim: int, *, generator: torch.Generator):
        super().__init__()
        self.TorchLinear_0 = TorchLinear(in_features, output_dim, generator=generator)
        self.LayerNorm_0 = nn.LayerNorm(output_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.LayerNorm_0(self.TorchLinear_0(x)))


class SharedBackbone(nn.Module):
    """Conv1d(k3) -> ReLU -> AdaptiveAvgPool1d(bdim); (B,T,C) -> (B,bdim,C_out).

    The whole block is one ``stream_block`` call: the hand-written kernel on
    the card, its plain version on the CPU."""

    ACT = "relu"

    def __init__(self, in_ch: int, shared_out_channels: int = 16, backbone_dim: int = 8,
                 *, generator: torch.Generator):
        super().__init__()
        self.backbone_dim = backbone_dim
        self.Conv1dSame_0 = Conv1dSame(in_ch, shared_out_channels, 3, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.Conv1dSame_0
        # (C_out, C_in, K) -> the kernel's (K, C_in, C_out)
        w = conv.weight.permute(2, 1, 0).contiguous()
        return stream_block(x.contiguous(), w, conv.bias, self.backbone_dim, self.ACT)


class GELUBackbone(SharedBackbone):
    """Conv1d(k3) -> exact GELU -> AdaptiveAvgPool1d(bdim), FOCAL's backbone
    (gaitpd/models/encoders.py:72-83): the stream block's ``gelu`` path."""

    ACT = "gelu"


def backbone_streams(backbone: SharedBackbone, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The shared backbone over several encoded streams. Its weights are
    shared, so streams of one length go through ONE kernel launch over their
    concatenated batch and are split back after; the result is the same per
    window. Streams of unequal length go one by one."""
    if len({f.shape[1] for f in feats}) == 1:
        return list(backbone(torch.cat(list(feats), dim=0)).split([f.shape[0] for f in feats]))
    return [backbone(f) for f in feats]


class WalkwayEncoder(nn.Module):
    """(B,T,C_in) -> (B,T,out_ch): Conv1d k3 + GELU + LayerNorm."""

    def __init__(self, in_ch: int, out_ch: int, *, generator: torch.Generator):
        super().__init__()
        self.Conv1dSame_0 = Conv1dSame(in_ch, out_ch, 3, generator=generator)
        self.LayerNorm_0 = nn.LayerNorm(out_ch, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm_0(gelu(self.Conv1dSame_0(x)))


class IMUEncoderShallow(nn.Module):
    """(B,T,C_in) -> (B,T',out_ch): Conv1d k3 + GELU [+ pool] + LayerNorm."""

    def __init__(self, in_ch: int, out_ch: int, pool_len: Optional[int] = None, *,
                 generator: torch.Generator):
        super().__init__()
        self.pool_len = pool_len
        self.Conv1dSame_0 = Conv1dSame(in_ch, out_ch, 3, generator=generator)
        self.LayerNorm_0 = nn.LayerNorm(out_ch, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = gelu(self.Conv1dSame_0(x))
        if self.pool_len:
            x = adaptive_avg_pool1d(x, self.pool_len)
        return self.LayerNorm_0(x)


class InsoleEncoderDeep(nn.Module):
    """Two conv blocks (k5 then k3) with a 1x1 residual projection when the
    hidden width differs from the output width."""

    def __init__(self, in_ch: int, out_ch: int, hidden_ch: Optional[int] = None,
                 pool_len: Optional[int] = None, *, generator: torch.Generator):
        super().__init__()
        h_ch = hidden_ch or max(out_ch, 2 * out_ch)
        self.pool_len = pool_len
        self.Conv1dSame_0 = Conv1dSame(in_ch, h_ch, 5, generator=generator)
        self.Conv1dSame_1 = Conv1dSame(h_ch, out_ch, 3, generator=generator)
        self.Conv1dSame_2 = (
            None if h_ch == out_ch else Conv1dSame(h_ch, out_ch, 1, generator=generator)
        )
        self.LayerNorm_0 = nn.LayerNorm(out_ch, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = gelu(self.Conv1dSame_0(x))
        y = self.Conv1dSame_1(h)
        skip = h if self.Conv1dSame_2 is None else self.Conv1dSame_2(h)
        y = gelu(y + skip)
        if self.pool_len:
            y = adaptive_avg_pool1d(y, self.pool_len)
        return self.LayerNorm_0(y)
