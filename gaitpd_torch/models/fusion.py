"""Fusion model families: early / late / shared-latent / cheap cross-attention
variants for the 2-modality FBG/FoG stack and the 3-modality WearGait stack.
Port of gaitpd/models/fusion.py.

Submodules carry the flax modules' names (``skel_enc``, ``enc_w``,
``backbone``, ``head_shared``, ``proj_w``, ...), so gaitpd_torch.params maps
a flax variables dict onto them. Input widths, which flax infers at init, are
constructor arguments. Where a model runs the shared backbone over several
streams of one length, they go through one kernel launch.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from gaitpd_torch.models.blocks import TaskHead, TorchLinear, default_generator, flatten_features
from gaitpd_torch.models.encoders import (
    IMUEncoderShallow,
    InsoleEncoderDeep,
    SensorEncoder,
    SharedBackbone,
    SkeletonMLP,
    WalkwayEncoder,
    backbone_streams,
)
from gaitpd_torch.models.multitask import CHANNELS, MODALITIES
from gaitpd_torch.ops.attention import cheap_cross_attention_sym, masked_pairwise_enrichment

# ---------------------------------------------------------------------------
# Two-modality (FBG/FoG) fusion family — gaitpd/models/fusion.py:33-134
# ---------------------------------------------------------------------------


class _TwoModBase(nn.Module):
    """Encoders of the 2-mod family; each model adds its backbone and heads
    with ``_backbone_and_heads``. ``skeleton_input_dim`` and
    ``sensor_in_channels`` are the input widths (21 and 6 on FoG,
    gaitpd/config.py:64-66)."""

    def __init__(self, skeleton_output_dim: int, sensor_out_channels: int, sensor_length: int,
                 pose_length: int = 101, shared_out_channels: int = 16, backbone_dim: int = 8,
                 num_classes: int = 3, synchronized_loading: bool = False, *,
                 skeleton_input_dim: int, sensor_in_channels: int, generator: torch.Generator):
        super().__init__()
        self.synchronized_loading = synchronized_loading
        self.enc_widths = (skeleton_output_dim, sensor_out_channels)
        self.dims = (shared_out_channels, backbone_dim, num_classes)
        self.skel_enc = SkeletonMLP(skeleton_input_dim, skeleton_output_dim, generator=generator)
        self.sens_enc = SensorEncoder(sensor_in_channels, sensor_out_channels, sensor_length,
                                      pose_length, generator=generator)

    def _equal_enc_widths(self, why: str) -> int:
        if self.enc_widths[0] != self.enc_widths[1]:
            raise ValueError(f"{why}: needs equal feature dims, got {self.enc_widths}")
        return self.enc_widths[0]

    def _backbone_and_heads(self, in_ch: int, reps: int, g: torch.Generator,
                            heads: Optional[Tuple[str, ...]] = None) -> None:
        """The backbone over ``in_ch`` channels and heads reading ``reps``
        backbone representations: sync one head ``head``, async ``head_skel``
        and ``head_sens`` on the same representation."""
        shared, bdim, n_cls = self.dims
        self.backbone = SharedBackbone(in_ch, shared, bdim, generator=g)
        if heads is None:
            heads = ("head",) if self.synchronized_loading else ("head_skel", "head_sens")
        for name in heads:
            setattr(self, name, TorchLinear(reps * bdim * shared, n_cls, generator=g))

    def _apply_heads(self, rep):
        if self.synchronized_loading:
            return self.head(rep)
        return self.head_skel(rep), self.head_sens(rep)


class EarlyFusionModel(_TwoModBase):
    """Concat encoded features along channels -> one backbone."""

    def __init__(self, *args, generator: Optional[torch.Generator] = None, **kw):
        g = default_generator(generator)
        super().__init__(*args, generator=g, **kw)
        self._backbone_and_heads(sum(self.enc_widths), 1, g)

    def forward(self, x_skel, x_sens):
        fused = torch.cat([self.skel_enc(x_skel), self.sens_enc(x_sens)], dim=-1)
        return self._apply_heads(flatten_features(self.backbone(fused)))


class LateFusionModel(_TwoModBase):
    """Per-branch backbone reprs concatenated before the heads."""

    def __init__(self, *args, generator: Optional[torch.Generator] = None, **kw):
        g = default_generator(generator)
        super().__init__(*args, generator=g, **kw)
        self._backbone_and_heads(self._equal_enc_widths("late fusion shares one backbone"), 2, g)

    def forward(self, x_skel, x_sens):
        sk, se = backbone_streams(self.backbone, [self.skel_enc(x_skel), self.sens_enc(x_sens)])
        fused = torch.cat([flatten_features(sk), flatten_features(se)], dim=1)
        return self._apply_heads(fused)


class ShareLatentModel(_TwoModBase):
    """Per-modality linear projection to a common latent; shared backbone and
    one shared head ``head`` on each stream, in either mode."""

    def __init__(self, *args, generator: Optional[torch.Generator] = None, **kw):
        g = default_generator(generator)
        super().__init__(*args, generator=g, **kw)
        latent = self.dims[0]
        self.proj_skel = TorchLinear(self.enc_widths[0], latent, generator=g)
        self.proj_sens = TorchLinear(self.enc_widths[1], latent, generator=g)
        self._backbone_and_heads(latent, 1, g, heads=("head",))

    def forward(self, x_skel, x_sens):
        lat = [self.proj_skel(self.skel_enc(x_skel)), self.proj_sens(self.sens_enc(x_sens))]
        sk, se = backbone_streams(self.backbone, lat)
        return self.head(flatten_features(sk)), self.head(flatten_features(se))


class CheapXAttnModel(_TwoModBase):
    """Symmetric zero-parameter cross-attention fusion, both directions in one
    kernel launch."""

    def __init__(self, *args, generator: Optional[torch.Generator] = None, **kw):
        g = default_generator(generator)
        super().__init__(*args, generator=g, **kw)
        self._backbone_and_heads(self._equal_enc_widths("cross-attention"), 1, g)

    def forward(self, x_skel, x_sens):
        fused = cheap_cross_attention_sym(self.skel_enc(x_skel), self.sens_enc(x_sens))
        return self._apply_heads(flatten_features(self.backbone(fused)))


TWO_MOD_FUSIONS = {
    "early": EarlyFusionModel,
    "late": LateFusionModel,
    "share_latent": ShareLatentModel,
    "cheap_xattn": CheapXAttnModel,
}


# ---------------------------------------------------------------------------
# Three-modality (WearGait) fusion baselines — gaitpd/models/fusion.py:142-258
# ---------------------------------------------------------------------------


class _ThreeModBase(nn.Module):
    """Encoders and heads of the 3-mod family, around a backbone over
    ``backbone_in`` channels (default ``enc_out_ch``). ``in_channels`` are the
    walkway/insole/IMU input widths. Sync mode has one head ``head_shared``;
    async mode ``head_w``, ``head_i``, ``head_m``."""

    def __init__(self, enc_out_ch: int = 12, backbone_dim: int = 8, shared_out_ch: int = 16,
                 num_classes: int = 2, use_norm: bool = False, use_cosine: bool = False,
                 synchronized: bool = True,
                 in_channels: Sequence[int] = tuple(CHANNELS[m] for m in MODALITIES), *,
                 backbone_in: Optional[int] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        cw, ci, cm = in_channels
        self.synchronized = synchronized
        self.enc_w = WalkwayEncoder(cw, enc_out_ch, generator=g)
        self.enc_i = InsoleEncoderDeep(ci, enc_out_ch, generator=g)
        self.enc_m = IMUEncoderShallow(cm, enc_out_ch, generator=g)
        self.backbone = SharedBackbone(backbone_in or enc_out_ch, shared_out_ch, backbone_dim,
                                       generator=g)
        names = ("head_shared",) if synchronized else ("head_w", "head_i", "head_m")
        for name in names:
            setattr(self, name, TaskHead(backbone_dim * shared_out_ch, num_classes,
                                         use_norm=use_norm, use_cosine=use_cosine, generator=g))

    def _encode(self, xw, xi, xm):
        return [self.enc_w(xw), self.enc_i(xi), self.enc_m(xm)]

    def _per_stream_heads(self, reps) -> Tuple[torch.Tensor, ...]:
        if self.synchronized:
            return tuple(self.head_shared(r) for r in reps)
        return self.head_w(reps[0]), self.head_i(reps[1]), self.head_m(reps[2])

    def _backbone_reps(self, feats):
        return [flatten_features(p) for p in backbone_streams(self.backbone, feats)]


class EarlyFusion3(_ThreeModBase):
    """Channel-concat of the three encoded streams -> one backbone; sync one
    shared head (replicated 3x), async three heads on the SAME fused repr."""

    def __init__(self, enc_out_ch: int = 12, *args, **kw):
        super().__init__(enc_out_ch, *args, backbone_in=3 * enc_out_ch, **kw)

    def forward(self, xw, xi, xm):
        rep = flatten_features(self.backbone(torch.cat(self._encode(xw, xi, xm), dim=-1)))
        if self.synchronized:
            y = self.head_shared(rep)
            return y, y, y
        return self._per_stream_heads((rep, rep, rep))


class LateFusion3(_ThreeModBase):
    """Shared backbone per stream (one launch); sync fuses latents by
    element-wise mean into one shared head, async keeps per-stream heads."""

    def forward(self, xw, xi, xm):
        rw, ri, rm = self._backbone_reps(self._encode(xw, xi, xm))
        if self.synchronized:
            y = self.head_shared((rw + ri + rm) / 3.0)
            return y, y, y
        return self._per_stream_heads((rw, ri, rm))


class SharedLatent3(_ThreeModBase):
    """Per-stream projection to a shared width ``proj_ch``; shared backbone
    per stream (one launch); per-stream heads (sync aliases one head)."""

    def __init__(self, enc_out_ch: int = 12, *args, proj_ch: int = 16,
                 generator: Optional[torch.Generator] = None, **kw):
        g = default_generator(generator)
        super().__init__(enc_out_ch, *args, backbone_in=proj_ch, generator=g, **kw)
        self.proj_w = TorchLinear(enc_out_ch, proj_ch, generator=g)
        self.proj_i = TorchLinear(enc_out_ch, proj_ch, generator=g)
        self.proj_m = TorchLinear(enc_out_ch, proj_ch, generator=g)

    def forward(self, xw, xi, xm):
        ew, ei, em = self._encode(xw, xi, xm)
        return self._per_stream_heads(
            self._backbone_reps([self.proj_w(ew), self.proj_i(ei), self.proj_m(em)]))


class CheapXAttn3(_ThreeModBase):
    """Pairwise zero-parameter cross-attention enrichment per stream (the six
    directed pairs in one kernel launch), then the shared backbone (one
    launch) and the heads.

    ``mask`` (optional (3,) bool) switches the pairwise averaging to
    enabled-partners-only (gaitpd_torch.ops.attention.
    masked_pairwise_enrichment); omitted -> every partner, the reference."""

    def forward(self, xw, xi, xm,
                mask: Optional[Union[torch.Tensor, Sequence[bool]]] = None):
        enriched = masked_pairwise_enrichment(self._encode(xw, xi, xm), mask)
        return self._per_stream_heads(self._backbone_reps(enriched))
