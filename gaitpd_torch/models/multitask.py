"""WearGait three-modality model. Port of gaitpd/models/multitask.py:174-243."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from gaitpd_torch.models.blocks import TaskHead, default_generator, flatten_features
from gaitpd_torch.models.encoders import (
    IMUEncoderShallow,
    InsoleEncoderDeep,
    SharedBackbone,
    WalkwayEncoder,
    backbone_streams,
)

MODALITIES = ("walkway", "insole", "imu")
CHANNELS = {"walkway": 2, "insole": 13, "imu": 24}


class WearGaitThreeModal(nn.Module):
    """Walkway / insole / IMU branches over one shared backbone.

    Returns (logits_walkway, logits_insole, logits_imu). Relaxed input (any
    subset of sensors) is the caller's business: it zero-fills the absent
    streams and ensembles only the enabled heads. Synchronized mode has one
    head shared by the three streams; async mode a head per stream.
    ``in_channels`` are the walkway/insole/IMU input widths, which the flax
    module infers at init."""

    def __init__(
        self,
        enc_out_ch: int = 12,
        backbone_dim: int = 8,
        shared_out_ch: int = 16,
        num_classes: int = 2,
        use_norm: bool = False,
        use_cosine: bool = False,
        synchronized: bool = True,
        pool_len: Optional[int] = None,
        in_channels: Sequence[int] = tuple(CHANNELS[m] for m in MODALITIES),
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        g = default_generator(generator)
        cw, ci, cm = in_channels
        self.synchronized = synchronized
        self.enc_w = WalkwayEncoder(cw, enc_out_ch, generator=g)
        self.enc_i = InsoleEncoderDeep(ci, enc_out_ch, hidden_ch=enc_out_ch * 2,
                                       pool_len=pool_len, generator=g)
        self.enc_m = IMUEncoderShallow(cm, enc_out_ch, pool_len=pool_len, generator=g)
        self.backbone = SharedBackbone(enc_out_ch, shared_out_ch, backbone_dim, generator=g)
        feat = backbone_dim * shared_out_ch

        def head():
            return TaskHead(feat, num_classes, use_norm=use_norm, use_cosine=use_cosine,
                            generator=g)

        if synchronized:
            self.head_shared = head()
        else:
            self.head_w = head()
            self.head_i = head()
            self.head_m = head()

    def _encoders(self):
        return {"walkway": self.enc_w, "insole": self.enc_i, "imu": self.enc_m}

    def _heads(self):
        if self.synchronized:
            return (self.head_shared,) * 3
        return (self.head_w, self.head_i, self.head_m)

    def forward(self, x_walk, x_insole, x_imu):
        # one backbone launch for the three streams; with pool_len the walkway
        # stream (never pooled) differs in length and they go one by one
        feats = [self.enc_w(x_walk), self.enc_i(x_insole), self.enc_m(x_imu)]
        reps = [flatten_features(p) for p in backbone_streams(self.backbone, feats)]
        return tuple(head(r) for head, r in zip(self._heads(), reps))

    def forward_single(self, x, mod: str):
        """Run one branch only (the single-modality path)."""
        rep = flatten_features(self.backbone(self._encoders()[mod](x)))
        return self._heads()[MODALITIES.index(mod)](rep)

    @property
    def shared_modules(self) -> Tuple[str, ...]:
        if self.synchronized:
            return ("backbone", "head_shared")
        return ("backbone",)

    @property
    def task_modules(self) -> Tuple[Tuple[str, ...], ...]:
        if self.synchronized:
            return (("enc_w",), ("enc_i",), ("enc_m",))
        return (("enc_w", "head_w"), ("enc_i", "head_i"), ("enc_m", "head_m"))
