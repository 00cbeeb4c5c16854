"""Multi-stream multitask models. Port of gaitpd/models/multitask.py:64-243:
the FBG/FoG skeleton + sensor model and its two single-modality stacks, and
the WearGait three-modality model.

Submodules carry the flax modules' names and ``shared_modules`` /
``task_modules`` name the same partitions as gaitpd's, so
gaitpd_torch.params.load_flax_params and
gaitpd_torch.learning.mtl.build_flat_partition take them unchanged.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from gaitpd_torch.models.blocks import TaskHead, default_generator, flatten_features
from gaitpd_torch.models.encoders import (
    IMUEncoderShallow,
    InsoleEncoderDeep,
    SensorEncoder,
    SharedBackbone,
    SkeletonMLP,
    WalkwayEncoder,
    backbone_streams,
)

MODALITIES = ("walkway", "insole", "imu")
CHANNELS = {"walkway": 2, "insole": 13, "imu": 24}


class MultiModalMultiTask(nn.Module):
    """Skeleton + sensor branches over one shared backbone
    (reference train/feature_encoder.py:149-265). Returns (logits_skel,
    logits_sens). Synchronized mode has one head for both streams, async
    mode a head per stream.

    ``skeleton_input_dim`` and ``sensor_in_channels`` are the input widths,
    which the flax module infers at init. Both encoders give
    ``pose_length`` frames (the sensor encoder pools its ``sensor_length``
    frames to them), so the two streams reach the backbone through one
    kernel launch over their concatenated batch; gaitpd calls the backbone
    once a stream, and the result per window is the same."""

    def __init__(
        self,
        skeleton_input_dim: int,
        skeleton_output_dim: int,
        sensor_in_channels: int,
        sensor_out_channels: int,
        sensor_length: int,
        pose_length: int = 101,
        shared_out_channels: int = 16,
        backbone_dim: int = 8,
        num_classes: int = 3,
        use_norm: bool = False,
        use_cosine: bool = False,
        synchronized_loading: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        g = default_generator(generator)
        self.synchronized_loading = synchronized_loading
        self.skeleton_encoder = SkeletonMLP(skeleton_input_dim, skeleton_output_dim,
                                            generator=g)
        self.sensor_encoder = SensorEncoder(sensor_in_channels, sensor_out_channels,
                                            sensor_length=sensor_length,
                                            output_length=pose_length, generator=g)
        if skeleton_output_dim != sensor_out_channels:
            raise ValueError("the shared backbone takes one width: skeleton_output_dim "
                             f"{skeleton_output_dim} != sensor_out_channels "
                             f"{sensor_out_channels}")
        self.backbone = SharedBackbone(sensor_out_channels, shared_out_channels, backbone_dim,
                                       generator=g)
        feat = shared_out_channels * backbone_dim

        def head():
            return TaskHead(feat, num_classes, use_norm=use_norm, use_cosine=use_cosine,
                            generator=g)

        if synchronized_loading:
            self.task_head_shared = head()
        else:
            self.task_head_skel = head()
            self.task_head_sensor = head()

    def forward(self, x_skel: torch.Tensor, x_sensor: torch.Tensor):
        feats = [self.skeleton_encoder(x_skel), self.sensor_encoder(x_sensor)]
        skel_repr, sens_repr = (flatten_features(p)
                                for p in backbone_streams(self.backbone, feats))
        if self.synchronized_loading:
            return self.task_head_shared(skel_repr), self.task_head_shared(sens_repr)
        return self.task_head_skel(skel_repr), self.task_head_sensor(sens_repr)

    @property
    def shared_modules(self) -> Tuple[str, ...]:
        """reference train/feature_encoder.py:256-265."""
        if self.synchronized_loading:
            return ("backbone", "task_head_shared")
        return ("backbone",)

    @property
    def task_modules(self) -> Tuple[Tuple[str, ...], ...]:
        """The private module groups of the skeleton and the sensor task."""
        if self.synchronized_loading:
            return (("skeleton_encoder",), ("sensor_encoder",))
        return (("skeleton_encoder", "task_head_skel"), ("sensor_encoder", "task_head_sensor"))


class _SingleModality(nn.Module):
    """encoder -> shared backbone -> head; the head has a LayerNorm unless
    ``use_norm`` is False, as the flax modules' default."""

    def __init__(self, encoder: nn.Module, enc_out: int, shared_out_channels: int,
                 backbone_dim: int, num_classes: int, use_norm: bool,
                 generator: torch.Generator):
        super().__init__()
        self.encoder = encoder
        self.backbone = SharedBackbone(enc_out, shared_out_channels, backbone_dim,
                                       generator=generator)
        self.task_head = TaskHead(shared_out_channels * backbone_dim, num_classes,
                                  use_norm=use_norm, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.task_head(flatten_features(self.backbone(self.encoder(x))))


class SensorModalityModel(_SingleModality):
    """Sensor-only stack (reference train/feature_encoder.py:268-305)."""

    def __init__(self, sensor_in_channels: int, sensor_out_channels: int, sensor_length: int,
                 pose_length: int = 101, shared_out_channels: int = 16, backbone_dim: int = 8,
                 num_classes: int = 3, use_norm: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        g = default_generator(generator)
        encoder = SensorEncoder(sensor_in_channels, sensor_out_channels,
                                sensor_length=sensor_length, output_length=pose_length,
                                generator=g)
        super().__init__(encoder, sensor_out_channels, shared_out_channels, backbone_dim,
                         num_classes, use_norm, g)


class SkelModalityModel(_SingleModality):
    """Skeleton-only stack (reference train/feature_encoder.py:308-344)."""

    def __init__(self, skeleton_input_dim: int, skeleton_output_dim: int,
                 shared_out_channels: int = 16, backbone_dim: int = 8, num_classes: int = 3,
                 use_norm: bool = True, *, generator: Optional[torch.Generator] = None):
        g = default_generator(generator)
        encoder = SkeletonMLP(skeleton_input_dim, skeleton_output_dim, generator=g)
        super().__init__(encoder, skeleton_output_dim, shared_out_channels, backbone_dim,
                         num_classes, use_norm, g)


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
