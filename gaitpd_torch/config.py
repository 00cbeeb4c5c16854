"""The configurations: the FBG/FoG model widths, training settings and
dataset names, and the WearGait, loss, MTL, mesh and experiment configs.
The port's own copy of gaitpd/config.py:14-182 (reference
train/configs.py:1-70, train/fbg_fog_train.py:288,299).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelDims:
    """Shapes of the 2-modality FBG/FoG stack (reference train/configs.py:1-32,
    60-70)."""

    pose_length: int
    skeleton_input_dim: int
    skeleton_output_dim: int
    sensor_in_channels: int
    sensor_out_channels: int
    sensor_length: int
    shared_out_channels: int = 16
    backbone_dim: int = 8
    num_classes: int = 3

    @property
    def taskhead_input_dim(self) -> int:
        return self.shared_out_channels * self.backbone_dim


@dataclasses.dataclass(frozen=True)
class TrainParams:
    """Optimisation settings (reference train/configs.py:12-15,
    fbg_fog_train.py:288,299)."""

    learning_rate: float = 1e-3
    epochs: int = 50
    batch_size: int = 256
    momentum: float = 0.9
    weight_decay: float = 1e-4
    patience: int = 100


# FBG: mocap skeleton 101 x 17 joints x 3, GRF 65 x 3
FBG = ModelDims(
    pose_length=101,
    skeleton_input_dim=51,
    skeleton_output_dim=3,
    sensor_in_channels=3,
    sensor_out_channels=3,
    sensor_length=65,
    num_classes=3,
)

# FoG: lifted pose 101 x 7 keypoints x 3, IMU 426 x 6
FOG = ModelDims(
    pose_length=101,
    skeleton_input_dim=21,
    skeleton_output_dim=6,
    sensor_in_channels=6,
    sensor_out_channels=6,
    sensor_length=426,
    num_classes=3,
)

FBG_FOG_DIMS = {"fbg": FBG, "fog": FOG}
FBG_FOG_TRAIN = {"fbg": TrainParams(), "fog": TrainParams()}

# the reference's dataset names and their aliases (train/configs.py:34-47)
DATASET_ALIASES = {
    "fbg": "fbg",
    "fog": "fog",
    "weargait": "weargait",
    "walk": "fbg",
    "turn": "fog",
}

RAW_READER_DATASET = {"fbg": "walk", "fog": "turn", "weargait": "weargait"}


def normalize_dataset_name(dataset: str) -> str:
    """The canonical name of ``dataset`` or an alias; ValueError if unknown."""
    try:
        return DATASET_ALIASES[dataset.lower()]
    except KeyError as exc:
        raise ValueError(f"Unknown dataset: {dataset}") from exc


def raw_reader_dataset_name(dataset: str) -> str:
    """The raw reader's name of a dataset ("walk" for FBG, "turn" for FoG)."""
    return RAW_READER_DATASET[normalize_dataset_name(dataset)]


@dataclasses.dataclass(frozen=True)
class WearGaitConfig:
    """WearGait 3-stream experiment config (gaitpd/config.py:104-136;
    reference train/weargait_train.py:648-691 CLI defaults and
    data_processing/dataloader_weargait.py:26-48 channel sets)."""

    n_folds: int = 10
    test_per_class: int = 8
    win_len: int = 64
    hop_len: int = 64
    batch_size: int = 64
    epochs: int = 50
    patience: int = 50
    num_classes: int = 2
    lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 1e-4
    enc_out_ch: int = 12
    backbone_dim: int = 8
    shared_out_ch: int = 16
    proj_ch: int = 16
    walkway_channels: int = 2
    insole_channels: int = 13
    imu_channels: int = 24

    @property
    def modal_dims(self) -> dict:
        return {
            "walkway": self.walkway_channels,
            "insole": self.insole_channels,
            "imu": self.imu_channels,
        }


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Imbalance-loss hyperparameters (reference train/fbg_fog_train.py:450-459)."""

    wm: str = "gcl"  # ce | class_wt | ldam | gcl
    ldam_s: float = 30.0
    ldam_m: float = 0.5
    gcl_m: float = 0.2
    gcl_s: float = 25.0
    noise_mul: float = 0.0
    drw_warmup: int = 0
    consistency_lambda: float = 1.0
    label_smoothing: float = 0.1


@dataclasses.dataclass(frozen=True)
class MTLConfig:
    """Gradient-surgery config (reference train/fbg_fog_train.py:289,452-453)."""

    method: str = "cagrad"  # any key of gaitpd_torch.learning.mtl.METHODS, or "none"
    alpha: float = 0.1  # CAGrad c; 0 disables
    max_norm: float = 1.0
    # "sum" (the FBG/FoG driver: private parameters get the plain
    # multi-task sum) or "sum_plus_own" (the WearGait driver adds each
    # stream's own-loss gradient once more); gaitpd_torch.learning.mtl.mtl_grads
    private_grads: str = "sum"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for data-parallel execution, as gaitpd's: the
    port's mesh is a torch DeviceMesh over the ranks of the process group
    (gaitpd_torch/runtime/mesh.py::make_mesh)."""

    data_axis: str = "data"
    n_devices: Optional[int] = None  # None = all available


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    dataset: str = "fog"
    modality: str = "multimodal"  # skeleton | sensor | multimodal
    synchronized_loading: bool = False
    seed: int = 43
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    mtl: MTLConfig = dataclasses.field(default_factory=MTLConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
