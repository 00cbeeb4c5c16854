"""The FBG/FoG configuration: model widths, training settings and dataset
names. The port's own copy of gaitpd/config.py:14-100 (reference
train/configs.py:1-70, train/fbg_fog_train.py:288,299).
"""

from __future__ import annotations

import dataclasses


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
