"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. With no
card they raise: a CPU run is never a silent stand-in for a GPU run.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def set_strict_f32() -> None:
    """Full-f32 products and convolutions on the card.

    cuDNN runs f32 convolutions in TF32 by default (about three decimal
    digits); the JAX reference runs every product at ``Precision.HIGHEST``,
    so the port turns TF32 off for both matmuls and convolutions.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        set_strict_f32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
