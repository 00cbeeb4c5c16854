"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. With no
card they raise: a CPU run is never a silent stand-in for a GPU run.

The products' precision on the card is the process's setting
``matmul_precision``: "highest" (the default) is strict f32, the rule of
every parity run; "high" and "default" let cuBLAS and cuDNN use TF32 (about
three decimal digits in the products), where gaitpd's flag names JAX's
bf16-pass precisions. ``resolve_device`` applies it whenever it resolves
the card; the training CLI sets it for its run and restores the flags after.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Union

import torch

DeviceLike = Union[str, torch.device, None]

MATMUL_PRECISIONS = ("default", "high", "highest")
_matmul_precision = "highest"


def set_strict_f32() -> None:
    """Full-f32 products and convolutions on the card.

    cuDNN runs f32 convolutions in TF32 by default (about three decimal
    digits); the JAX reference runs every product at ``Precision.HIGHEST``,
    so the port turns TF32 off for both matmuls and convolutions. It leaves
    cuDNN free to pick backward algorithms that add with atomics: on an
    H100 its deterministic ones made a CAGrad step about ten times slower.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def allow_tf32() -> None:
    """TF32 products and convolutions on the card (cuBLAS and cuDNN)."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")


def apply_matmul_precision() -> None:
    """The flags of the process's ``matmul_precision``."""
    if _matmul_precision == "highest":
        set_strict_f32()
    else:
        allow_tf32()


@contextlib.contextmanager
def matmul_precision(name: str) -> Iterator[None]:
    """Run with the products' precision ``name`` (one of MATMUL_PRECISIONS),
    then restore the setting and the flags as they were."""
    global _matmul_precision
    if name not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul precision must be one of {MATMUL_PRECISIONS}, got {name!r}")
    saved = (_matmul_precision, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    _matmul_precision = name
    try:
        apply_matmul_precision()
        yield
    finally:
        _matmul_precision = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.backends.cuda.matmul.allow_tf32 = saved[2]
        torch.set_float32_matmul_precision(saved[3])


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        apply_matmul_precision()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
