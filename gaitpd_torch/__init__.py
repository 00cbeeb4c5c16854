"""gaitpd_torch — the PyTorch/CUDA port of gaitpd for NVIDIA Hopper.

The JAX package ``gaitpd`` is the reference; this package imports nothing of
it (nor of JAX). Serving is the first ported path:

    z-score -> windowing -> WearGaitThreeModal forward -> masked softmax
    ensemble (gaitpd_torch.serve)

with the shared backbone (conv k3 + ReLU + adaptive average pool) running
through a hand-written CUDA kernel (gaitpd_torch/csrc/stream_block.cu) when
its input lies on the card. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``, where every kernel takes its plain PyTorch version.
"""
