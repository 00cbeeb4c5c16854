"""gaitpd_torch — the PyTorch/CUDA port of gaitpd for NVIDIA Hopper.

The JAX package ``gaitpd`` is the reference; this package imports nothing of
it (nor of JAX). Two paths are ported:

    serving: z-score -> windowing -> WearGaitThreeModal forward -> masked
    softmax ensemble (gaitpd_torch.serve)

    training: WearGait folds -> GCL losses -> K per-task backward passes ->
    CAGrad -> SGD, with the masked 7-subset eval
    (gaitpd_torch.train.weargait_driver.run_cv)

The shared backbone (conv k3 + ReLU + adaptive average pool) runs through a
hand-written CUDA kernel, forward and backward
(gaitpd_torch/csrc/stream_block.cu), and the CAGrad dual solver through
another (gaitpd_torch/csrc/cagrad_solver.cu), when their inputs lie on the
card. Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
where every kernel takes its plain PyTorch version.
"""
