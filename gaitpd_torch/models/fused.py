"""The fused three-stream WearGait forward: one block-diagonal encoder
convolution over the concatenated streams, and the shared backbone over all
three streams in one launch. Port of gaitpd/models/fused.py.

``WearGaitThreeModal`` runs three encoder convolutions (2/13/24 input and
12/24/12 output channels), the insole's residual pair and three LayerNorms.
The fused forward computes the same function as:

  1. one k5 'SAME' convolution over the channel-concatenated input (39 -> 48)
     with a block-diagonal kernel: the walkway and IMU k3 kernels sit in a k5
     with zero outer taps (their products with the padding are exactly 0),
     the insole's k5 kernel as it is;
  2. the insole's residual stage as one k3 convolution whose centre tap
     carries the 1x1 skip kernel (conv3(h) + conv1(h) = conv(h, k3 +
     pad(k1)) by linearity), the two biases summed;
  3. each stream's LayerNorm on the stacked (B, 3, T, 12) tensor (the
     normalised axis is each stream's channel axis), the weights stacked;
  4. the shared backbone over the three streams folded into the batch,
     window-major ((b, stream) rows, as gaitpd folds them): one
     ``stream_block`` launch, the hand-written kernel on the card;
  5. the heads on the (B, 3, features) tensor (LayerNorm, Linear and the
     cosine classifier act on the last axis only).

The kernels of steps 1 and 2 are built each forward from the unfused
model's parameters with ``F.pad``, ``torch.cat`` and additions, never by
writing into a zero tensor, so the forward runs under ``torch.func.vmap``
over stacked parameters (the stacked folds of gaitpd_torch/train/
vmap_cv.py). ``FusedWearGaitThreeModal`` keeps the unfused model's
submodules and parameter names, so flax parameters, checkpoints,
``shared_modules`` / ``task_modules`` and ``functional_call`` take it
unchanged. Only step 2's kernel addition rounds apart from the unfused
forward (tests/test_torch_fused.py holds the two within 2e-5).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from gaitpd_torch.models.blocks import gelu
from gaitpd_torch.models.multitask import WearGaitThreeModal

STREAMS = 3


def _check_unpooled(model: WearGaitThreeModal) -> None:
    if model.enc_i.pool_len or model.enc_m.pool_len:
        raise ValueError("the fused forward assumes pool_len=None (no encoder pool)")


def _embed(kernel: torch.Tensor, taps: int, before: int, after: int) -> torch.Tensor:
    """A (C_out, C_in, K) kernel padded to ``taps`` taps (centred) and with
    ``before`` and ``after`` zero input channels around its own."""
    side = (taps - kernel.shape[-1]) // 2
    return F.pad(kernel, (side, side, before, after))


def fused_forward(model: WearGaitThreeModal, x_walk: torch.Tensor, x_insole: torch.Tensor,
                  x_imu: torch.Tensor):
    """``model``'s logits (walkway, insole, imu) through the fused path, on
    its own parameters (or those ``functional_call`` puts in their place).
    The three streams take one batch size and one length."""
    cw, ci, cm = x_walk.shape[-1], x_insole.shape[-1], x_imu.shape[-1]
    conv_w = model.enc_w.Conv1dSame_0
    conv_i = model.enc_i.Conv1dSame_0
    conv_m = model.enc_m.Conv1dSame_0
    e = conv_w.weight.shape[0]
    hid = conv_i.weight.shape[0]
    taps = conv_i.kernel_size

    # stage A: the block-diagonal k5 convolution over the concatenated channels
    ka = torch.cat([
        _embed(conv_w.weight, taps, 0, ci + cm),
        _embed(conv_i.weight, taps, cw, cm),
        _embed(conv_m.weight, taps, cw + ci, 0),
    ])                                                            # (48, 39, 5)
    ba = torch.cat([conv_w.bias, conv_i.bias, conv_m.bias])
    x = torch.cat([x_walk, x_insole, x_imu], dim=-1).transpose(1, 2)  # (B, 39, T)
    h = gelu(F.conv1d(x, ka, ba, padding=taps // 2))             # (B, 48, T)

    # stage B: the insole's residual pair as one k3 convolution
    conv3, conv1 = model.enc_i.Conv1dSame_1, model.enc_i.Conv1dSame_2
    k3 = conv3.weight
    kb = k3 + _embed(conv1.weight, k3.shape[-1], 0, 0)
    bb = conv3.bias + conv1.bias
    hi = gelu(F.conv1d(h[:, e:e + hid], kb, bb, padding=k3.shape[-1] // 2))  # (B, e, T)

    # each stream's LayerNorm on the stacked tensor
    hs = torch.stack([h[:, :e], hi, h[:, e + hid:]], dim=1).transpose(2, 3)  # (B, 3, T, e)
    norms = (model.enc_w.LayerNorm_0, model.enc_i.LayerNorm_0, model.enc_m.LayerNorm_0)
    scale = torch.stack([n.weight for n in norms])[:, None, :]   # (3, 1, e)
    shift = torch.stack([n.bias for n in norms])[:, None, :]
    hs = F.layer_norm(hs, (e,), eps=norms[0].eps) * scale + shift

    # the shared backbone over the three streams at once, (b, stream) rows
    b, t = hs.shape[0], hs.shape[2]
    feats = model.backbone(hs.reshape(b * STREAMS, t, e)).reshape(b, STREAMS, -1)

    if model.synchronized:
        out = model.head_shared(feats)                           # (B, 3, classes)
        return out[:, 0], out[:, 1], out[:, 2]
    return (model.head_w(feats[:, 0]), model.head_i(feats[:, 1]), model.head_m(feats[:, 2]))


class FusedWearGaitThreeModal(WearGaitThreeModal):
    """``WearGaitThreeModal`` whose forward is the fused path: the same
    submodules, parameters and names, the same logits up to rounding.
    Raises ValueError for ``pool_len``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _check_unpooled(self)

    def forward(self, x_walk, x_insole, x_imu):
        return fused_forward(self, x_walk, x_insole, x_imu)


def make_fused_weargait_apply(model: WearGaitThreeModal):
    """A drop-in for ``model(xw, xi, xm)`` through the fused path, on
    ``model``'s parameters (gaitpd's returns a drop-in for ``model.apply``,
    whose parameters are an argument). Raises ValueError for a model with
    ``pool_len``."""
    _check_unpooled(model)
    return functools.partial(fused_forward, model)
