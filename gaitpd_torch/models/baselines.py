"""The SOTA baselines: DeepAV-Lite, FOCAL's shared/private latents and
TACA's temperature-adjusted cross-attention, for the 2-modality FBG/FoG
stack and the 3-modality WearGait stack. Port of
gaitpd/models/baselines.py:36-608.

Submodules and parameters carry the flax names (``core``, ``tk_walkway``,
``blk_walkway_0``, ``Attn_0``, ``w_sh``, ``q_a2b``, ...), so
gaitpd_torch.params maps a flax variables dict onto them. The input widths,
which flax infers at init, are the WearGait streams' (2, 13, 24) in the
3-modality models, as gaitpd's wrappers fix them, and constructor arguments
in the 2-modality ones. Sync or async is a constructor argument, as in
gaitpd. Dropout draws its masks from the ``generator`` a forward is given,
and only when ``train`` is True.

Where gaitpd computes a result and drops it (DeepAV's fusion stack and
TACA's third fuser ``im`` in async mode, TACA's unused directions), the port
does not compute it: the parameters exist all the same, so the loader
matches, and their gradient is zero, as gaitpd's is.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from gaitpd_torch.models.blocks import (
    TaskHead,
    TorchLinear,
    default_generator,
    dropout,
    flatten_features,
    gelu,
    lecun_normal_param,
    normal_param,
    torch_bound,
    uniform_param,
)
from gaitpd_torch.models.encoders import (
    GELUBackbone,
    SensorEncoder,
    SharedBackbone,
    SkeletonMLP,
    backbone_streams,
)
from gaitpd_torch.models.multitask import CHANNELS, MODALITIES
from gaitpd_torch.ops.attention import scaled_cross_attention

IN_CHANNELS = tuple(CHANNELS[m] for m in MODALITIES)


def sinusoid_pos_enc(length: int, dim: int) -> np.ndarray:
    """Fixed sinusoidal positions (gaitpd/models/baselines.py:37-45)."""
    pos = np.arange(length, dtype=np.float32)
    idx = np.arange(dim, dtype=np.float32)
    div = np.exp((idx // 2) * (-math.log(10000.0) / max(1, dim // 2)))
    pe = np.zeros((length, dim), np.float32)
    pe[:, 0::2] = np.sin(pos[:, None] * div[0::2])
    pe[:, 1::2] = np.cos(pos[:, None] * div[0::2])
    return pe


def without_dropout(model: nn.Module) -> nn.Module:
    """``model`` with every dropout rate set to 0 in place: each layer reads
    its ``drop`` at forward time, so the weights stay as drawn."""
    for m in model.modules():
        if hasattr(m, "drop"):
            m.drop = 0.0
    return model


def _divide(x: torch.Tensor, n: float) -> torch.Tensor:
    """x / n with a tensor divisor: CUDA divides by a Python number through
    its reciprocal, which is not the reference's division."""
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# DeepAV-Lite (gaitpd/models/baselines.py:53-253,302-332)
# ---------------------------------------------------------------------------


class PatchEmbed1D(nn.Module):
    """Strided VALID Conv1d tokenizer + LayerNorm: (B, T, C) -> (B, L, E).

    By default the conv has flax's lecun_normal kernel and a zero bias, the
    reference's documented deviation from torch's Conv1d law
    (gaitpd/models/baselines.py:56-65): a zero-filled (masked-out) stream
    then tokenizes to exactly 0. ``torch_init`` gives torch's law. ``weight``
    is (E, C_in, patch), as torch keeps a conv kernel."""

    FLAX_WRAPPER = "Conv_0"  # the flax module's inner nn.Conv (gaitpd_torch.params)

    def __init__(self, in_ch: int, embed_dim: int, patch: int = 16, stride: int = 16,
                 torch_init: bool = False, *, generator: torch.Generator):
        super().__init__()
        self.stride = stride
        fan_in = patch * in_ch
        shape = (embed_dim, in_ch, patch)
        if torch_init:
            bound = torch_bound(fan_in)
            self.weight = uniform_param(shape, bound, generator)
            self.bias = uniform_param((embed_dim,), bound, generator)
        else:
            self.weight = lecun_normal_param(shape, fan_in, generator)
            self.bias = nn.Parameter(torch.zeros(embed_dim))
        self.LayerNorm_0 = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = F.conv1d(x.transpose(1, 2), self.weight, self.bias, stride=self.stride)
        return self.LayerNorm_0(z.transpose(1, 2))


class FFN(nn.Module):
    def __init__(self, dim: int, ratio: float = 4.0, drop: float = 0.0, *,
                 generator: torch.Generator):
        super().__init__()
        self.drop = drop
        hidden = int(dim * ratio)
        self.TorchLinear_0 = TorchLinear(dim, hidden, generator=generator)
        self.TorchLinear_1 = TorchLinear(hidden, dim, generator=generator)

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        h = self.TorchLinear_1(gelu(self.TorchLinear_0(x)))
        return dropout(h, self.drop, generator, train)


class Attn(nn.Module):
    """Self- or cross-attention without biases, its heads over ``d_att``
    features (the attention bottleneck; default ``dim``) (reference
    MHSA/XAttn, deepav.py:29-70)."""

    def __init__(self, dim: int, heads: int = 4, drop: float = 0.0,
                 d_att: Optional[int] = None, *, generator: torch.Generator):
        super().__init__()
        self.heads, self.drop = heads, drop
        da = d_att or dim
        for name in ("q", "k", "v"):
            setattr(self, name, TorchLinear(dim, da, use_bias=False, generator=generator))
        self.o = TorchLinear(da, dim, use_bias=False, generator=generator)

    def forward(self, q_in, kv_in, train: bool = False,
                generator: Optional[torch.Generator] = None):
        z = scaled_cross_attention(self.q(q_in), self.k(kv_in), self.v(kv_in), self.heads)
        return dropout(self.o(z), self.drop, generator, train)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int = 4, ratio: float = 4.0, drop: float = 0.0,
                 d_att: Optional[int] = None, *, generator: torch.Generator):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-5)
        self.Attn_0 = Attn(dim, heads, drop, d_att, generator=generator)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=1e-5)
        self.FFN_0 = FFN(dim, ratio, drop, generator=generator)

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        h = self.LayerNorm_0(x)
        x = x + self.Attn_0(h, h, train, generator)
        return x + self.FFN_0(self.LayerNorm_1(x), train, generator)


class DeepAVCore(nn.Module):
    """N-modality DeepAV-Lite core (reference DeepAVLiteN, deepav.py:213-331):
    per-modality tokenizers + type embeddings + self-attention stacks, learned
    aggregation queries by cross-attention, and fusion tokens attending the
    concatenated aggregates. Sync: one joint head on the first fusion token
    (``pool="cls"`` with ``use_cls``: a CLS token, its own type embedding
    added, before the ``n_fusion`` others) or on their mean, its logits once
    a modality; async: a head a modality on the mean of its tokens.

    ``share_blocks``: one block a modality, applied ``depth`` times;
    ``share_unimodal``: the modalities share their stack (``blk_shared_i``);
    ``attn_bottleneck``: the attention's inner width (default embed_dim).
    gaitpd's 3-modality configuration is the default; DeepAVLite's is
    1 aggregation query and 1 fusion token, one shared block, a bottleneck
    of 8, and CLS only when synced."""

    def __init__(self, modal_dims: Sequence[Tuple[str, int]], num_classes: int,
                 embed_dim: int = 96, depth: int = 3, heads: int = 3, mlp_ratio: float = 2.0,
                 patch: int = 8, stride: int = 8, drop: float = 0.1, n_agg: int = 4,
                 n_fusion: int = 4, use_cls: bool = True, pool: str = "cls",
                 share_blocks: bool = False, share_unimodal: bool = False,
                 attn_bottleneck: Optional[int] = None, synchronized: bool = True,
                 torch_init: bool = False, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.names = tuple(m for m, _ in modal_dims)
        self.embed_dim, self.depth = embed_dim, depth
        self.use_cls, self.pool, self.synchronized = use_cls, pool, synchronized
        self._pe: Dict[tuple, torch.Tensor] = {}
        e = embed_dim
        d_att = attn_bottleneck or e
        # in the order of the flax module's setup, so a seed draws alike
        for m, c in modal_dims:
            setattr(self, f"tk_{m}", PatchEmbed1D(c, e, patch, stride, torch_init, generator=g))
        for m in self.names:
            setattr(self, f"type_{m}", normal_param((1, 1, e), 0.02, g))
        n_blocks = 1 if share_blocks else depth
        stacks = ("shared",) if share_unimodal else self.names
        for s in stacks:
            for i in range(n_blocks):
                setattr(self, f"blk_{s}_{i}",
                        TransformerBlock(e, heads, mlp_ratio, drop, d_att, generator=g))
        # each modality's block at each layer
        self._blocks = {m: [f"blk_{'shared' if share_unimodal else m}_"
                            f"{0 if share_blocks else i}" for i in range(depth)]
                        for m in self.names}
        for m in self.names:
            setattr(self, f"agg_q_{m}", normal_param((n_agg, e), 0.02, g))
        for m in self.names:
            setattr(self, f"xattn_{m}", Attn(e, heads, drop, d_att, generator=g))
        self.fus_tok = normal_param((n_fusion + (1 if use_cls else 0), e), 0.02, g)
        if use_cls:
            self.type_cls = normal_param((1, 1, e), 0.02, g)
        self.fuse_xattn = Attn(e, heads, drop, d_att, generator=g)
        self.fuse_ff = FFN(e, mlp_ratio, drop, generator=g)
        self.ln_fuse = nn.LayerNorm(e, eps=1e-5)
        if synchronized:
            self.head_joint = TorchLinear(e, num_classes, generator=g)
        else:
            for m in self.names:
                setattr(self, f"head_{m}", TorchLinear(e, num_classes, generator=g))

    def _pos_enc(self, length: int, device) -> torch.Tensor:
        """The positions on ``device``, copied there once."""
        key = (length, str(device))
        if key not in self._pe:
            self._pe[key] = torch.from_numpy(sinusoid_pos_enc(length, self.embed_dim)).to(device)
        return self._pe[key]

    def _tokens(self, inputs: Dict[str, torch.Tensor], train, generator):
        """Each modality's tokens after its block stack, and the aggregates
        of every layer: [layer][modality] (B, n_agg, E)."""
        z, aggs = {}, []
        for m in self.names:
            t = getattr(self, f"tk_{m}")(inputs[m]) + getattr(self, f"type_{m}")
            z[m] = t + self._pos_enc(t.shape[1], t.device)[None]
        b = next(iter(inputs.values())).shape[0]
        for li in range(self.depth):
            layer = []
            for m in self.names:
                z[m] = getattr(self, self._blocks[m][li])(z[m], train, generator)
                if self.synchronized:  # the aggregates feed only the fusion stack
                    q = getattr(self, f"agg_q_{m}")[None].expand(b, -1, -1)
                    layer.append(getattr(self, f"xattn_{m}")(q, z[m], train, generator))
            aggs.append(layer)
        return z, aggs

    def _fuse(self, aggs, b: int, train, generator) -> torch.Tensor:
        """The fusion tokens through the layers, pooled: the CLS token, or
        the mean of the tokens."""
        fus = self.fus_tok
        if self.use_cls:
            fus = torch.cat([fus[:1] + self.type_cls[0], fus[1:]])
        fus = fus[None].expand(b, -1, -1)
        for layer in aggs:
            av = torch.cat(layer, dim=1)
            fus = fus + self.fuse_xattn(fus, av, train, generator)
            fus = fus + self.fuse_ff(self.ln_fuse(fus), train, generator)
        return fus[:, 0, :] if (self.use_cls and self.pool == "cls") else fus.mean(1)

    def forward(self, *xs, train: bool = False, generator: Optional[torch.Generator] = None):
        inputs = dict(zip(self.names, xs))
        z, aggs = self._tokens(inputs, train, generator)
        if self.synchronized:
            y = self.head_joint(self._fuse(aggs, xs[0].shape[0], train, generator))
            return tuple(y for _ in self.names)
        return tuple(getattr(self, f"head_{m}")(z[m].mean(1)) for m in self.names)


class DeepAVLite(nn.Module):
    """2-modality wrapper with the FBG/FoG driver's tiny configuration
    (reference deepav_train.py:40-47; gaitpd/models/baselines.py:255-299):
    embed 12, depth 1, 4 heads, one block shared by both modalities,
    attention bottleneck 8, one aggregation query and one fusion token, CLS
    only when synced, no dropout. Returns the joint logits (sync) or (skel,
    sens) head logits (async)."""

    def __init__(self, skel_dim: int, sens_dim: int, num_classes: int, embed_dim: int = 12,
                 depth: int = 1, heads: int = 4, mlp_ratio: float = 0.5, patch: int = 1,
                 stride: int = 4, drop: float = 0.0, n_agg: int = 1, n_fusion: int = 1,
                 attn_bottleneck: Optional[int] = 8, synchronized: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.synchronized = synchronized
        self.core = DeepAVCore(
            (("skel", skel_dim), ("sens", sens_dim)), num_classes, embed_dim, depth, heads,
            mlp_ratio, patch, stride, drop, n_agg, n_fusion, use_cls=synchronized,
            pool="cls" if synchronized else "mean", share_blocks=True, share_unimodal=True,
            attn_bottleneck=attn_bottleneck, synchronized=synchronized,
            generator=default_generator(generator))

    def forward(self, x_skel, x_sens, train: bool = False,
                generator: Optional[torch.Generator] = None):
        outs = self.core(x_skel, x_sens, train=train, generator=generator)
        return outs[0] if self.synchronized else outs


class DeepAVLite3(nn.Module):
    """3-modality wrapper (reference DeepAVLite3, deepav.py:334-353)."""

    def __init__(self, num_classes: int, embed_dim: int = 96, depth: int = 3, heads: int = 3,
                 mlp_ratio: float = 2.0, patch: int = 8, stride: int = 8, drop: float = 0.1,
                 synchronized: bool = True, torch_init: bool = False, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.core = DeepAVCore(
            tuple(zip(MODALITIES, IN_CHANNELS)), num_classes, embed_dim, depth, heads,
            mlp_ratio, patch, stride, drop, synchronized=synchronized, torch_init=torch_init,
            generator=default_generator(generator))

    def forward(self, xw, xi, xm, train: bool = False,
                generator: Optional[torch.Generator] = None):
        return self.core(xw, xi, xm, train=train, generator=generator)


# ---------------------------------------------------------------------------
# FOCAL (gaitpd/models/baselines.py:399-440)
# ---------------------------------------------------------------------------


class FOCALSharedLatent(nn.Module):
    """2-modality FOCAL (reference focal.py:10-138; gaitpd/models/
    baselines.py:340-396): the encoded skeleton and sensor sequences, each
    projected per frame to a shared (16) and a private (8) latent; the ReLU
    backbone over [shared, private, private] (32 channels). Sync: one head
    on [mean of the shared, both privates]; async: a head a modality, on
    [own shared, own private in its place, the other's zero-filled], both
    streams through one backbone launch (gaitpd calls the backbone twice).
    ``skeleton_input_dim`` and ``sensor_in_channels`` are the input widths."""

    def __init__(self, skeleton_output_dim: int, sensor_out_channels: int, sensor_length: int,
                 pose_length: int = 101, d_shared: int = 16, d_private: int = 8,
                 shared_out_channels: int = 4, backbone_dim: int = 4, num_classes: int = 3,
                 use_norm_head: bool = False, use_cosine_head: bool = False,
                 synchronized: bool = False, *, skeleton_input_dim: int,
                 sensor_in_channels: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.synchronized = synchronized
        self.skel_enc = SkeletonMLP(skeleton_input_dim, skeleton_output_dim, generator=g)
        self.sens_enc = SensorEncoder(sensor_in_channels, sensor_out_channels, sensor_length,
                                      pose_length, generator=g)
        self.sk_sh = TorchLinear(skeleton_output_dim, d_shared, generator=g)
        self.sk_pr = TorchLinear(skeleton_output_dim, d_private, generator=g)
        self.im_sh = TorchLinear(sensor_out_channels, d_shared, generator=g)
        self.im_pr = TorchLinear(sensor_out_channels, d_private, generator=g)
        self.backbone = SharedBackbone(d_shared + 2 * d_private, shared_out_channels,
                                       backbone_dim, generator=g)
        heads = ("head_sync",) if synchronized else ("head_skel", "head_sensor")
        for name in heads:
            setattr(self, name, TaskHead(backbone_dim * shared_out_channels, num_classes,
                                         use_norm=use_norm_head, use_cosine=use_cosine_head,
                                         generator=g))

    def forward(self, x_skel, x_sensor):
        s, m = self.skel_enc(x_skel), self.sens_enc(x_sensor)
        s_sh, s_pr, m_sh, m_pr = self.sk_sh(s), self.sk_pr(s), self.im_sh(m), self.im_pr(m)
        if self.synchronized:
            fused = torch.cat([0.5 * (s_sh + m_sh), s_pr, m_pr], dim=-1)
            return self.head_sync(flatten_features(self.backbone(fused)))
        rep_s, rep_m = backbone_streams(self.backbone, [
            torch.cat([s_sh, s_pr, torch.zeros_like(m_pr)], dim=-1),
            torch.cat([m_sh, torch.zeros_like(s_pr), m_pr], dim=-1)])
        return (self.head_skel(flatten_features(rep_s)),
                self.head_sensor(flatten_features(rep_m)))


class FOCALSharedLatent3(nn.Module):
    """3-modality FOCAL: each window projected per frame to a shared (128)
    and a private (64) latent per modality; the GELU backbone over
    [shared, privates] (320 channels); sync one head on [mean of the shared,
    all privates], its logits three times; async a head a modality, on
    [own shared, own private, the others' privates zero-filled]. The async
    backbone runs the three streams in one launch."""

    def __init__(self, d_shared: int = 128, d_private: int = 64, shared_out_ch: int = 16,
                 backbone_dim: int = 8, num_classes: int = 2, synchronized: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.synchronized = synchronized
        tags = ("w", "i", "m")
        for n, c in zip(tags, IN_CHANNELS):
            setattr(self, f"{n}_sh", TorchLinear(c, d_shared, generator=g))
        for n, c in zip(tags, IN_CHANNELS):
            setattr(self, f"{n}_pr", TorchLinear(c, d_private, generator=g))
        self.backbone = GELUBackbone(d_shared + 3 * d_private, shared_out_ch, backbone_dim,
                                     generator=g)
        heads = ("head_shared",) if synchronized else ("head_w", "head_i", "head_m")
        for name in heads:
            setattr(self, name, TaskHead(backbone_dim * shared_out_ch, num_classes,
                                         generator=g))

    def forward(self, xw, xi, xm):
        xs = (xw, xi, xm)
        sh = [getattr(self, f"{n}_sh")(x) for n, x in zip("wim", xs)]
        pr = [getattr(self, f"{n}_pr")(x) for n, x in zip("wim", xs)]
        if self.synchronized:
            fused = torch.cat([_divide(sh[0] + sh[1] + sh[2], 3.0)] + pr, dim=-1)
            y = self.head_shared(flatten_features(self.backbone(fused)))
            return y, y, y
        fused = [torch.cat([sh[t]] + [pr[j] if j == t else torch.zeros_like(pr[j])
                                      for j in range(3)], dim=-1) for t in range(3)]
        reps = backbone_streams(self.backbone, fused)
        return tuple(getattr(self, name)(flatten_features(r))
                     for name, r in zip(("head_w", "head_i", "head_m"), reps))


# ---------------------------------------------------------------------------
# TACA (gaitpd/models/baselines.py:448-511,555-608)
# ---------------------------------------------------------------------------


class Tokenizer(nn.Module):
    """Time-shared frame projection + stride subsample to n_tokens
    (reference taca.py:10-34). Input is the flattened (B, T*D) window. The
    projection acts on each frame alone, so only the kept frames are
    projected."""

    def __init__(self, t_frames: int, d_frame: int, d_model: int, n_tokens: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.t_frames, self.d_frame, self.n_tokens = t_frames, d_frame, n_tokens
        self.frame_proj = TorchLinear(d_frame, d_model, use_bias=False, generator=generator)

    def forward(self, x_flat: torch.Tensor) -> torch.Tensor:
        x = x_flat.reshape(x_flat.shape[0], self.t_frames, self.d_frame)
        stride = max(1, self.t_frames // self.n_tokens)
        return self.frame_proj(x[:, ::stride][:, : self.n_tokens])


def taca_gamma(gamma0: float, schedule: str, depth_id: int, num_depths: int,
               epoch_frac: float) -> float:
    """γ schedule (reference taca.py:65-73). The epoch schedule is f32
    arithmetic, as gaitpd's on its f32 epoch fraction."""
    if schedule == "depth":
        alpha = 1.0 - depth_id / max(1, num_depths - 1)
        return 1.0 + alpha * (gamma0 - 1.0)
    if schedule == "epoch":
        f32 = np.float32
        return f32(1.0) + (f32(1.0) - f32(epoch_frac)) * f32(gamma0 - 1.0)
    return gamma0


class TACACross(nn.Module):
    """Bidirectional temperature-adjusted cross-attention
    (reference taca.py:39-97): softmax((γ/τ)·qkᵀ/√dk), no biases. ``a2b``:
    queries from a attend b; ``forward`` returns (b2a, a2b), the reference's
    order."""

    def __init__(self, d_model: int, n_heads: int = 4, tau: float = 1.0, gamma: float = 1.5,
                 schedule: str = "const", depth_id: int = 0, num_depths: int = 1,
                 drop: float = 0.0, *, generator: torch.Generator):
        super().__init__()
        self.n_heads, self.tau, self.gamma, self.schedule = n_heads, tau, gamma, schedule
        self.depth_id, self.num_depths, self.drop = depth_id, num_depths, drop
        for name in ("q_a2b", "k_b", "v_b", "o_b", "q_b2a", "k_a", "v_a", "o_a"):
            setattr(self, name, TorchLinear(d_model, d_model, use_bias=False, generator=generator))

    def _scale(self, epoch_frac: float) -> float:
        gamma = taca_gamma(self.gamma, self.schedule, self.depth_id, self.num_depths,
                           epoch_frac)
        if self.schedule == "epoch":
            return float(gamma / np.float32(self.tau))
        return gamma / self.tau

    def a2b(self, z_a, z_b, train=False, epoch_frac=0.0, generator=None):
        out = scaled_cross_attention(self.q_a2b(z_a), self.k_b(z_b), self.v_b(z_b),
                                     self.n_heads, self._scale(epoch_frac))
        return dropout(self.o_b(out), self.drop, generator, train)

    def b2a(self, z_a, z_b, train=False, epoch_frac=0.0, generator=None):
        out = scaled_cross_attention(self.q_b2a(z_b), self.k_a(z_a), self.v_a(z_a),
                                     self.n_heads, self._scale(epoch_frac))
        return dropout(self.o_a(out), self.drop, generator, train)

    def forward(self, z_a, z_b, train=False, epoch_frac=0.0, generator=None):
        return (self.b2a(z_a, z_b, train, epoch_frac, generator),
                self.a2b(z_a, z_b, train, epoch_frac, generator))


class TACAWrapper(nn.Module):
    """2-modality TACA (reference taca.py:102-171; gaitpd/models/
    baselines.py:514-552): tokenize the flattened (B, T * D) windows, fuse
    both ways, mean-pool; sync one joint head on the mean of both enhanced
    pools, async a head a modality."""

    def __init__(self, skel_t: int, skel_d: int, sens_t: int, sens_d: int, num_classes: int,
                 d_model: int = 96, n_heads: int = 4, n_tok_s: int = 4, n_tok_e: int = 4,
                 tau: float = 1.0, gamma: float = 1.5, schedule: str = "const",
                 num_depths: int = 1, drop: float = 0.1, synchronized: bool = False, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.synchronized = synchronized
        self.tk_s = Tokenizer(skel_t, skel_d, d_model, n_tok_s, generator=g)
        self.tk_e = Tokenizer(sens_t, sens_d, d_model, n_tok_e, generator=g)
        self.fuser = TACACross(d_model, n_heads, tau, gamma, schedule, 0, num_depths, drop,
                               generator=g)
        heads = ("head_joint",) if synchronized else ("head_skel", "head_sens")
        for name in heads:
            setattr(self, name, TorchLinear(d_model, num_classes, generator=g))

    def forward(self, x_skel_flat, x_sens_flat, train: bool = False, epoch_frac: float = 0.0,
                generator: Optional[torch.Generator] = None):
        y_sens, y_skel = self.fuser(self.tk_s(x_skel_flat), self.tk_e(x_sens_flat), train,
                                    epoch_frac, generator)
        if self.synchronized:
            return self.head_joint(0.5 * (y_skel.mean(1) + y_sens.mean(1)))
        return self.head_skel(y_skel.mean(1)), self.head_sens(y_sens.mean(1))


class TACA3TriWrapper(nn.Module):
    """3-modality TACA with pairwise fusers W<->I, W<->M, I<->M (reference
    taca.py:175-249). Sync: the per-stream enhancements averaged into one
    joint head, its logits three times; async: a head a stream, the insole
    and IMU heads on the walkway-attending sequences (``allow_async_cross``)
    or on their own tokens. Inputs are flattened windows (B, T*C)."""

    def __init__(self, win_len: int, num_classes: int, d_model: int = 128, n_heads: int = 4,
                 n_tok: int = 8, tau: float = 1.0, gamma: float = 1.5,
                 schedule: str = "const", drop: float = 0.1, allow_async_cross: bool = True,
                 synchronized: bool = True, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.synchronized, self.allow_async_cross = synchronized, allow_async_cross
        for n, c in zip("wim", IN_CHANNELS):
            setattr(self, f"tk_{n}", Tokenizer(win_len, c, d_model, n_tok, generator=g))
        if synchronized or allow_async_cross:  # else gaitpd calls no fuser: no parameters
            for name in ("wi", "wm", "im"):
                setattr(self, name, TACACross(d_model, n_heads, tau, gamma, schedule,
                                              drop=drop, generator=g))
        heads = ("head_joint",) if synchronized else ("head_w", "head_i", "head_m")
        for name in heads:
            setattr(self, name, TorchLinear(d_model, num_classes, generator=g))

    def forward(self, xw_flat, xi_flat, xm_flat, train: bool = False, epoch_frac: float = 0.0,
                generator: Optional[torch.Generator] = None):
        zw, zi, zm = self.tk_w(xw_flat), self.tk_i(xi_flat), self.tk_m(xm_flat)
        kw = dict(train=train, epoch_frac=epoch_frac, generator=generator)
        if self.synchronized:
            wi_e2w, wi_w2i = self.wi(zw, zi, **kw)
            wm_e2w, wm_w2m = self.wm(zw, zm, **kw)
            im_e2i, im_i2m = self.im(zi, zm, **kw)
            w_enh = 0.5 * (wi_e2w + wm_e2w)
            i_enh = 0.5 * (wi_w2i + im_e2i)
            m_enh = 0.5 * (wm_w2m + im_i2m)
            y = self.head_joint(_divide(w_enh.mean(1) + i_enh.mean(1) + m_enh.mean(1), 3.0))
            return y, y, y
        if self.allow_async_cross:
            zi, zm = self.wi.a2b(zw, zi, **kw), self.wm.a2b(zw, zm, **kw)
        return self.head_w(zw.mean(1)), self.head_i(zi.mean(1)), self.head_m(zm.mean(1))
