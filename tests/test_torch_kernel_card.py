"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips where there is no CUDA device (the kernels
have no CPU mode). This file imports no JAX, so it runs on a machine with a
card and PyTorch alone:

    python -m pytest tests/test_torch_kernel_card.py -m gpu

Tolerances: the stream block's forward and gx within 1e-5 absolute (f32,
only the order of summation differs); gw and gb within 1e-5 of the largest
reference value, since they sum over every frame of the batch in another
order. The CAGrad solver: w within 1e-4 and the objective within 1e-6
relative (the kernel runs the plain version's IEEE operations in its order,
so on the card the two agree to the bit, which is held too). The cheap
cross-attention: the forward within 1e-5 absolute up to 64 keys and, over
more keys, within gaitpd's own Pallas-vs-jnp bound of 2e-5 absolute plus
2e-4 relative (tests/test_pallas.py:62); dA and dB within 1e-5 absolute plus 1e-4
relative (tests/test_pallas.py:70), and two backward launches bitwise equal.
The stream block's backward skips windows whose cotangent is all zero: with
zero rows and with a NaN in such a window it must give the plain version's
result, with NaN at the same entries. Under ReLU a pre-activation within f32
rounding of 0 may take ReLU' on either side in the kernel and in the plain
version, both right: gx leaves out such windows (at most two a case, found
from the inputs in f64) and gw and gb allow what their flips may move. The MGDA, FairGrad and NashMTL
solvers: w bitwise equal to the plain version's (the same IEEE operations
in the same order, the same device powf), finite, MGDA's on the simplex;
MGDA's one-thread design, by name, bitwise equal too. Under
``torch.func.vmap`` over F folds each of the four solvers is one launch,
each fold's weights the bits of a launch of its own.
"""

import numpy as np
import pytest
import torch

from gaitpd_torch.ops import cagrad_solver as cs
from gaitpd_torch.ops import cheap_xattn as cx
from gaitpd_torch.ops import stream_block as sb
from gaitpd_torch.runtime import fold_draws as FD
from gaitpd_torch.runtime.device import resolve_device

# (B, T, C_in, K, C_out, t_out, act): the cases of test_torch_stream_block,
# the serving path's shape (3 streams x 1024 windows, plus a ragged tail),
# the fusion baselines' backbone widths: the early fusion's concatenated
# 36 channels and the shared latent's 16, and the FBG/FoG backbone at its
# train batch: both streams of 256 windows in one launch, T 101 pooled to 8
# overlapping bins, C_in 3 (FBG) and 6 (FoG); the FBG/FoG baseline drivers'
# backbones at T 101: early fusion (C_in 12), the shared latent (2 x 256
# windows, C_in 16) and FOCAL's 2-modality one (2 x 256 windows, C_in 32,
# C_out 4 pooled to 4 overlapping bins)
CASES = [
    (3 * 64, 64, 36, 3, 16, 8, "relu"),
    (3 * 64 + 1, 64, 16, 3, 16, 8, "relu"),
    (8, 64, 13, 3, 16, 8, "relu"),
    (8, 64, 13, 5, 16, 8, "gelu"),
    (4, 101, 6, 3, 16, 8, "relu"),
    (3, 101, 13, 5, 16, 8, "gelu"),
    (5, 30, 4, 1, 7, 4, "relu"),
    (3, 5, 4, 3, 6, 8, "gelu"),
    (3 * 1024 + 3, 64, 12, 3, 16, 8, "relu"),
    (2 * 256, 101, 3, 3, 16, 8, "relu"),
    (2 * 256, 101, 6, 3, 16, 8, "relu"),
    (256, 101, 12, 3, 16, 8, "relu"),
    (2 * 256, 101, 16, 3, 16, 8, "relu"),
    (2 * 256, 101, 32, 3, 4, 4, "relu"),
]


def _numpy_inputs(case, seed=0):
    bsz, t, cin, k, cout, t_out, _ = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bsz, t, cin)).astype(np.float32)
    w = (rng.normal(size=(k, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(bsz, t_out, cout)).astype(np.float32)
    return x, w, b, g


def _inputs(case, dev, seed=0):
    return [torch.from_numpy(a).to(dev) for a in _numpy_inputs(case, seed)]


# ReLU' at a pre-activation z within f32 rounding of 0: the kernel and the
# plain version sum z's conv terms in different orders, so each may round z
# to its own side of 0, and both are right. From a case's numpy inputs in
# f64: z and its rounding unit eps_f32 * (|b| + sum |w x|) of each (window,
# frame, channel); an entry within KINK_UNITS units of 0, whose cotangent
# is not 0, is a kink. At 2 units every case of this file holds at most
# two kink windows; the FoG backbone's case holds exactly window 503
# (|z| = 0.016 units; its next window lies 20.7 units out).
KINK_UNITS = 2.0
KINK_MAX_WINDOWS = 2
FOG_KINK_CASE, FOG_KINK_WINDOWS = (2 * 256, 101, 6, 3, 16, 8, "relu"), [503]


def _relu_kinks(case, zero=None, seed=0):
    """The kink windows of ``case`` (its inputs from ``seed``, g's rows
    ``zero`` set to 0), and what the flips of their ReLU' may move gw and gb
    by: the sums of |g_z| and |g_z x| over the kink entries, g_z the
    cotangent of z. (sorted window list, gw allowance (K, C_in, C_out), gb
    allowance (C_out,)), on the CPU in f64."""
    x, w, b, g = (a.astype(np.float64) for a in _numpy_inputs(case, seed))
    k, t, t_out = w.shape[0], x.shape[1], case[5]
    if case[6] != "relu":
        return [], np.zeros(w.shape), np.zeros(b.shape)
    if zero is not None:
        g[zero] = 0.0
    xp = np.pad(x, ((0, 0), (k // 2, k // 2), (0, 0)))
    z = np.broadcast_to(b, x.shape[:2] + b.shape).copy()
    terms = np.broadcast_to(np.abs(b), z.shape).copy()
    for i in range(k):
        z += xp[:, i:i + t] @ w[i]
        terms += np.abs(xp[:, i:i + t]) @ np.abs(w[i])
    pool = sb.adaptive_avg_pool_matrix(t, t_out, torch.device("cpu")).double().numpy()
    gz = np.einsum("to,boc->btc", pool, g)
    kink = (np.abs(z) <= KINK_UNITS * np.finfo(np.float32).eps * terms) & (gz != 0)
    gzk = np.abs(np.where(kink, gz, 0.0))
    gw_allow = np.stack([np.einsum("btc,btf->cf", np.abs(xp[:, i:i + t]), gzk) for i in range(k)])
    return sorted(set(np.nonzero(kink)[0].tolist())), gw_allow, gzk.sum((0, 1))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return resolve_device("cuda")


def _grams(rng, n, k):
    a = rng.normal(size=(n, k, 6)) * rng.uniform(0.1, 10.0, size=(n, 1, 1))
    grams = a @ a.transpose(0, 2, 1) + 1e-4 * np.eye(k)
    v = rng.normal(size=k)
    degenerate = [np.zeros((k, k)), np.outer(v, v), np.ones((k, k)) * 2.0]
    z = grams[0].copy()
    z[0, :] = z[:, 0] = 0.0  # one task with a zero gradient
    return np.concatenate([grams, np.stack(degenerate + [z])]).astype(np.float32)


def _objective(w, gram, c):
    k = gram.shape[-1]
    c_coef = c * np.sqrt(gram.mean((-2, -1)) + 1e-8) + 1e-8
    gb = gram @ (np.ones(k) / k)
    return (w * gb).sum(-1) + c_coef * np.sqrt(np.einsum("ni,nij,nj->n", w, gram, w) + 1e-8)


# the forward's variant edges (tests/test_torch_stream_block.py holds the
# choice): the warp_tile variant's compiled-in sizes (T 64, C_out 16, K 3,
# t_out 8, C_in 12/16/36) with both activations and a ragged last block,
# against one size off each (the per_frame variant); per_frame at T 101:
# t_out 7 (no bin edge shared with t_out 8), K 1 and 5, C_out 3 (a part-filled
# quad), C_in 13 and 30 (4-byte copies), one window; per_frame's
# shared-memory edge and one frame beyond it (the generic variant)
FORWARD_EDGE_CASES = [
    (4 * 5 + 3, 64, 12, 3, 16, 8, "gelu"), (4 * 5 + 1, 64, 16, 3, 16, 8, "gelu"),
    (4 * 5 + 2, 64, 36, 3, 16, 8, "gelu"), (9, 64, 13, 3, 16, 8, "relu"),
    (9, 64, 24, 3, 16, 8, "gelu"), (9, 101, 12, 3, 16, 8, "relu"),
    (9, 63, 12, 3, 16, 8, "relu"), (9, 64, 12, 1, 16, 8, "gelu"),
    (9, 64, 12, 5, 16, 8, "relu"), (9, 64, 12, 3, 16, 7, "relu"),
    (9, 64, 12, 3, 8, 8, "gelu"), (1, 64, 12, 3, 16, 8, "relu"),
    (5, 101, 16, 3, 16, 7, "gelu"), (4, 101, 6, 1, 16, 8, "relu"),
    (4, 101, 32, 5, 4, 4, "gelu"), (6, 101, 6, 3, 3, 8, "relu"),
    (5, 101, 13, 3, 16, 8, "relu"), (3, 101, 30, 3, 4, 4, "gelu"),
    (1, 101, 32, 3, 4, 4, "relu"), (1, 101, 6, 3, 16, 8, "gelu"),
    (2, 7261, 1, 1, 1, 8, "relu"), (2, 7262, 1, 1, 1, 8, "relu"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES + FORWARD_EDGE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_kernel_matches_plain_on_card(case):
    dev = _cuda()
    x, w, b, _ = _inputs(case, dev)
    before = sb.launches
    got = sb.stream_block(x, w, b, case[5], case[6])
    again = sb.stream_block(x, w, b, case[5], case[6])
    torch.cuda.synchronize()
    assert sb.launches == before + 2
    want = sb.stream_block_reference(x, w, b, case[5], case[6])
    assert (got - want).abs().max().item() <= 1e-5
    assert torch.equal(got, again)  # deterministic: the same bits twice


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES + FORWARD_EDGE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_forward_launch_config_on_card(case):
    """The launch of the variant the sizes take: at least one block an SM,
    and a grid that covers the windows (per_frame: one a block; warp_tile:
    four; wide, from C_in 17: 1, 2, 4 or 8)."""
    _cuda()
    bsz, t, cin, k, cout, t_out, act = case
    config = sb.forward_config(bsz, t, cin, cout, k, t_out, act)
    assert config["variant"] == sb.VARIANT_NAMES[sb._variant(t, cin, cout, k, t_out)]
    assert config["threads"] > 0 and config["blocks_per_sm"] >= 1
    windows = {"per_frame": (1,), "wide": (1, 2, 4, 8)}.get(config["variant"], (4,))
    assert config["windows"] in windows
    assert config["blocks"] == -(-bsz // config["windows"])
    assert config["smem_bytes"] <= sb.MAX_SMEM_BYTES


@pytest.mark.gpu
@pytest.mark.parametrize("cin", [6, 32])
def test_per_frame_forward_on_unaligned_x_on_card(cin):
    """x one float past a 16-byte boundary: per_frame copies it 4 bytes at a
    time, within 1e-5 of the plain version, the same bits twice."""
    dev = _cuda()
    x, w, b, _ = _inputs((7, 101, cin, 3, 4, 4, "relu"), dev)
    x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(x.shape)
    assert x.data_ptr() % 16 != 0 and sb._variant(101, cin, 4, 3, 4) == sb.PER_FRAME
    got = sb.stream_block(x, w, b, 4)
    assert (got - sb.stream_block_reference(x, w, b, 4)).abs().max().item() <= 1e-5
    assert torch.equal(got, sb.stream_block(x, w, b, 4))


# FOCAL's backbone: 128 + 3 * 64 = 320 input channels, exact GELU (and
# ReLU), at a train step's batch (sync), the async one-launch batch, a
# ragged one and one window; then the wide variants' other widths: C_in 100
# and 330 (not multiples of the 32-channel chunk; 330 not of 4 either, so
# copied 4 bytes at a time), the threshold 64, and 1024, wider than the
# generic forward and backward take
FOCAL_CASES = [
    (64, 64, 320, 3, 16, 8, "gelu"), (3 * 64, 64, 320, 3, 16, 8, "gelu"),
    (37, 64, 320, 3, 16, 8, "relu"), (1, 64, 320, 3, 16, 8, "gelu"),
    (37, 64, 100, 3, 16, 8, "gelu"), (3 * 64, 64, 330, 3, 16, 8, "relu"),
    (1, 64, 330, 3, 16, 8, "gelu"), (64, 64, 64, 3, 16, 8, "relu"),
    (37, 64, 1024, 3, 16, 8, "gelu"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FOCAL_CASES, ids=lambda c: "-".join(map(str, c)))
def test_kernels_match_plain_at_focal_width_on_card(case):
    """The wide variants: forward within 1e-5, gx within 1e-5, gw and gb
    within 1e-5 of their largest value, two launches of each the same bits;
    the launches have a block an SM at least and grids that cover the
    windows."""
    dev = _cuda()
    bsz, t, cin, k, cout, t_out, act = case
    x, w, b, g = _inputs(case, dev)
    before = (sb.launches, sb.backward_launches)
    got = sb.stream_block(x, w, b, t_out, act)
    assert (got - sb.stream_block_reference(x, w, b, t_out, act)).abs().max().item() <= 1e-5
    assert torch.equal(got, sb.stream_block(x, w, b, t_out, act))
    grads = sb.stream_block_backward(x, w, b, g, t_out, act)
    again = sb.stream_block_backward(x, w, b, g, t_out, act)
    torch.cuda.synchronize()
    assert (sb.launches, sb.backward_launches) == (before[0] + 2, before[1] + 2)
    want = sb.stream_block_backward_reference(x, w, b, g, t_out, act)
    assert (grads[0] - want[0]).abs().max().item() <= 1e-5
    for gk, wk in zip(grads[1:], want[1:]):
        assert (gk - wk).abs().max().item() <= 1e-5 * max(1.0, wk.abs().max().item())
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
    config = sb.forward_config(bsz, t, cin, cout, k, t_out, act)
    assert config["variant"] == "wide" and config["blocks_per_sm"] >= 1
    assert config["blocks"] == -(-bsz // config["windows"])
    bwd = sb.backward_config(bsz, t, cin, cout, k, t_out, act)
    assert bwd["variant"] == "wide" and bwd["blocks_per_sm"] >= 1
    assert bwd["gz"]["blocks_per_sm"] >= 1 and bwd["gz"]["blocks"] == config["blocks"]
    assert bwd["blocks"] % -(-cin // 32) == 0 and bwd["windows"] >= 1


# the wide kernels take any C_in at their T, C_out, K and t_out;
# stream_block's wrapper picks them from WIDE_MIN_CIN = 17: below it, where
# per_frame and the generic backward run, at C_in 13 (4-byte copies, one
# part-filled chunk) and 15
BELOW_WIDE_CASES = [(37, 64, 13, 3, 16, 8, "gelu"), (3 * 64, 64, 15, 3, 16, 8, "relu")]


@pytest.mark.gpu
@pytest.mark.parametrize("case", BELOW_WIDE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_wide_kernels_below_their_threshold_on_card(case):
    """The wide variants, asked for by name below WIDE_MIN_CIN, within the
    same tolerances of the plain versions, two launches the same bits."""
    dev = _cuda()
    bsz, t, cin, k, cout, t_out, act = case
    x, w, b, g = _inputs(case, dev)
    assert sb._variant(t, cin, cout, k, t_out) == sb.PER_FRAME
    got = sb._forward_kernel(x, w, b, t_out, act, sb.WIDE)
    assert (got - sb.stream_block_reference(x, w, b, t_out, act)).abs().max().item() <= 1e-5
    assert torch.equal(got, sb._forward_kernel(x, w, b, t_out, act, sb.WIDE))
    grads = sb._backward_kernel(x, w, b, g, t_out, act, sb.BWD_WIDE)
    _backward_close(grads, sb.stream_block_backward_reference(x, w, b, g, t_out, act))
    again = sb._backward_kernel(x, w, b, g, t_out, act, sb.BWD_WIDE)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_wide_backward_on_zero_cotangent_windows_and_a_nan(act):
    """The wide backward skips no window: on CAGrad-like zero rows at FOCAL's
    width it gives the plain version's result, gx of the zero-cotangent
    windows exactly 0; with a NaN in x of such a window, NaN at the plain
    version's entries (gw NaN: 0 * NaN)."""
    dev = _cuda()
    case = (3 * 64, 64, 320, 3, 16, 8, act)
    x, w, b, g = _inputs(case, dev)
    g[64:] = 0.0
    got = sb.stream_block_backward(x, w, b, g, 8, act)
    _backward_close(got, sb.stream_block_backward_reference(x, w, b, g, 8, act))
    assert not got[0][64:].any()
    assert all(torch.equal(a, c) for a, c in zip(got, sb.stream_block_backward(x, w, b, g, 8, act)))
    x[100, 20, 5] = float("nan")
    got = sb.stream_block_backward(x, w, b, g, 8, act)
    assert torch.isnan(got[1]).any()
    _backward_close(got, sb.stream_block_backward_reference(x, w, b, g, 8, act))


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_backward_kernel_matches_plain_on_card(case):
    """gx within 1e-5 outside the ReLU kink windows, gw and gb within 1e-5
    of their largest value plus what the kinks' ReLU' may move them by; the
    same bits twice."""
    dev = _cuda()
    x, w, b, g = _inputs(case, dev)
    before = sb.backward_launches
    got = sb.stream_block_backward(x, w, b, g, case[5], case[6])
    again = sb.stream_block_backward(x, w, b, g, case[5], case[6])
    torch.cuda.synchronize()
    assert sb.backward_launches == before + 2
    want = sb.stream_block_backward_reference(x, w, b, g, case[5], case[6])
    kinks = _relu_kinks(case)
    assert len(kinks[0]) <= KINK_MAX_WINDOWS
    if case == FOG_KINK_CASE:
        assert kinks[0] == FOG_KINK_WINDOWS
    _backward_close(got, want, kinks)
    for a, c in zip(got, again):  # deterministic: the same bits twice
        assert torch.equal(a, c)


# rows of g set to zero: the CAGrad task passes at the main shape (a third
# of the rows live), zero rows that start and end inside a block's tile, and
# no live row at all
ZERO_LAYOUTS = {
    "cagrad_walkway_task": ((3 * 1024, 64, 12, 3, 16, 8, "relu"), np.r_[1024:3072]),
    "cagrad_insole_task": ((3 * 1024, 64, 12, 3, 16, 8, "relu"), np.r_[0:1024, 2048:3072]),
    "unaligned": ((3 * 64 + 1, 64, 12, 3, 16, 8, "relu"), np.r_[5:150]),
    "unaligned_gelu_t101": ((37, 101, 13, 5, 16, 8, "gelu"), np.r_[3:30]),
    "all_zero": ((3 * 64, 64, 12, 3, 16, 8, "relu"), np.r_[0:192]),
    # the FBG/FoG async CAGrad task passes: one stream's 256 windows live
    "fog_skeleton_task": ((2 * 256, 101, 6, 3, 16, 8, "relu"), np.r_[256:512]),
    "fbg_sensor_task": ((2 * 256, 101, 3, 3, 16, 8, "relu"), np.r_[0:256]),
}


def _backward_close(got, want, kinks=None):
    """gx within 1e-5; gw, gb within 1e-5 of their largest value; NaN at the
    same entries. With ``kinks`` (from _relu_kinks) gx leaves out the kink
    windows, and gw and gb may differ by the kinks' allowance beyond."""
    windows, *allow = kinks or ([], 0.0, 0.0)
    for i, (gk, wk) in enumerate(zip(got, want)):
        if i == 0 and windows:
            keep = torch.ones(len(gk), dtype=torch.bool, device=gk.device)
            keep[windows] = False
            gk, wk = gk[keep], wk[keep]
        assert torch.equal(torch.isnan(gk), torch.isnan(wk))
        ok = ~torch.isnan(wk)
        if not ok.any():
            continue
        tol = 1e-5 if i == 0 else 1e-5 * max(1.0, wk[ok].abs().max().item())
        extra = 0.0 if i == 0 else torch.as_tensor(allow[i - 1], device=gk.device).float()
        assert bool(((gk - wk).abs() <= tol + extra)[ok].all())


@pytest.mark.gpu
@pytest.mark.parametrize("layout", sorted(ZERO_LAYOUTS))
def test_backward_kernel_skips_zero_cotangent_windows_exactly(layout):
    dev = _cuda()
    case, zero = ZERO_LAYOUTS[layout]
    x, w, b, g = _inputs(case, dev)
    g[torch.from_numpy(zero).to(dev)] = 0.0
    got = sb.stream_block_backward(x, w, b, g, case[5], case[6])
    again = sb.stream_block_backward(x, w, b, g, case[5], case[6])
    want = sb.stream_block_backward_reference(x, w, b, g, case[5], case[6])
    kinks = _relu_kinks(case, zero)
    assert len(kinks[0]) <= KINK_MAX_WINDOWS
    _backward_close(got, want, kinks)
    assert not got[0][torch.from_numpy(zero).to(dev)].any()  # gx exactly 0
    for a, c in zip(got, again):
        assert torch.equal(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_backward_kernel_keeps_nan_of_a_zero_cotangent_window(act):
    """A NaN in x of a window whose cotangent is zero makes gw NaN (0 * NaN),
    and with GELU gb and gx too: the kernel's NaN pattern is the plain
    version's."""
    dev = _cuda()
    case = (3 * 64, 64, 12, 3, 16, 8, act)
    x, w, b, g = _inputs(case, dev)
    g[64:] = 0.0
    x[100, 20, 5] = float("nan")
    got = sb.stream_block_backward(x, w, b, g, 8, act)
    want = sb.stream_block_backward_reference(x, w, b, g, 8, act)
    assert torch.isnan(got[1]).any()
    _backward_close(got, want)


@pytest.mark.gpu
def test_autograd_goes_through_the_backward_kernel():
    dev = _cuda()
    x, w, b, g = _inputs(CASES[0], dev)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    before = (sb.launches, sb.backward_launches)
    out = sb.stream_block(*leaves, CASES[0][5], CASES[0][6])
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (sb.launches, sb.backward_launches) == (before[0] + 1, before[1] + 1)
    want = sb.stream_block_backward_reference(x, w, b, g, CASES[0][5], CASES[0][6])
    for gk, wk in zip(grads, want):
        assert (gk - wk).abs().max().item() <= 1e-5 * max(1.0, wk.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("k", range(1, 9))
def test_solver_kernel_matches_plain_on_card(k):
    """A batch of seeded and degenerate Gram matrices in one launch, then
    each matrix alone (the main path's launch): w bitwise equal to the plain
    version's on every matrix."""
    dev = _cuda()
    grams = torch.from_numpy(_grams(np.random.default_rng(k), 40, k)).to(dev)
    before = cs.launches
    got = cs.cagrad_solve(grams, 0.5)
    torch.cuda.synchronize()
    assert cs.launches == before + 1
    want = cs.cagrad_solve_reference(grams, 0.5)
    assert torch.equal(got, want)
    for i in (0, 1, len(grams) - 4, len(grams) - 3, len(grams) - 2, len(grams) - 1):
        assert torch.equal(cs.cagrad_solve(grams[i], 0.5), want[i])
    gn, wn, gram_np = got.cpu().double().numpy(), want.cpu().double().numpy(), grams.cpu().double().numpy()
    assert np.all(gn >= 0) and np.allclose(gn.sum(-1), 1.0, atol=1e-5)
    f_got, f_want = _objective(gn, gram_np, 0.5), _objective(wn, gram_np, 0.5)
    assert np.all(np.abs(f_got - f_want) <= 1e-6 * np.maximum(np.abs(f_want), 1e-12))
    assert np.abs(gn - wn).max() <= 1e-4, np.abs(gn - wn).max(-1)


# (N, Tq, Tk, d): the training path's six pairs of 64 window tuples, an odd
# batch, tests/test_pallas.py:56-70's shapes, the symmetric 2-mod shape, one
# query row, one key row, d not a multiple of 4, the largest register row,
# wider d (tiles in shared memory), odd and a multiple of 4, and the FBG/FoG
# cross-attention fusion's two directions at T 101 (the sweep over 128 keys):
# FoG's d = 6 at batch 256, FBG's d = 3 at batch 32
XATTN_CASES = [
    (6 * 64, 64, 64, 12), (6 * 33 + 1, 64, 64, 12), (2, 101, 426, 12), (2, 200, 100, 12),
    (2, 32, 48, 8), (2 * 64, 101, 101, 12), (5, 1, 64, 12), (5, 64, 1, 12),
    (3, 37, 53, 6), (2, 130, 257, 64), (2, 8, 8, 65), (3, 37, 70, 96), (2, 20, 130, 200),
    (2 * 256, 101, 101, 6), (2 * 32, 101, 101, 3),
]
# each variant's edges (tests/test_torch_cheap_xattn.py holds the choice): the
# sweep kernels at Tk = 64 and Tk = 65 (the sweep over 128 keys), Tq = 64 and
# 65 (its backward; the forward's second 64-row unit), masked scores (Tk =
# 63), d = 12 (the compile-time width) against 8, 16, 36 and 64 (the general
# widths), N odd (a block's second unit idle in the last round) and N above
# one round of the persistent grid, at the main shape plus one problem; then
# the sweep over 128 keys at T 101 (d 6 and 3, its width 8 at d 8 against 16
# at d 9), at 128 and 129 keys (the sweep over key tiles beyond 128), 129
# query rows against 64 keys (its backward), d 64 over 128 keys, and N above
# one round of its persistent grid at FoG's shape
XATTN_EDGE_CASES = [
    (7, 64, 64, 12), (7, 64, 65, 12), (7, 65, 64, 12), (7, 65, 65, 12), (5, 64, 63, 12),
    (5, 64, 64, 8), (5, 64, 64, 16), (5, 64, 64, 36), (3, 33, 47, 36), (5, 64, 64, 64),
    (3, 130, 20, 12), (6 * 1024 + 1, 64, 64, 12),
    (7, 101, 101, 6), (7, 101, 101, 3), (5, 101, 101, 8), (5, 101, 101, 9),
    (5, 128, 128, 12), (5, 128, 129, 12), (5, 129, 64, 12), (5, 65, 128, 64),
    (2 * 1024 + 1, 101, 101, 6),
]
# the sweep over key tiles (d <= 64 beyond 128 keys; backward also beyond
# 128 query rows): Tk 129 (a second tile of one key), 192, 255 (an odd
# last key), 256, 257 and 426; Tq > 128 against Tk <= 64 and <= 128 (the
# backward alone); one query row; d 3, 6, 8 (width 8), 12 (the compile-time
# width), 13 (4-byte copies), 33 and 64 (width 64); N 5, 128 and 384, the
# --win_len 256 fusion's 384 problems of 256 x 256 at d 12 (several rounds
# of both persistent grids), and N above one round at T 129
SWEEP_LONG_CASES = [
    (5, 128, 129, 12), (5, 64, 192, 12), (5, 100, 255, 6), (5, 129, 256, 3), (5, 65, 257, 8),
    (5, 101, 426, 12), (5, 1, 300, 12), (5, 129, 64, 12), (5, 130, 20, 13), (5, 200, 100, 8),
    (5, 129, 129, 64), (3, 70, 300, 64), (3, 140, 200, 33), (5, 300, 131, 13),
    (128, 129, 129, 12), (384, 256, 256, 12), (1000, 129, 130, 6),
]


def _xattn_inputs(case, dev, seed=0):
    n, tq, tk, d = case
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
            for s in ((n, tq, d), (n, tk, d), (n, tq, d))]


def _xattn_close(got, want, atol, rtol):
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", XATTN_CASES + XATTN_EDGE_CASES + SWEEP_LONG_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cheap_xattn_kernels_match_plain_on_card(case):
    dev = _cuda()
    a, b, g = _xattn_inputs(case, dev)
    before = (cx.launches, cx.backward_launches)
    got = cx.cheap_xattn(a, b)
    got_again = cx.cheap_xattn(a, b)
    grads = cx.cheap_xattn_backward(a, b, g)
    again = cx.cheap_xattn_backward(a, b, g)
    torch.cuda.synchronize()
    assert (cx.launches, cx.backward_launches) == (before[0] + 2, before[1] + 2)
    want = cx.cheap_xattn_reference(a, b)
    if case[2] <= 64:
        assert (got - want).abs().max().item() <= 1e-5
    else:
        assert _xattn_close(got, want, 2e-5, 2e-4)
    assert torch.equal(got, got_again)
    for gk, wk, ak in zip(grads, cx.cheap_xattn_backward_reference(a, b, g), again):
        assert _xattn_close(gk, wk, 1e-5, 1e-4)
        assert torch.equal(gk, ak)  # deterministic: the same bits twice


@pytest.mark.gpu
@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("case", XATTN_EDGE_CASES + SWEEP_LONG_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cheap_xattn_launch_config_on_card(case, backward):
    """The launch of the variant the sizes take: the card holds at least one
    block an SM, and the sweep forwards' persistent grid is no larger than
    the card holds at once nor than their units of 64 query rows; the
    backward of the sweep over 128 keys takes a block a problem; the sweep
    over key tiles' backward makes two launches on persistent grids, units
    of 64 query rows, then of 64 keys."""
    _cuda()
    n, tq, tk, d = case
    config = cx.launch_config(n, tq, tk, d, backward)
    assert config["variant"] == cx.VARIANT_NAMES[cx._variant(tq, tk, d, backward)]
    assert config["threads"] > 0 and config["blocks_per_sm"] >= 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def persistent(c, units):
        return 1 <= c["blocks"] <= min(units, c["blocks_per_sm"] * sms)

    if not backward and config["variant"].startswith("sweep"):
        assert persistent(config, n * -(-tq // cx.SWEEP_T))
    if backward and config["variant"] == "sweep_128":
        assert config["blocks"] == n
    if backward and config["variant"] == "sweep_long":
        assert persistent(config, n * -(-tq // cx.SWEEP_T))
        assert config["keys"]["blocks_per_sm"] >= 1
        assert persistent(config["keys"], n * -(-tk // cx.SWEEP_T))
    else:
        assert "keys" not in config


# the tiles in shared memory (d > 64, both ways): d 65 (not a multiple of
# 4: 4-byte copies), 96, 128 (one forward chunk), 130 and 200 (a second,
# part-filled forward chunk), 256 (two); Tk 63 (a masked key) and 64, then
# 65, 128 and 130 (a second and third key tile, the online softmax); Tq 1,
# 64, 65 (a second 64-row unit) and 128; N above one round of the grid
# (the forward's persistent grid; the backward's block a problem)
TILED_CASES = [
    (3, 64, 64, 96), (2, 64, 63, 96), (2, 1, 64, 96), (2, 65, 64, 96), (2, 64, 64, 65),
    (2, 65, 63, 65), (2, 1, 1, 65), (2, 64, 64, 128), (2, 1, 63, 128), (2, 64, 64, 256),
    (2, 65, 64, 256), (3, 33, 47, 200), (2, 70, 20, 130), (6 * 64, 64, 64, 96),
    (2000, 64, 64, 96),
    (3, 64, 65, 96), (2, 128, 128, 96), (2, 1, 128, 96), (2, 65, 130, 96), (2, 128, 65, 65),
    (2, 1, 130, 65), (2, 65, 128, 200), (2, 128, 130, 256), (2, 1, 65, 256),
    (6 * 64, 128, 128, 96), (1000, 128, 128, 96),
]


def _tiled_launch_ok(n, tq, tk, d, backward):
    """The launch names the tiled variant, holds a block an SM, and covers
    the work: the forward's persistent grid no larger than the card holds
    at once nor than the units of 64 query rows; the backward a block a
    problem."""
    config = cx.launch_config(n, tq, tk, d, backward)
    assert config["variant"] == "tiled" and config["blocks_per_sm"] >= 1
    if backward:
        assert config["blocks"] == n
    else:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        units = n * -(-tq // cx.SWEEP_T)
        assert 1 <= config["blocks"] <= min(units, config["blocks_per_sm"] * sms)


@pytest.mark.gpu
@pytest.mark.parametrize("case", TILED_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cheap_xattn_tiled_forward_on_card(case):
    """Within 1e-5 of the plain version up to 64 keys, and beyond them
    within 2e-5 + 2e-4 relative (the online softmax rescales, as gaitpd's
    Pallas kernel does: tests/test_pallas.py:62); the same bits from two
    launches; the tiled launch."""
    dev = _cuda()
    n, tq, tk, d = case
    a, b, _ = _xattn_inputs(case, dev)
    before = cx.launches
    got = cx.cheap_xattn(a, b)
    again = cx.cheap_xattn(a, b)
    torch.cuda.synchronize()
    assert cx.launches == before + 2
    want = cx.cheap_xattn_reference(a, b)
    if tk <= cx.SWEEP_T:
        assert (got - want).abs().max().item() <= 1e-5
    else:
        assert _xattn_close(got, want, 2e-5, 2e-4)
    assert torch.equal(got, again)
    _tiled_launch_ok(n, tq, tk, d, backward=False)


@pytest.mark.gpu
@pytest.mark.parametrize("case", TILED_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cheap_xattn_tiled_backward_on_card(case):
    """dA and dB within 1e-5 + 1e-4 relative of the plain version
    (tests/test_pallas.py:70), the same bits from two launches; the tiled
    launch."""
    dev = _cuda()
    n, tq, tk, d = case
    a, b, g = _xattn_inputs(case, dev)
    before = cx.backward_launches
    got = cx.cheap_xattn_backward(a, b, g)
    again = cx.cheap_xattn_backward(a, b, g)
    torch.cuda.synchronize()
    assert cx.backward_launches == before + 2
    for gk, wk, ak in zip(got, cx.cheap_xattn_backward_reference(a, b, g), again):
        assert _xattn_close(gk, wk, 1e-5, 1e-4)
        assert torch.equal(gk, ak)
    _tiled_launch_ok(n, tq, tk, d, backward=True)


@pytest.mark.gpu
def test_autograd_goes_through_the_cheap_xattn_backward_kernel():
    dev = _cuda()
    a, b, g = _xattn_inputs(XATTN_CASES[0], dev)
    leaves = [t.clone().requires_grad_() for t in (a, b)]
    before = (cx.launches, cx.backward_launches)
    grads = torch.autograd.grad(cx.cheap_xattn(*leaves), leaves, g)
    torch.cuda.synchronize()
    assert (cx.launches, cx.backward_launches) == (before[0] + 1, before[1] + 1)
    for gk, wk in zip(grads, cx.cheap_xattn_backward_reference(a, b, g)):
        assert _xattn_close(gk, wk, 1e-5, 1e-4)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take():
    dev = _cuda()
    x, w, b, g = _inputs(CASES[0], dev)
    with pytest.raises(TypeError):
        sb.stream_block(x.double(), w, b)
    with pytest.raises(ValueError):
        sb.stream_block(x.transpose(1, 2).contiguous().transpose(1, 2), w, b)
    with pytest.raises(ValueError):
        sb.stream_block(x, w.cpu(), b)
    with pytest.raises(ValueError):
        sb.stream_block_backward(x, w, b, g[:, :4])
    with pytest.raises(TypeError):
        cs.cagrad_solve(torch.eye(3, device=dev, dtype=torch.float64), 0.5)
    with pytest.raises(ValueError):
        cs.cagrad_solve(torch.eye(9, device=dev), 0.5)
    a, b, g = _xattn_inputs((2, 8, 8, 65), dev)  # d > 64 is taken, not refused
    assert (cx.cheap_xattn(a, b) - cx.cheap_xattn_reference(a, b)).abs().max().item() <= 1e-5
    for gk, wk in zip(cx.cheap_xattn_backward(a, b, g), cx.cheap_xattn_backward_reference(a, b, g)):
        assert _xattn_close(gk, wk, 1e-5, 1e-4)
    a, b, g = _xattn_inputs((2, 8, 8, 12), dev)
    with pytest.raises(RuntimeError, match="launch failed"):
        cx._forward_kernel(a, b, cx.SWEEP_128)  # the sweep over 128 keys is backward only
    with pytest.raises(TypeError):
        cx.cheap_xattn(a.double(), b.double())
    with pytest.raises(ValueError):
        cx.cheap_xattn(a.transpose(1, 2).contiguous().transpose(1, 2), b)


# the MGDA, FairGrad and NashMTL solvers: seeded Gram matrices at every K
# the kernel takes, and the degenerate ones (zero, rank one with tasks of
# one sign, identical tasks, one zero task); NashMTL's normalised as its
# caller does. The kernel runs the plain version's IEEE operations in its
# order: w bitwise equal, in one launch and one matrix a launch, and for
# NEWTON_BATCH matrices in one launch (a grid that 4 warps a block does not
# divide); each solver's one-thread design, by name, too. MGDA's kernel ends
# a solve at its bitwise fixed point: a batch of NEWTON_BATCH that mixes
# solves that stop early with solves that run all 250 steps, in one launch.
NEWTON_BATCH = 257


def _solver_grams(rng, n, k):
    a = rng.normal(size=(n, k, 6)) * rng.uniform(0.1, 10.0, size=(n, 1, 1))
    grams = a @ a.transpose(0, 2, 1) + 1e-4 * np.eye(k)
    v = np.abs(rng.normal(size=k)) + 0.1
    z = grams[0].copy()
    z[0, :] = z[:, 0] = 0.0
    degenerate = [np.zeros((k, k)), np.outer(v, v), np.full((k, k), 2.0), z]
    return np.concatenate([grams, np.stack(degenerate)]).astype(np.float32)


def _correlated_grams(rng, n, k):
    """Task gradients around one shared direction at scales two decades
    apart: MGDA's Frank-Wolfe mostly reaches its fixed point by step 3."""
    base = rng.normal(size=(n, 1, 6))
    a = (base + 0.3 * rng.normal(size=(n, k, 6))) * 10.0 ** rng.uniform(-1, 1, size=(n, k, 1))
    return (a @ a.transpose(0, 2, 1)).astype(np.float32)


def _bitwise(got, want):
    return torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["min_norm", "fairgrad_0.5", "fairgrad_1", "fairgrad_2",
                                    "nashmtl"])
@pytest.mark.parametrize("k", range(1, 9))
def test_mtl_solver_matches_plain_on_card(solver, k):
    from gaitpd_torch.ops import mtl_solvers as ms

    dev = _cuda()
    rng = np.random.default_rng(k)
    grams = torch.from_numpy(_solver_grams(rng, 12, k)).to(dev)
    batch = torch.from_numpy(_solver_grams(rng, NEWTON_BATCH - 4, k)).to(dev)
    alpha = []
    if solver == "nashmtl":
        def norm(g):
            return g / torch.linalg.matrix_norm(g).clamp(min=1e-8)[:, None, None]

        grams, batch = norm(grams), norm(batch)
        run, plain, counter = ms.nashmtl_solve, ms.nashmtl_solve_reference, "nashmtl_launches"
    elif solver == "min_norm":
        run, plain, counter = ms.min_norm_solve, ms.min_norm_solve_reference, "min_norm_launches"
    else:
        alpha = [float(solver.split("_")[1])]
        counter = "fairgrad_launches"

        def run(g):
            return ms.fairgrad_solve(g, *alpha)

        def plain(g):
            return ms.fairgrad_solve_reference(g, *alpha)

    before = getattr(ms, counter)
    got = run(grams)
    got_batch = run(batch)
    torch.cuda.synchronize()
    assert getattr(ms, counter) == before + 2
    want, want_batch = plain(grams), plain(batch)
    assert torch.isfinite(got).all() and torch.isfinite(got_batch).all()
    assert _bitwise(got, want)
    assert _bitwise(got_batch, want_batch)
    for g, w in zip(grams, want):
        assert torch.equal(run(g), w)
    if solver == "min_norm":
        assert (got >= 0).all() and ((got.sum(-1) - 1).abs() <= 1e-5).all()
    name = counter.replace("_launches", "_solver")
    before = getattr(ms, counter)
    for g, w in ((grams, want), (batch, want_batch)):
        for variant in ms.designs(name):  # MGDA's thread, then the default
            assert _bitwise(ms._solve_kernel(name, g, *alpha, variant=variant), w)
    assert getattr(ms, counter) == before  # the designs by name count nothing
    if solver == "min_norm":
        from gaitpd_torch.learning.minnorm import min_norm_element_stop

        half = NEWTON_BATCH // 2
        mixed = np.concatenate([_solver_grams(rng, half, k)[:half],
                                _correlated_grams(rng, NEWTON_BATCH - half, k)])
        mixed = torch.from_numpy(mixed).to(dev)
        stops = min_norm_element_stop(mixed)[1]
        if k > 1:  # at K = 1 every solve stops at the first compare
            assert (stops < ms.MIN_NORM_STEPS).any() and (stops == ms.MIN_NORM_STEPS).any()
        want_mixed = plain(mixed)
        before = (ms.min_norm_launches, ms.fairgrad_launches, ms.nashmtl_launches)
        assert _bitwise(run(mixed), want_mixed)
        after = (ms.min_norm_launches, ms.fairgrad_launches, ms.nashmtl_launches)
        assert after == (before[0] + 1, before[1], before[2])
        for variant in ms.MIN_NORM_VARIANTS:
            assert _bitwise(ms._solve_kernel(name, mixed, variant=variant), want_mixed)
        assert ms.min_norm_launches == after[0]


# The fold-stacked launches (stream_block_folds, cross-validation's stacked
# step): one shape a forward variant, each fold's inputs from a seed of its
# own: warp_tile (the flagship's 3 x 64 windows; the generic backward),
# wide both ways (--enc_out_ch 96), per_frame (T 101; the generic backward)
# and the generic forward (a window too long for per_frame, whose generic
# backward still fits a block)
FOLD_CASES = [
    (3 * 64, 64, 12, 3, 16, 8, "relu"),
    (64, 64, 96, 3, 16, 8, "gelu"),
    (2 * 16, 101, 6, 3, 16, 8, "relu"),
    (2, 4000, 8, 3, 4, 8, "relu"),
    # FBG's backbone (C_in 3) and FOCAL's 2-mod one (32 -> 4 channels, 4
    # bins; ReLU on its path, GELU beside it) on the stacked FBG/FoG folds
    (2 * 16, 101, 3, 3, 16, 8, "relu"),
    (2 * 16, 101, 32, 3, 4, 4, "relu"),
    (2 * 16, 101, 32, 3, 4, 4, "gelu"),
]
FOLD_VARIANTS = {FOLD_CASES[0]: ("warp_tile", "generic"), FOLD_CASES[1]: ("wide", "wide"),
                 FOLD_CASES[2]: ("per_frame", "generic"), FOLD_CASES[3]: ("generic", "generic"),
                 FOLD_CASES[4]: ("per_frame", "generic"), FOLD_CASES[5]: ("per_frame", "generic"),
                 FOLD_CASES[6]: ("per_frame", "generic")}


def _fold_inputs(case, folds, dev):
    """x (F·B, T, C_in), w (F, K, C_in, C_out), b (F, C_out), g (F·B, t_out,
    C_out): fold f's from _numpy_inputs(case, seed=f)."""
    parts = [_numpy_inputs(case, seed=f) for f in range(folds)]
    join = (np.concatenate, np.stack, np.stack, np.concatenate)
    return [torch.from_numpy(j([p[i] for p in parts])).to(dev) for i, j in enumerate(join)]


@pytest.mark.gpu
@pytest.mark.parametrize("folds", [1, 2, 3, 10])
@pytest.mark.parametrize("case", FOLD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_fold_stacked_kernels_on_card(case, folds):
    """One launch each way for all folds. Each fold's forward and gradients
    have the bits of a launch of that fold alone, and are within the
    tolerances above of the plain version (stream_block_reference over each
    fold, the ReLU kinks of each fold's inputs left out as above); the
    launches' configs are the single fold's, with F times its blocks."""
    dev = _cuda()
    bsz, t, cin, k, cout, t_out, act = case
    x, w, b, g = _fold_inputs(case, folds, dev)
    counts = lambda: (sb.launches, sb.fold_launches, sb.backward_launches,  # noqa: E731
                      sb.fold_backward_launches)
    before = counts()
    got = sb.stream_block_folds(x, w, b, t_out, act)
    grads = sb.stream_block_folds_backward(x, w, b, g, t_out, act)
    torch.cuda.synchronize()
    assert counts() == tuple(c + 1 for c in before)
    assert grads[1].shape == w.shape and grads[2].shape == b.shape
    want = sb.stream_block_folds_reference(x, w, b, t_out, act)
    assert (got - want).abs().max().item() <= 1e-5
    for f in range(folds):
        rows = slice(f * bsz, (f + 1) * bsz)
        assert torch.equal(got[rows], sb.stream_block(x[rows], w[f], b[f], t_out, act))
        single = sb.stream_block_backward(x[rows], w[f], b[f], g[rows], t_out, act)
        for a, c in zip((grads[0][rows], grads[1][f], grads[2][f]), single):
            assert torch.equal(a, c)
        plain = sb.stream_block_backward_reference(x[rows], w[f], b[f], g[rows], t_out, act)
        _backward_close(single, plain, _relu_kinks(case, seed=f))
    config = sb.forward_config(bsz, t, cin, cout, k, t_out, act, folds=folds)
    one = sb.forward_config(bsz, t, cin, cout, k, t_out, act)
    assert (config["variant"], sb.backward_config(bsz, t, cin, cout, k, t_out, act)["variant"]
            ) == FOLD_VARIANTS[case]
    assert {**config, "blocks": one["blocks"], "waves": one["waves"]} == one
    assert config["blocks"] == folds * one["blocks"]
    bwd = sb.backward_config(bsz, t, cin, cout, k, t_out, act, folds=folds)
    assert bwd["blocks"] == folds * sb.backward_config(bsz, t, cin, cout, k, t_out, act)["blocks"]


@pytest.mark.gpu
def test_fold_count_one_launches_what_a_single_fold_launches():
    """F = 1: the configs, and the bits, of the launch without folds."""
    dev = _cuda()
    for case in FOLD_CASES:
        bsz, t, cin, k, cout, t_out, act = case
        x, w, b, g = _inputs(case, dev)
        assert (sb.forward_config(bsz, t, cin, cout, k, t_out, act, folds=1)
                == sb.forward_config(bsz, t, cin, cout, k, t_out, act))
        assert (sb.backward_config(bsz, t, cin, cout, k, t_out, act, folds=1)
                == sb.backward_config(bsz, t, cin, cout, k, t_out, act))
        assert torch.equal(sb.stream_block_folds(x, w[None], b[None], t_out, act),
                           sb.stream_block(x, w, b, t_out, act))
        for a, c in zip(sb.stream_block_folds_backward(x, w[None], b[None], g, t_out, act),
                        sb.stream_block_backward(x, w, b, g, t_out, act)):
            assert torch.equal(a.reshape(c.shape), c)


@pytest.mark.gpu
def test_fold_stacked_kernels_refuse_a_mismatched_fold_count():
    dev = _cuda()
    x, w, b, g = _fold_inputs(FOLD_CASES[0], 3, dev)
    with pytest.raises(ValueError):
        sb.stream_block_folds(x[:-1], w, b)  # 3·B - 1 windows for 3 folds
    with pytest.raises(ValueError):
        sb.stream_block_folds(x, w, b[:2])
    with pytest.raises(ValueError):
        sb.stream_block_folds_backward(x, w, b, g[:-3])
    with pytest.raises(ValueError):
        sb.stream_block_folds(x, w[0], b[0])


@pytest.mark.gpu
def test_vmap_over_folds_is_one_launch_each_way_on_card():
    """stream_block under torch.func.vmap over fold-stacked weights (the
    stacked CV step): one fold-stacked forward launch, one backward launch
    through autograd outside the vmap, with stream_block_folds's bits; one
    launch under no_grad too."""
    dev = _cuda()
    case, folds = FOLD_CASES[0], 10
    bsz, t, cin, k, cout, t_out, act = case
    x, w, b, g = _fold_inputs(case, folds, dev)
    xs = x.reshape(folds, bsz, t, cin).requires_grad_()
    w.requires_grad_()
    b.requires_grad_()
    block = torch.func.vmap(lambda xf, wf, bf: sb.stream_block(xf, wf, bf, t_out, act))
    counts = lambda: (sb.launches, sb.fold_launches, sb.backward_launches,  # noqa: E731
                      sb.fold_backward_launches)
    before = counts()
    out = block(xs, w, b)
    grads = torch.autograd.grad(out, (xs, w, b), g.reshape(out.shape))
    torch.cuda.synchronize()
    assert counts() == tuple(c + 1 for c in before)
    with torch.no_grad():
        assert torch.equal(out, block(xs, w, b))
        want = sb.stream_block_folds(x, w, b, t_out, act)
        assert torch.equal(out.reshape(want.shape), want)
    wants = sb.stream_block_folds_backward(x, w.detach(), b.detach(), g, t_out, act)
    for a, c in zip(grads, wants):
        assert torch.equal(a.reshape(c.shape), c)


# The cross-attention under torch.func.vmap over folds (the stacked CV step):
# (N a fold, Tq, Tk, d) at each variant's shape on a path, a few problems a
# fold: the sweep with d 12 (the WearGait fusion's six pairs at 64 x 64), the
# sweep at another d, T 101 (sweep_long forward, sweep_128 backward: the
# FBG/FoG fusion) and d 96 (tiled both ways: --enc_out_ch 96)
XATTN_FOLD_CASES = {
    (6 * 8, 64, 64, 12): ("sweep_d12", "sweep_d12"),
    (6 * 4, 64, 64, 16): ("sweep", "sweep"),
    (2 * 8, 101, 101, 6): ("sweep_long", "sweep_128"),
    (6 * 4, 64, 64, 96): ("tiled", "tiled"),
}


def _xattn_fold_inputs(case, folds, dev):
    """a, b, g (F, N, T, d): fold f's from _xattn_inputs(case, seed=f)."""
    parts = [_xattn_inputs(case, dev, seed=f) for f in range(folds)]
    return [torch.stack([p[i] for p in parts]) for i in range(3)]


@pytest.mark.gpu
@pytest.mark.parametrize("folds", [1, 2, 3, 10])
@pytest.mark.parametrize("case", sorted(XATTN_FOLD_CASES), ids=lambda c: "-".join(map(str, c)))
def test_cheap_xattn_under_vmap_over_folds_on_card(case, folds):
    """One forward launch for all folds under the vmap, one backward launch
    through autograd outside it, one forward launch under no_grad; each
    fold's output and gradients have the bits of a launch of that fold
    alone and are within the tolerances above of the plain version."""
    dev = _cuda()
    n, tq, tk, d = case
    assert tuple(cx.VARIANT_NAMES[cx._variant(tq, tk, d, bw)] for bw in (False, True)) == (
        XATTN_FOLD_CASES[case])
    a, b, g = _xattn_fold_inputs(case, folds, dev)
    leaves = [t.clone().requires_grad_() for t in (a, b)]
    attend = torch.func.vmap(cx.cheap_xattn)
    before = (cx.launches, cx.backward_launches)
    out = attend(*leaves)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (cx.launches, cx.backward_launches) == (before[0] + 1, before[1] + 1)
    with torch.no_grad():
        before = cx.launches
        assert torch.equal(attend(a, b), out)
        assert cx.launches == before + 1
    for f in range(folds):
        assert torch.equal(out[f], cx.cheap_xattn(a[f], b[f]))
        single = cx.cheap_xattn_backward(a[f], b[f], g[f])
        assert torch.equal(grads[0][f], single[0]) and torch.equal(grads[1][f], single[1])
        want = cx.cheap_xattn_reference(a[f], b[f])
        if tk <= 64:
            assert (out[f] - want).abs().max().item() <= 1e-5
        else:
            assert _xattn_close(out[f], want, 2e-5, 2e-4)
        for gk, wk in zip(single, cx.cheap_xattn_backward_reference(a[f], b[f], g[f])):
            assert _xattn_close(gk, wk, 1e-5, 1e-4)


@pytest.mark.gpu
def test_cheap_xattn_vmap_expands_an_unbatched_argument_on_card():
    """in_dims None (keys shared by every fold): expanded, still one launch
    each way, each fold's rows those of its own launch."""
    dev = _cuda()
    case, folds = (6 * 8, 64, 64, 12), 3
    a, b, g = _xattn_fold_inputs(case, folds, dev)
    a_leaf, b_leaf = a.clone().requires_grad_(), b[0].clone().requires_grad_()
    before = (cx.launches, cx.backward_launches)
    out = torch.func.vmap(cx.cheap_xattn, in_dims=(0, None))(a_leaf, b_leaf)
    ga, gb = torch.autograd.grad(out, (a_leaf, b_leaf), g)
    torch.cuda.synchronize()
    assert (cx.launches, cx.backward_launches) == (before[0] + 1, before[1] + 1)
    singles = [cx.cheap_xattn_backward(a[f], b[0], g[f]) for f in range(folds)]
    for f in range(folds):
        assert torch.equal(out[f], cx.cheap_xattn(a[f], b[0]))
        assert torch.equal(ga[f], singles[f][0])
    torch.testing.assert_close(gb, sum(s[1] for s in singles), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_fold_draws_on_cuda_generators_equal_sequential_draws():
    """Every kind of draw of the step's sites from CUDA generators under the
    vmap: each active fold's the bits of its own sequential draws, its
    generator's state where the sequential draws leave it; the inactive
    fold's rows zero and its generator untouched."""
    dev = _cuda()
    seeds, active = (3, 4, 5), (True, False, True)
    gens = [torch.Generator(device=dev).manual_seed(s) for s in seeds]
    x = torch.zeros(len(seeds), 64, 12, device=dev)

    def sites(x, g):
        return (FD.rand(x.shape, g, device=x.device),
                FD.randn(x.shape, g, device=x.device, dtype=x.dtype),
                FD.randint(0, x.shape[-1], (x.shape[0],), g, device=x.device),
                FD.randint(0, 3, (), g, device=x.device))

    got = torch.func.vmap(lambda x, t: sites(x, FD.FoldDraws(gens, active, t)))(
        x, FD.fold_tokens(len(seeds), dev))
    for f, (seed, on) in enumerate(zip(seeds, active)):
        alone = torch.Generator(device=dev).manual_seed(seed)
        if on:
            assert all(torch.equal(g[f], w) for g, w in zip(got, sites(x[f], alone)))
        else:
            assert all(not g[f].any() for g in got)
        assert torch.equal(gens[f].get_state(), alone.get_state())



def _fold_solvers():
    """(name, solver on one fold's matrices, its launch counter, its fold
    counter, the input map): the four solvers of the stacked step."""
    from gaitpd_torch.ops import mtl_solvers as ms

    def nash(g):
        return g / torch.linalg.matrix_norm(g).clamp(min=1e-8)[..., None, None]

    return {
        "cagrad": (lambda g: cs.cagrad_solve(g, 0.5), (cs, "launches"), (cs, "fold_launches"),
                   lambda g: g),
        "min_norm": (ms.min_norm_solve, (ms, "min_norm_launches"),
                     (ms, "min_norm_fold_launches"), lambda g: g),
        "fairgrad": (lambda g: ms.fairgrad_solve(g, 1.0), (ms, "fairgrad_launches"),
                     (ms, "fairgrad_fold_launches"), lambda g: g),
        "nashmtl": (ms.nashmtl_solve, (ms, "nashmtl_launches"), (ms, "nashmtl_fold_launches"),
                    nash),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("folds", [1, 2, 3, 10])
@pytest.mark.parametrize("solver", ["cagrad", "min_norm", "fairgrad", "nashmtl"])
def test_solvers_under_vmap_over_folds_on_card(solver, folds, k):
    """Each solver under torch.func.vmap over the folds' (K, K) matrices at
    K = 3 (WearGait's stacked step) and K = 2 (FBG/FoG's) and over a batch
    of 5 a fold: one launch for every fold, counted once by the solver's
    counter and once by its fold counter; each fold's weights bitwise those
    of a launch of its own (MGDA's mix early and 250-step solves, so the
    folds' stops differ)."""
    dev = _cuda()
    run, counter, fold_counter, prep = _fold_solvers()[solver]
    rng = np.random.default_rng(folds)
    half = folds * 5 // 2
    raw = np.concatenate([_solver_grams(rng, half, k)[:half],
                          _correlated_grams(rng, folds * 5 - half, k)])
    grams = prep(torch.from_numpy(raw[rng.permutation(len(raw))]).to(dev)).reshape(folds, 5, k, k)
    for batch in (grams[:, 0], grams):
        before = (getattr(*counter), getattr(*fold_counter))
        got = torch.func.vmap(run)(batch)
        torch.cuda.synchronize()
        assert (getattr(*counter), getattr(*fold_counter)) == (before[0] + 1, before[1] + 1)
        assert got.shape == batch.shape[:-1]
        for f in range(folds):
            assert _bitwise(got[f], run(batch[f])), (solver, folds, f)
        assert torch.isfinite(got).all()


C_VALUES = (0.1, 0.5, 25.0)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("folds", [1, 4, 40])
def test_cagrad_solver_per_matrix_c_on_card(folds, k):
    """CAGrad's strength one value a matrix (an HP grid's instances): one
    launch, each matrix's w bitwise that of a scalar-c launch of its own
    and of the plain version with its c, directly and under
    torch.func.vmap with a batched c (counted once by the solver's counter,
    its fold counter and its per-matrix counter)."""
    dev = _cuda()
    rng = np.random.default_rng(100 * k + folds)
    grams = torch.from_numpy(_solver_grams(rng, folds, k)[:folds]).to(dev)
    cvals = [C_VALUES[f % 3] for f in range(folds)]
    c = torch.tensor(cvals, dtype=torch.float32, device=dev)
    counters = lambda: (cs.launches, cs.fold_launches, cs.per_matrix_launches)  # noqa: E731
    before = counters()
    direct = cs.cagrad_solve(grams, c)
    torch.cuda.synchronize()
    assert counters() == (before[0] + 1, before[1], before[2] + 1)
    before = counters()
    vmapped = torch.func.vmap(cs.cagrad_solve)(grams, c)
    torch.cuda.synchronize()
    assert counters() == (before[0] + 1, before[1] + 1, before[2] + 1)
    want = cs.cagrad_solve_reference(grams, c)
    assert _bitwise(direct, want) and _bitwise(vmapped, want)
    for f in range(folds):
        assert _bitwise(direct[f], cs.cagrad_solve(grams[f], cvals[f])), (folds, f)
    for cv in C_VALUES:  # one c for all: the scalar launch's bits
        assert _bitwise(cs.cagrad_solve(grams, torch.full_like(c, cv)), cs.cagrad_solve(grams, cv))
    with pytest.raises(TypeError):
        cs.cagrad_solve(grams, c.cpu())  # no host copy of c in a step


@pytest.mark.gpu
def test_fold_draws_randperm_on_cuda_generators():
    """PCGrad's draw under the vmap from CUDA generators: each active fold's
    permutation the bits of its own draw, its generator where that draw
    leaves it; the inactive fold's the identity, its generator untouched."""
    dev = _cuda()
    seeds, active = (3, 4, 5), (True, False, True)
    gens = [torch.Generator(device=dev).manual_seed(s) for s in seeds]
    got = torch.func.vmap(lambda t: FD.randperm(3, FD.FoldDraws(gens, active, t), device=dev))(
        FD.fold_tokens(len(seeds), dev))
    for f, (seed, on) in enumerate(zip(seeds, active)):
        alone = torch.Generator(device=dev).manual_seed(seed)
        want = torch.randperm(3, generator=alone, device=dev) if on else torch.arange(3, device=dev)
        assert torch.equal(got[f], want)
        assert torch.equal(gens[f].get_state(), alone.get_state())


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["dots", "nothing"])
def test_stream_block_gradients_under_remat_on_card(policy):
    """The shared backbone's three task passes (the CAGrad step's K = 3
    backward passes, each task's cotangent on its own third of the rows)
    under remat: gx, gw and gb the bits of the passes without remat; the
    forward kernel launched 1 + 3 times under "nothing", once under
    "dots"."""
    from gaitpd_torch.runtime.remat import rematerialise

    dev = _cuda()
    x, w, b, _ = _inputs((3 * 64, 64, 12, 3, 16, 8, "relu"), dev)
    x, w, b = (t.detach().requires_grad_() for t in (x, w, b))

    def forward(module, xs, generator, epoch):
        return sb.stream_block(xs[0], w, b, 8, "relu")

    grads = {}
    for name in ("none", policy):
        before = sb.launches
        out = rematerialise(forward, name)(None, (x,), None, 0)
        rows = []
        for task in range(3):
            loss = (out[64 * task:64 * (task + 1)] ** 2).sum()
            rows.append(torch.autograd.grad(loss, (x, w, b), retain_graph=task < 2))
        torch.cuda.synchronize()
        grads[name] = (rows, sb.launches - before)
    assert grads["none"][1] == 1
    assert grads[policy][1] == (4 if policy == "nothing" else 1)
    for got, want in zip(grads[policy][0], grads["none"][0]):
        assert all(torch.equal(g, h) for g, h in zip(got, want))
