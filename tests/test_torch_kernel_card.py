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
result, with NaN at the same entries. The MGDA, FairGrad and NashMTL
solvers: w bitwise equal to the plain version's (the same IEEE operations
in the same order, the same device powf), finite, MGDA's on the simplex.
"""

import numpy as np
import pytest
import torch

from gaitpd_torch.ops import cagrad_solver as cs
from gaitpd_torch.ops import cheap_xattn as cx
from gaitpd_torch.ops import stream_block as sb
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


def _inputs(case, dev, seed=0):
    bsz, t, cin, k, cout, t_out, _ = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bsz, t, cin)).astype(np.float32)
    w = (rng.normal(size=(k, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(bsz, t_out, cout)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (x, w, b, g)]


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
# against one size off each (the generic variant)
FORWARD_EDGE_CASES = [
    (4 * 5 + 3, 64, 12, 3, 16, 8, "gelu"), (4 * 5 + 1, 64, 16, 3, 16, 8, "gelu"),
    (4 * 5 + 2, 64, 36, 3, 16, 8, "gelu"), (9, 64, 13, 3, 16, 8, "relu"),
    (9, 64, 24, 3, 16, 8, "gelu"), (9, 101, 12, 3, 16, 8, "relu"),
    (9, 63, 12, 3, 16, 8, "relu"), (9, 64, 12, 1, 16, 8, "gelu"),
    (9, 64, 12, 5, 16, 8, "relu"), (9, 64, 12, 3, 16, 7, "relu"),
    (9, 64, 12, 3, 8, 8, "gelu"), (1, 64, 12, 3, 16, 8, "relu"),
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
    and a grid that covers the windows."""
    _cuda()
    bsz, t, cin, k, cout, t_out, act = case
    config = sb.forward_config(bsz, t, cin, cout, k, t_out, act)
    assert config["variant"] == sb.VARIANT_NAMES[sb._variant(t, cin, cout, k, t_out)]
    assert config["threads"] > 0 and config["blocks_per_sm"] >= 1
    windows = 4  # a block's windows, in either variant at these sizes
    assert config["blocks"] == -(-bsz // windows)


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
# stream_block's wrapper picks them from WIDE_MIN_CIN = 64: below it, where
# the generic kernels run, and at C_in 13 (4-byte copies, one part-filled
# chunk)
BELOW_WIDE_CASES = [(37, 64, 13, 3, 16, 8, "gelu"), (3 * 64, 64, 48, 3, 16, 8, "relu")]


@pytest.mark.gpu
@pytest.mark.parametrize("case", BELOW_WIDE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_wide_kernels_below_their_threshold_on_card(case):
    """The wide variants, asked for by name below WIDE_MIN_CIN, within the
    same tolerances of the plain versions, two launches the same bits."""
    dev = _cuda()
    bsz, t, cin, k, cout, t_out, act = case
    x, w, b, g = _inputs(case, dev)
    assert sb._variant(t, cin, cout, k, t_out) == sb.GENERIC
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
    dev = _cuda()
    x, w, b, g = _inputs(case, dev)
    before = sb.backward_launches
    got = sb.stream_block_backward(x, w, b, g, case[5], case[6])
    again = sb.stream_block_backward(x, w, b, g, case[5], case[6])
    torch.cuda.synchronize()
    assert sb.backward_launches == before + 2
    want = sb.stream_block_backward_reference(x, w, b, g, case[5], case[6])
    assert (got[0] - want[0]).abs().max().item() <= 1e-5
    for gk, wk in zip(got[1:], want[1:]):
        tol = 1e-5 * max(1.0, wk.abs().max().item())
        assert (gk - wk).abs().max().item() <= tol
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


def _backward_close(got, want):
    """gx within 1e-5; gw, gb within 1e-5 of their largest value; NaN at the
    same entries."""
    for i, (gk, wk) in enumerate(zip(got, want)):
        assert torch.equal(torch.isnan(gk), torch.isnan(wk))
        ok = ~torch.isnan(wk)
        if not ok.any():
            continue
        tol = 1e-5 if i == 0 else 1e-5 * max(1.0, wk[ok].abs().max().item())
        assert (gk[ok] - wk[ok]).abs().max().item() <= tol


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
    _backward_close(got, want)
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
# wider d (rows in device memory), odd and a multiple of 4, and the FBG/FoG
# cross-attention fusion's two directions at T 101 (two passes): FoG's d = 6
# at batch 256, FBG's d = 3 at batch 32
XATTN_CASES = [
    (6 * 64, 64, 64, 12), (6 * 33 + 1, 64, 64, 12), (2, 101, 426, 12), (2, 200, 100, 12),
    (2, 32, 48, 8), (2 * 64, 101, 101, 12), (5, 1, 64, 12), (5, 64, 1, 12),
    (3, 37, 53, 6), (2, 130, 257, 64), (2, 8, 8, 65), (3, 37, 70, 96), (2, 20, 130, 200),
    (2 * 256, 101, 101, 6), (2 * 32, 101, 101, 3),
]
# each variant's edges (tests/test_torch_cheap_xattn.py holds the choice): the
# sweep kernels at Tk = 64 and Tk = 65 (two passes), Tq = 64 and 65 (the
# backward's two passes; the forward's second 64-row unit), masked scores
# (Tk = 63), d = 12 (the compile-time width) against 8, 16, 36 and 64 (the
# general widths), N odd (a block's second unit idle in the last round) and N
# above one round of the persistent grid, at the main shape plus one problem
XATTN_EDGE_CASES = [
    (7, 64, 64, 12), (7, 64, 65, 12), (7, 65, 64, 12), (7, 65, 65, 12), (5, 64, 63, 12),
    (5, 64, 64, 8), (5, 64, 64, 16), (5, 64, 64, 36), (3, 33, 47, 36), (5, 64, 64, 64),
    (3, 130, 20, 12), (6 * 1024 + 1, 64, 64, 12),
]


def _xattn_inputs(case, dev, seed=0):
    n, tq, tk, d = case
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
            for s in ((n, tq, d), (n, tk, d), (n, tq, d))]


def _xattn_close(got, want, atol, rtol):
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", XATTN_CASES + XATTN_EDGE_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cheap_xattn_kernels_match_plain_on_card(case):
    dev = _cuda()
    a, b, g = _xattn_inputs(case, dev)
    before = (cx.launches, cx.backward_launches)
    got = cx.cheap_xattn(a, b)
    grads = cx.cheap_xattn_backward(a, b, g)
    again = cx.cheap_xattn_backward(a, b, g)
    torch.cuda.synchronize()
    assert (cx.launches, cx.backward_launches) == (before[0] + 1, before[1] + 2)
    want = cx.cheap_xattn_reference(a, b)
    if case[2] <= 64:
        assert (got - want).abs().max().item() <= 1e-5
    else:
        assert _xattn_close(got, want, 2e-5, 2e-4)
    for gk, wk, ak in zip(grads, cx.cheap_xattn_backward_reference(a, b, g), again):
        assert _xattn_close(gk, wk, 1e-5, 1e-4)
        assert torch.equal(gk, ak)  # deterministic: the same bits twice


@pytest.mark.gpu
@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("case", XATTN_EDGE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cheap_xattn_launch_config_on_card(case, backward):
    """The launch of the variant the sizes take: the card holds at least one
    block an SM, and the sweep forward's persistent grid is no larger than
    the card holds at once nor than its units of 64 query rows."""
    _cuda()
    n, tq, tk, d = case
    config = cx.launch_config(n, tq, tk, d, backward)
    assert config["variant"] == cx.VARIANT_NAMES[cx._variant(tq, tk, d, backward)]
    assert config["threads"] > 0 and config["blocks_per_sm"] >= 1
    if not backward and config["variant"].startswith("sweep"):
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        units = n * -(-tq // cx.SWEEP_T)
        assert 1 <= config["blocks"] <= min(units, config["blocks_per_sm"] * sms)


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
    with pytest.raises(TypeError):
        cx.cheap_xattn(a.double(), b.double())
    with pytest.raises(ValueError):
        cx.cheap_xattn(a.transpose(1, 2).contiguous().transpose(1, 2), b)


# the MGDA, FairGrad and NashMTL solvers: seeded Gram matrices at every K
# the kernel takes, and the degenerate ones (zero, rank one with tasks of
# one sign, identical tasks, one zero task); NashMTL's normalised as its
# caller does. The kernel runs the plain version's IEEE operations in its
# order: w bitwise equal, in one launch and one matrix a launch.
def _solver_grams(rng, n, k):
    a = rng.normal(size=(n, k, 6)) * rng.uniform(0.1, 10.0, size=(n, 1, 1))
    grams = a @ a.transpose(0, 2, 1) + 1e-4 * np.eye(k)
    v = np.abs(rng.normal(size=k)) + 0.1
    z = grams[0].copy()
    z[0, :] = z[:, 0] = 0.0
    degenerate = [np.zeros((k, k)), np.outer(v, v), np.full((k, k), 2.0), z]
    return np.concatenate([grams, np.stack(degenerate)]).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["min_norm", "fairgrad_0.5", "fairgrad_1", "fairgrad_2",
                                    "nashmtl"])
@pytest.mark.parametrize("k", range(1, 9))
def test_mtl_solver_matches_plain_on_card(solver, k):
    from gaitpd_torch.ops import mtl_solvers as ms

    dev = _cuda()
    grams = torch.from_numpy(_solver_grams(np.random.default_rng(k), 12, k)).to(dev)
    if solver == "nashmtl":
        norm = torch.linalg.matrix_norm(grams).clamp(min=1e-8)[:, None, None]
        grams = grams / norm
        run, plain, counter = ms.nashmtl_solve, ms.nashmtl_solve_reference, "nashmtl_launches"
    elif solver == "min_norm":
        run, plain, counter = ms.min_norm_solve, ms.min_norm_solve_reference, "min_norm_launches"
    else:
        alpha = float(solver.split("_")[1])
        counter = "fairgrad_launches"

        def run(g):
            return ms.fairgrad_solve(g, alpha)

        def plain(g):
            return ms.fairgrad_solve_reference(g, alpha)

    before = getattr(ms, counter)
    got = run(grams)
    torch.cuda.synchronize()
    assert getattr(ms, counter) == before + 1
    want = plain(grams)
    assert torch.isfinite(got).all()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    for g, w in zip(grams, want):
        assert torch.equal(run(g), w)
    if solver == "min_norm":
        assert (got >= 0).all() and ((got.sum(-1) - 1).abs() <= 1e-5).all()
