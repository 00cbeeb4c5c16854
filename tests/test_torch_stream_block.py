"""gaitpd_torch.ops.stream_block against the Pallas stream block of
gaitpd.ops.pallas_blocks (interpret mode on the CPU, as tests/test_pallas.py
runs it) and its jnp reference, on the same numpy inputs.

On the CPU the wrapper takes its plain version; tests/test_torch_kernel_card.py
holds the CUDA kernels (forward and backward) against that plain version on
the card. Tolerance: see test_torch_pipeline; gradients within 1e-4
relative and 1e-5 absolute, as tests/test_pallas.py holds gaitpd's own
custom_vjp.

The backward kernel skips windows whose cotangent is all zero (and whose x
is finite): the zero-layout tests hold that premise against gaitpd's VJP.
Such windows get gx exactly 0 in both packages, and gw, gb equal the VJP of
the live windows alone (within the gradient tolerance: the sums run over
fewer terms).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaitpd.models.encoders import SharedBackbone as FlaxBackbone  # noqa: E402
from gaitpd.ops.pallas_blocks import make_stream_block  # noqa: E402
from gaitpd.ops.pallas_blocks import stream_block_reference as jax_reference  # noqa: E402
from gaitpd_torch.models.encoders import SharedBackbone  # noqa: E402
from gaitpd_torch.ops import _build  # noqa: E402
from gaitpd_torch.ops import stream_block as sb  # noqa: E402
from gaitpd_torch.params import load_flax_params  # noqa: E402
from gaitpd_torch.tools import stream_block_wide_parts as wide_parts  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)

# (B, T, C_in, K, C_out, t_out, act): tests/test_pallas.py's cases, the main
# path's shape at a small batch, T = 101 (uneven, overlapping bins), k = 1,
# t_out > T, and FOCAL's backbone (320 channels, GELU)
CASES = [
    (8, 64, 13, 3, 16, 8, "relu"),
    (8, 64, 13, 5, 16, 8, "gelu"),
    (6, 64, 12, 3, 16, 8, "relu"),
    (4, 101, 6, 3, 16, 8, "relu"),
    (3, 101, 13, 5, 16, 8, "gelu"),
    (5, 30, 4, 1, 7, 4, "relu"),
    (3, 5, 4, 3, 6, 8, "gelu"),  # t_out > T: bins repeat frames
    (3, 64, 320, 3, 16, 8, "gelu"),  # FOCAL's backbone: 128 + 3 * 64 channels
]


def _inputs(case, seed=0):
    bsz, t, cin, k, cout, _, _ = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bsz, t, cin)).astype(np.float32)
    w = (rng.normal(size=(k, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_matches_pallas_and_jnp(case):
    t_out, act = case[5], case[6]
    x, w, b = _inputs(case)
    got = sb.stream_block(*map(torch.from_numpy, (x, w, b)), t_out, act).numpy()
    assert got.shape == (case[0], t_out, case[4])
    pallas = np.asarray(make_stream_block(act, t_out)(*map(jnp.asarray, (x, w, b))))
    ref = np.asarray(jax_reference(*map(jnp.asarray, (x, w, b)), t_out=t_out, act_name=act))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


# the forward's variant by size (T, C_in, C_out, K, t_out): the warp_tile
# variant's compiled-in sizes (T 64, C_out 16, K 3, t_out 8, C_in 12, 16 or
# 36) against one size off each; the wide variant's (the same T, C_out, K,
# t_out, taken from C_in WIDE_MIN_CIN = 17) at its threshold, one below it
# (16 is warp_tile's, so 15), 24, 63, 64, FOCAL's 320 and 1024, against a
# wide C_in at T 101 or K 5 (per_frame); the
# FBG/FoG backbones at T 101 (C_in 3, 6, 12, 16, and FOCAL's 32 -> 4 channels
# in 4 bins; C_out 3); per_frame's shared-memory edge, one frame beyond which
# the first design (generic) takes the window;
# tests/test_torch_kernel_card.py runs the same sizes on the card
FORWARD_VARIANT_EDGES = {
    (64, 12, 16, 3, 8): sb.WARP_TILE,
    (64, 16, 16, 3, 8): sb.WARP_TILE,
    (64, 36, 16, 3, 8): sb.WARP_TILE,
    (64, 13, 16, 3, 8): sb.PER_FRAME,
    (64, 15, 16, 3, 8): sb.PER_FRAME,  # one below the threshold
    (64, 17, 16, 3, 8): sb.WIDE,  # the threshold, WIDE_MIN_CIN
    (64, 24, 16, 3, 8): sb.WIDE,
    (101, 12, 16, 3, 8): sb.PER_FRAME,
    (63, 12, 16, 3, 8): sb.PER_FRAME,
    (64, 12, 16, 1, 8): sb.PER_FRAME,
    (64, 12, 16, 5, 8): sb.PER_FRAME,
    (64, 12, 16, 3, 7): sb.PER_FRAME,
    (64, 12, 8, 3, 8): sb.PER_FRAME,
    (64, 320, 16, 3, 8): sb.WIDE,  # FOCAL's backbone
    (64, 64, 16, 3, 8): sb.WIDE,
    (64, 63, 16, 3, 8): sb.WIDE,
    (64, 1024, 16, 3, 8): sb.WIDE,  # beyond what the generic kernels take
    (101, 320, 16, 3, 8): sb.PER_FRAME,
    (64, 320, 16, 5, 8): sb.PER_FRAME,
    (101, 3, 16, 3, 8): sb.PER_FRAME,  # FBG
    (101, 6, 16, 3, 8): sb.PER_FRAME,  # FoG
    (101, 16, 16, 3, 8): sb.PER_FRAME,  # the shared latent
    (101, 32, 4, 3, 4): sb.PER_FRAME,  # FOCAL's 2-modality backbone
    (101, 6, 3, 3, 8): sb.PER_FRAME,
    (7261, 1, 1, 1, 8): sb.PER_FRAME,  # 232,432 of 232,448 bytes
    (7262, 1, 1, 1, 8): sb.GENERIC,
}


@pytest.mark.parametrize("act", ["relu", "gelu"])
@pytest.mark.parametrize("sizes", FORWARD_VARIANT_EDGES, ids=lambda s: "-".join(map(str, s)))
def test_forward_variant_at_the_edges(sizes, act):
    """The variant follows the sizes alone, whatever the activation, and the
    plain version at those sizes is gaitpd's jnp reference."""
    assert sb._variant(*sizes) == FORWARD_VARIANT_EDGES[sizes]
    t, cin, cout, k, t_out = sizes
    x, w, b = _inputs((3, t, cin, k, cout, t_out, act))
    got = sb.stream_block(*map(torch.from_numpy, (x, w, b)), t_out, act).numpy()
    ref = np.asarray(jax_reference(*map(jnp.asarray, (x, w, b)), t_out=t_out, act_name=act))
    np.testing.assert_allclose(got, ref, **TOL)


# the backward's variant by the same sizes: the wide variant at the wide
# forward's sizes and at warp_tile's C_in 36 (from WIDE_MIN_CIN = 17), the
# generic kernel (zero-cotangent windows skipped) for every other, warp_tile's
# C_in 12 and 16 included
BACKWARD_VARIANT_EDGES = {
    (64, 12, 16, 3, 8): sb.BWD_GENERIC,
    (64, 16, 16, 3, 8): sb.BWD_GENERIC,  # one below the threshold
    (64, 17, 16, 3, 8): sb.BWD_WIDE,  # the threshold, WIDE_MIN_CIN
    (64, 36, 16, 3, 8): sb.BWD_WIDE,
    (64, 63, 16, 3, 8): sb.BWD_WIDE,
    (64, 64, 16, 3, 8): sb.BWD_WIDE,
    (64, 320, 16, 3, 8): sb.BWD_WIDE,  # FOCAL's backbone
    (64, 330, 16, 3, 8): sb.BWD_WIDE,
    (64, 1024, 16, 3, 8): sb.BWD_WIDE,
    (101, 320, 16, 3, 8): sb.BWD_GENERIC,
    (64, 320, 16, 5, 8): sb.BWD_GENERIC,
    (64, 320, 8, 3, 8): sb.BWD_GENERIC,
    (64, 320, 16, 3, 7): sb.BWD_GENERIC,
}


@pytest.mark.parametrize("act", ["relu", "gelu"])
@pytest.mark.parametrize("sizes", BACKWARD_VARIANT_EDGES, ids=lambda s: "-".join(map(str, s)))
def test_backward_variant_at_the_edges(sizes, act):
    """The backward's variant follows the sizes alone, and the plain backward
    at those sizes is gaitpd's custom_vjp."""
    assert sb._backward_variant(*sizes) == BACKWARD_VARIANT_EDGES[sizes]
    assert sb.BACKWARD_VARIANT_NAMES[BACKWARD_VARIANT_EDGES[sizes]] in ("generic", "wide")
    t, cin, cout, k, t_out = sizes
    x, w, b = _inputs((2, t, cin, k, cout, t_out, act), seed=7)
    g = np.random.default_rng(8).normal(size=(2, t_out, cout)).astype(np.float32)
    got = sb.stream_block_backward(*map(torch.from_numpy, (x, w, b, g)), t_out, act)
    for name, c, r in zip("xwb", got, _vjp_jax(x, w, b, g, t_out, act)):
        np.testing.assert_allclose(c.numpy(), r, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("name", sorted(wide_parts.VARIANTS))
def test_wide_parts_cuts_match_the_source(name):
    """Each build of the wide kernels' parts tool finds every text it cuts
    exactly once in csrc/stream_block.cu, and changes the source (all but
    the full build)."""
    source = (_build.CSRC / "stream_block.cu").read_text()
    assert (wide_parts.cut(name, source) == source) == (name == "full")


def test_cpu_path_counts_no_launch():
    x, w, b = _inputs(CASES[0])
    before = sb.launches
    sb.stream_block(*map(torch.from_numpy, (x, w, b)))
    assert sb.launches == before


@pytest.mark.parametrize("t", [64, 101])
def test_shared_backbone_matches_flax(t):
    rng = np.random.default_rng(t)
    x = rng.normal(size=(4, t, 12)).astype(np.float32)
    fm = FlaxBackbone(16, 8)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.normal(size=a.shape) * 0.1).astype(np.float32),
        fm.init(jax.random.PRNGKey(0), jnp.asarray(x)),
    )
    tm = load_flax_params(SharedBackbone(12, 16, 8, generator=torch.Generator()), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(fm.apply(v, jnp.asarray(x))), **TOL)


# (B, T, C_in, K, C_out, t_out, act): tests/test_pallas.py:45-53's case, then
# T = 101 (overlapping bins), k5 GELU, k1 and FOCAL's 320 channels with GELU
GRAD_CASES = [
    (4, 32, 6, 3, 8, 4, "relu"),
    (4, 101, 12, 3, 16, 8, "relu"),
    (3, 64, 13, 5, 16, 8, "gelu"),
    (5, 30, 4, 1, 7, 4, "relu"),
    (3, 64, 320, 3, 16, 8, "gelu"),  # FOCAL's backbone
]


@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_gradients_match_custom_vjp(case):
    """The plain path's autograd against make_stream_block's custom_vjp
    (Pallas forward in interpret mode, jnp-derived backward), for the
    cotangent of sum(out ** 2) as in tests/test_pallas.py, and the CPU
    wrapper stream_block_backward against both."""
    t_out, act = case[5], case[6]
    x, w, b = _inputs(case, seed=3)
    op = make_stream_block(act, t_out)
    ref = jax.grad(lambda *a: jnp.sum(op(*a) ** 2), argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, w, b)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    out = sb.stream_block(*leaves, t_out, act)
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    before = sb.backward_launches
    wrapped = sb.stream_block_backward(*(t.detach() for t in leaves), 2 * out.detach(), t_out, act)
    assert sb.backward_launches == before  # the CPU path launches nothing
    for name, g, c, r in zip("xwb", got, wrapped, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(c.numpy(), g.numpy(), rtol=1e-6, atol=1e-6, err_msg=name)


def test_backward_rejects_a_cotangent_of_another_shape():
    x, w, b = map(torch.from_numpy, _inputs(CASES[0]))
    with pytest.raises(ValueError, match="cotangent"):
        sb.stream_block_backward(x, w, b, torch.zeros(8, 4, 16))


@pytest.mark.parametrize("bad", ["even_k", "act", "cin", "bias", "t_out"])
def test_wrapper_rejects_bad_arguments(bad):
    x, w, b = map(torch.from_numpy, _inputs(CASES[0]))
    t_out, act = 8, "relu"
    if bad == "even_k":
        w = torch.zeros(2, 13, 16)
    elif bad == "act":
        act = "tanh"
    elif bad == "cin":
        w = torch.zeros(3, 12, 16)
    elif bad == "bias":
        b = torch.zeros(15)
    else:
        t_out = 0
    with pytest.raises(ValueError):
        sb.stream_block(x, w, b, t_out, act)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No silent fallback: a kernel that cannot be built raises."""
    from gaitpd_torch.ops import _build

    assert "stream_block" in _build.sources()
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("stream_block")


# rows of g set to zero in a batch of 3 * 4 windows (the three streams of
# 4 window tuples): the CAGrad task passes' thirds, a range that starts and
# ends inside a block's 8 windows, and all of them
ZERO_LAYOUTS = {
    "walkway_task": np.r_[4:12],
    "insole_task": np.r_[0:4, 8:12],
    "unaligned": np.r_[3:10],
    "all_zero": np.r_[0:12],
}


def _vjp_jax(x, w, b, g, t_out, act):
    _, vjp = jax.vjp(make_stream_block(act, t_out), *map(jnp.asarray, (x, w, b)))
    return [np.asarray(v) for v in vjp(jnp.asarray(g))]


def _zero_layout_inputs(zero, seed=5):
    x, w, b = _inputs((12, 64, 12, 3, 16, 8, "relu"), seed=seed)
    g = np.random.default_rng(seed + 1).normal(size=(12, 8, 16)).astype(np.float32)
    g[zero] = 0.0
    return x, w, b, g


@pytest.mark.parametrize("layout", sorted(ZERO_LAYOUTS))
def test_zero_cotangent_windows_add_nothing(layout):
    zero = ZERO_LAYOUTS[layout]
    live = np.setdiff1d(np.arange(12), zero)
    x, w, b, g = _zero_layout_inputs(zero)
    got = [t.numpy() for t in sb.stream_block_backward(*map(torch.from_numpy, (x, w, b, g)))]
    ref = _vjp_jax(x, w, b, g, 8, "relu")
    for name, c, r in zip("xwb", got, ref):
        np.testing.assert_allclose(c, r, rtol=1e-4, atol=1e-5, err_msg=name)
    assert not got[0][zero].any() and not ref[0][zero].any()  # gx exactly 0
    if live.size:
        only_live = _vjp_jax(x[live], w, b, g[live], 8, "relu")
    else:
        only_live = [None, np.zeros_like(w), np.zeros_like(b)]
    for name, c, r in zip("wb", got[1:], only_live[1:]):
        np.testing.assert_allclose(c, r, rtol=1e-4, atol=1e-5, err_msg=name)
    if not live.size:
        assert not got[1].any() and not got[2].any()


def test_nan_in_a_zero_cotangent_window_makes_gw_nan():
    """A non-finite x keeps its window live: 0 * NaN is NaN in gw, in both
    packages, at the same entries; gb and gx stay finite (ReLU)."""
    zero = ZERO_LAYOUTS["walkway_task"]
    x, w, b, g = _zero_layout_inputs(zero)
    x[6, 20, 5] = np.nan
    got = [t.numpy() for t in sb.stream_block_backward(*map(torch.from_numpy, (x, w, b, g)))]
    ref = _vjp_jax(x, w, b, g, 8, "relu")
    assert np.isnan(got[1]).any()
    for name, c, r in zip("xwb", got, ref):
        np.testing.assert_array_equal(np.isnan(c), np.isnan(r), err_msg=name)
        ok = ~np.isnan(r)
        np.testing.assert_allclose(c[ok], r[ok], rtol=1e-4, atol=1e-5, err_msg=name)
    assert np.isnan(got[1][:, 5, :]).all() and not np.isnan(np.delete(got[1], 5, axis=1)).any()
    assert np.isfinite(got[0]).all() and np.isfinite(got[2]).all()


# the fold-stacked block (cross-validation's stacked step): F folds, each
# with its own windows and weights
FOLD_CASES = [(3, (6, 64, 12, 3, 16, 8, "relu")), (2, (4, 101, 6, 3, 16, 8, "gelu"))]


def _fold_inputs(folds, case):
    parts = [_inputs(case, seed=f) for f in range(folds)]
    return (torch.from_numpy(np.concatenate([p[0] for p in parts])),
            torch.from_numpy(np.stack([p[1] for p in parts])),
            torch.from_numpy(np.stack([p[2] for p in parts])))


@pytest.mark.parametrize("folds,case", FOLD_CASES, ids=lambda c: "-".join(map(str, c))
                         if isinstance(c, tuple) else str(c))
def test_fold_stacked_plain_version_is_each_folds(folds, case):
    """stream_block_folds on the CPU: fold f's rows are
    stream_block_reference at w[f], b[f] (the same bits) and within TOL of
    gaitpd's jnp reference; its gradients, and stream_block_folds_backward's,
    are each fold's own; torch.func.vmap of stream_block over the folds
    gives the same within TOL, its gradients through autograd outside the
    vmap too."""
    bsz, t_out, act = case[0], case[5], case[6]
    x, w, b = (v.requires_grad_() for v in _fold_inputs(folds, case))
    out = sb.stream_block_folds(x, w, b, t_out, act)
    g = torch.from_numpy(np.random.default_rng(9).normal(size=out.shape).astype(np.float32))
    grads = torch.autograd.grad(out, (x, w, b), g)
    folded = sb.stream_block_folds_backward(x.detach(), w.detach(), b.detach(), g, t_out, act)
    xs = x.reshape(folds, bsz, *x.shape[1:])
    mapped = torch.func.vmap(lambda xf, wf, bf: sb.stream_block(xf, wf, bf, t_out, act))(xs, w, b)
    mapped_grads = torch.autograd.grad(mapped, (x, w, b), g.reshape(mapped.shape))
    for f in range(folds):
        rows = slice(f * bsz, (f + 1) * bsz)
        want = sb.stream_block_reference(x[rows], w[f], b[f], t_out, act)
        assert torch.equal(out[rows], want)
        jnp_out = jax_reference(jnp.asarray(x[rows].detach().numpy()),
                                jnp.asarray(w[f].detach().numpy()),
                                jnp.asarray(b[f].detach().numpy()), t_out, act)
        np.testing.assert_allclose(out[rows].detach().numpy(), np.asarray(jnp_out), **TOL)
        torch.testing.assert_close(mapped[f], want, **TOL)
        wants = sb.stream_block_backward_reference(x[rows], w[f], b[f], g[rows], t_out, act)
        for got in (grads, folded, mapped_grads):
            for a, c in zip((got[0][rows], got[1][f], got[2][f]), wants):
                torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)


def test_fold_stacked_block_rejects_a_mismatched_fold_count():
    x, w, b = _fold_inputs(3, FOLD_CASES[0][1])
    for bad in ((x[:-1], w, b), (x, w, b[:2]), (x, w[0], b[0])):
        with pytest.raises(ValueError):
            sb.stream_block_folds(*bad)
    g = torch.zeros((x.shape[0] - 3, 8, 16))
    with pytest.raises(ValueError):
        sb.stream_block_folds_backward(x, w, b, g)
