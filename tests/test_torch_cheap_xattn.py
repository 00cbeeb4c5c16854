"""gaitpd_torch.ops.cheap_xattn against the Pallas cross-attention of
gaitpd.ops.pallas_blocks (interpret mode on the CPU, as tests/test_pallas.py
runs it) and its jnp reference, on the same numpy inputs.

On the CPU the wrappers take their plain versions; tests/test_torch_kernel_card.py
holds the CUDA kernels (forward and backward) against them on the card.
Tolerances: against the jnp reference, forwards within 1e-5 and gradients
within 1e-5 absolute plus 1e-4 relative (f32 on both sides, only the order
of summation differs); against the Pallas kernel, gaitpd's own bound
(tests/test_pallas.py:62), since its online softmax over kv tiles rounds
otherwise.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaitpd.ops.attention import cheap_cross_attention as jax_reference  # noqa: E402
from gaitpd.ops.pallas_blocks import cheap_xattn_pallas  # noqa: E402
from gaitpd_torch.ops import cheap_xattn as cx  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
PALLAS_TOL = dict(rtol=2e-4, atol=2e-5)

# (N, Tq, Tk, d): tests/test_pallas.py:56-70's shapes, then one query row,
# one key row, the 2-mod family's widths at T 101 (FoG's d 6, FBG's d 3), and
# d beyond the kernels' register rows (--enc_out_ch above 64), also at a
# window of 128 frames (--win_len 128: two key tiles and two query tiles of
# the tiled kernels)
CASES = [(2, 64, 64, 12), (2, 101, 426, 12), (2, 200, 100, 12), (2, 32, 48, 8),
         (3, 1, 7, 12), (3, 9, 1, 12), (2, 101, 101, 6), (2, 101, 101, 3), (2, 17, 23, 65),
         (2, 40, 70, 96), (2, 128, 128, 96)]


def _inputs(case, seed=0):
    n, tq, tk, d = case
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, tq, d)).astype(np.float32)
    b = rng.normal(size=(n, tk, d)).astype(np.float32)
    g = rng.normal(size=(n, tq, d)).astype(np.float32)
    return a, b, g


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_matches_pallas_and_jnp(case):
    a, b, _ = _inputs(case)
    before = cx.launches
    got = cx.cheap_xattn(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert cx.launches == before  # the CPU path launches nothing
    assert got.shape == a.shape
    ref = np.asarray(jax_reference(jnp.asarray(a), jnp.asarray(b)))
    pallas = np.asarray(cheap_xattn_pallas(jnp.asarray(a), jnp.asarray(b), q_tile=64,
                                           kv_tile=64))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, pallas, **PALLAS_TOL)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_gradients_match_jax(case):
    """Autograd of the plain version against jax.grad through the Pallas
    op's custom_vjp and through the jnp reference, for the cotangent of
    sum(out * g); and the CPU wrapper cheap_xattn_backward against both."""
    a, b, g = _inputs(case, seed=1)
    ja, jb, jg = map(jnp.asarray, (a, b, g))
    via_pallas = jax.grad(lambda x, y: jnp.sum(cheap_xattn_pallas(x, y) * jg), argnums=(0, 1))(ja, jb)
    via_jnp = jax.grad(lambda x, y: jnp.sum(jax_reference(x, y) * jg), argnums=(0, 1))(ja, jb)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (a, b)]
    got = torch.autograd.grad(cx.cheap_xattn(*leaves), leaves, torch.from_numpy(g))
    before = cx.backward_launches
    wrapped = cx.cheap_xattn_backward(*map(torch.from_numpy, (a, b, g)))
    assert cx.backward_launches == before
    for name, t, w, p, r in zip("ab", got, wrapped, via_pallas, via_jnp):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), **GRAD_TOL, err_msg=name)
        np.testing.assert_allclose(t.numpy(), np.asarray(p), **GRAD_TOL, err_msg=name)
        np.testing.assert_array_equal(w.numpy(), t.numpy())


def test_equal_scores_give_the_mean():
    """A stream of identical frames (the masked eval's zero-filled stream
    after its encoder) gives rows of equal scores: the softmax is uniform and
    the output is the mean of B."""
    rng = np.random.default_rng(2)
    a = np.repeat(rng.normal(size=(2, 1, 12)), 64, axis=1).astype(np.float32)
    b = rng.normal(size=(2, 64, 12)).astype(np.float32)
    got = cx.cheap_xattn(torch.from_numpy(b), torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, a, **TOL)
    got = cx.cheap_xattn(torch.from_numpy(np.zeros_like(b)), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.broadcast_to(b.mean(1, keepdims=True), b.shape), **TOL)


# (Tq, Tk, d) -> (forward, backward) kernel variant, at each variant's edges:
# the sweep kernels hold 64 keys (the backward also 64 query rows) and rows of
# d <= 64, d = 12 at a compile-time width; up to 128 keys (the backward also
# 128 query rows) the sweep over 128 keys, its W 8 up to d 8; beyond that
# the two-pass kernels; beyond d = 64 the tiles in shared memory both ways
# at every Tq and Tk
VARIANT_EDGES = {
    (64, 64, 12): (cx.SWEEP_D12, cx.SWEEP_D12),
    (64, 65, 12): (cx.SWEEP_128, cx.SWEEP_128),
    (65, 64, 12): (cx.SWEEP_D12, cx.SWEEP_128),
    (101, 101, 6): (cx.SWEEP_128, cx.SWEEP_128),
    (101, 101, 3): (cx.SWEEP_128, cx.SWEEP_128),
    (101, 101, 8): (cx.SWEEP_128, cx.SWEEP_128),
    (101, 101, 9): (cx.SWEEP_128, cx.SWEEP_128),
    (128, 128, 12): (cx.SWEEP_128, cx.SWEEP_128),
    (128, 129, 12): (cx.TWO_PASS, cx.TWO_PASS),
    (129, 64, 12): (cx.SWEEP_D12, cx.TWO_PASS),
    (129, 65, 12): (cx.SWEEP_128, cx.TWO_PASS),
    (65, 128, 64): (cx.SWEEP_128, cx.SWEEP_128),
    (65, 128, 65): (cx.TILED, cx.TILED),
    (1, 1, 12): (cx.SWEEP_D12, cx.SWEEP_D12),
    (64, 63, 12): (cx.SWEEP_D12, cx.SWEEP_D12),
    (64, 64, 8): (cx.SWEEP, cx.SWEEP),
    (64, 64, 16): (cx.SWEEP, cx.SWEEP),
    (33, 47, 36): (cx.SWEEP, cx.SWEEP),
    (64, 64, 64): (cx.SWEEP, cx.SWEEP),
    (130, 20, 13): (cx.SWEEP, cx.TWO_PASS),
    (200, 100, 12): (cx.SWEEP_128, cx.TWO_PASS),
    (64, 64, 65): (cx.TILED, cx.TILED),
    (101, 426, 12): (cx.TWO_PASS, cx.TWO_PASS),
    (37, 70, 96): (cx.TILED, cx.TILED),
    (64, 64, 96): (cx.TILED, cx.TILED),
    (1, 64, 128): (cx.TILED, cx.TILED),
    (65, 63, 256): (cx.TILED, cx.TILED),
    (64, 65, 96): (cx.TILED, cx.TILED),
    (64, 130, 200): (cx.TILED, cx.TILED),
    (128, 128, 96): (cx.TILED, cx.TILED),
    (1, 1, 65): (cx.TILED, cx.TILED),
}


@pytest.mark.parametrize("shape", VARIANT_EDGES, ids=lambda s: "-".join(map(str, s)))
def test_variant_at_the_edges(shape):
    assert (cx._variant(*shape), cx._variant(*shape, backward=True)) == VARIANT_EDGES[shape]


@pytest.mark.parametrize("bad", ["rank", "batch", "width", "empty_t", "cotangent"])
def test_wrappers_reject_bad_arguments(bad):
    a, b, g = map(torch.from_numpy, _inputs(CASES[0]))
    if bad == "rank":
        a = a[0]
    elif bad == "batch":
        b = b[:1]
    elif bad == "width":
        b = b[..., :8]
    elif bad == "empty_t":
        b = b[:, :0]
    if bad == "cotangent":
        with pytest.raises(ValueError, match="cotangent"):
            cx.cheap_xattn_backward(a, b, g[:, :4])
        return
    with pytest.raises(ValueError):
        cx.cheap_xattn(a, b)
    with pytest.raises(ValueError):
        cx.cheap_xattn_backward(a, b, g)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No silent fallback: the kernel that cannot be built raises."""
    from gaitpd_torch.ops import _build

    assert "cheap_xattn" in _build.sources()
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("cheap_xattn")
