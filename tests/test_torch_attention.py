"""gaitpd_torch.ops.attention against gaitpd.ops.attention on the same numpy
inputs: the cheap cross-attention (one direction and symmetric), the
multi-head scaled core with kv_mask and scale_mul, and the masked pairwise
enrichment of the 3-stream fusion model.

Tolerances: forwards within 1e-5, gradients within 1e-5 absolute plus 1e-4
relative (f32 on both sides; only the order of summation differs).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaitpd.ops import attention as JA  # noqa: E402
from gaitpd_torch.ops import attention as TA  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("tq,tk,d", [(64, 64, 12), (37, 53, 8), (101, 101, 6)])
def test_cheap_cross_attention(tq, tk, d):
    rng = np.random.default_rng(tq)
    a, b = _normal(rng, 3, tq, d), _normal(rng, 3, tk, d)
    got = TA.cheap_cross_attention(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(JA.cheap_cross_attention(a, b)), **TOL)


@pytest.mark.parametrize("t,d", [(64, 12), (101, 6), (5, 3)])
def test_cheap_cross_attention_sym_and_its_gradient(t, d):
    rng = np.random.default_rng(t)
    s, g, cot = _normal(rng, 4, t, d), _normal(rng, 4, t, d), _normal(rng, 4, t, d)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (s, g)]
    out = TA.cheap_cross_attention_sym(*leaves)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(JA.cheap_cross_attention_sym(s, g)), **TOL)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    want = jax.grad(lambda x, y: jnp.sum(JA.cheap_cross_attention_sym(x, y) * cot),
                    argnums=(0, 1))(s, g)
    for name, t_, w in zip("sg", got, want):
        np.testing.assert_allclose(t_.numpy(), np.asarray(w), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("n_heads", [1, 2, 4])
@pytest.mark.parametrize("scale_mul", [1.0, 0.5, "tensor"])
@pytest.mark.parametrize("kv_mask", [None, "partial"])
def test_scaled_cross_attention(n_heads, scale_mul, kv_mask):
    rng = np.random.default_rng(n_heads)
    q, k, v = _normal(rng, 3, 7, 16), _normal(rng, 3, 11, 16), _normal(rng, 3, 11, 16)
    t_scale = j_scale = scale_mul
    if scale_mul == "tensor":  # TACA's traced γ/τ
        t_scale, j_scale = torch.tensor(1.7), jnp.asarray(1.7, jnp.float32)
    mask = None
    if kv_mask == "partial":  # every row keeps at least one key
        mask = (rng.uniform(size=(3, 11)) > 0.4).astype(np.float32)
        mask[:, 0] = 1.0
    got = TA.scaled_cross_attention(*map(torch.from_numpy, (q, k, v)), n_heads, t_scale,
                                    None if mask is None else torch.from_numpy(mask))
    want = JA.scaled_cross_attention(q, k, v, n_heads, j_scale,
                                     None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


MASKS = [None, (True, True, True), (True, False, True), (False, False, True),
         (False, False, False)]


@pytest.mark.parametrize("mask", MASKS, ids=str)
def test_masked_pairwise_enrichment_and_its_gradient(mask):
    rng = np.random.default_rng(5)
    xs = [_normal(rng, 4, 64, 12) for _ in range(3)]
    cots = [_normal(rng, 4, 64, 12) for _ in range(3)]
    leaves = [torch.from_numpy(x).requires_grad_() for x in xs]
    got = TA.masked_pairwise_enrichment(leaves, mask)
    j_mask = None if mask is None else jnp.asarray(mask)
    want = JA.masked_pairwise_enrichment([jnp.asarray(x) for x in xs], j_mask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    loss = sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, cots))
    grads = torch.autograd.grad(loss, leaves)

    def j_loss(*ys):
        outs = JA.masked_pairwise_enrichment(list(ys), j_mask)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))

    want_g = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, xs))
    for i, (g, w) in enumerate(zip(grads, want_g)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL, err_msg=f"stream {i}")


def test_enrichment_of_streams_of_unequal_length():
    """Streams of different lengths cannot share one call; each pair goes
    on its own, with the same result."""
    rng = np.random.default_rng(6)
    xs = [_normal(rng, 2, t, 12) for t in (64, 16, 16)]
    got = TA.masked_pairwise_enrichment([torch.from_numpy(x) for x in xs],
                                        torch.tensor([True, True, False]))
    want = JA.masked_pairwise_enrichment([jnp.asarray(x) for x in xs],
                                         jnp.asarray([True, True, False]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
