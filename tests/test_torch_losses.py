"""gaitpd_torch.learning.losses against gaitpd.learning.losses on the same
numpy logits, labels, weights and valid masks: values and gradients with
respect to the logits, for the four losses of WearGait training (ce,
class_wt, ldam, gcl), the margins and the inverse-frequency weights.

Tolerance 1e-5 relative and absolute: f32 on both sides, the same
log-softmax, only the order of the sums differs. GCL noise cannot match
JAX's PRNG: with noise_mul > 0 the loss is held to a numpy Monte-Carlo
estimate of its expectation instead.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaitpd.learning import losses as JL  # noqa: E402
from gaitpd_torch.learning import losses as TL  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
COUNTS = [37, 11]


def _batch(seed, b=16, c=2, padded=3):
    rng = np.random.default_rng(seed)
    logits = rng.uniform(-0.9, 0.9, size=(b, c)).astype(np.float32)  # cosine-like
    labels = rng.integers(0, c, size=b).astype(np.int32)
    valid = np.ones(b, np.float32)
    valid[b - padded:] = 0.0
    return logits, labels, valid


def _loss_pair(wm):
    """(jax_fn(logits, labels, valid), torch_fn(logits, labels, valid))."""
    jw, tw = JL.inv_freq_weights(COUNTS), TL.inv_freq_weights(COUNTS)
    if wm == "ce":
        return (lambda lg, y, v: JL.cross_entropy(lg, y, None, v),
                lambda lg, y, v: TL.cross_entropy(lg, y, None, v))
    if wm == "class_wt":
        return (lambda lg, y, v: JL.cross_entropy(lg, y, jw, v),
                lambda lg, y, v: TL.cross_entropy(lg, y, tw, v))
    if wm == "ldam":
        jm, tm = JL.ldam_margins(COUNTS), TL.ldam_margins(COUNTS)
        return (lambda lg, y, v: JL.ldam_loss(lg, y, jm, s=30.0, weight=jw, valid=v),
                lambda lg, y, v: TL.ldam_loss(lg, y, tm, s=30.0, weight=tw, valid=v))
    jm, tm = JL.gcl_margins(COUNTS), TL.gcl_margins(COUNTS)
    key = jax.random.PRNGKey(0)
    return (lambda lg, y, v: JL.gcl_loss(lg, y, jm, key, m=0.2, s=25.0, noise_mul=0.0,
                                         weight=jw, valid=v),
            lambda lg, y, v: TL.gcl_loss(lg, y, tm, None, m=0.2, s=25.0, noise_mul=0.0,
                                         weight=tw, valid=v))


@pytest.mark.parametrize("with_valid", [True, False])
@pytest.mark.parametrize("wm", ["ce", "class_wt", "ldam", "gcl"])
def test_loss_and_logit_gradient_match(wm, with_valid):
    logits, labels, valid = _batch(len(wm))
    jfn, tfn = _loss_pair(wm)
    v_j = jnp.asarray(valid) if with_valid else None
    v_t = torch.from_numpy(valid) if with_valid else None
    ref, ref_grad = jax.value_and_grad(lambda lg: jfn(lg, jnp.asarray(labels), v_j))(
        jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_()
    got = tfn(lg, torch.from_numpy(labels), v_t)
    (got_grad,) = torch.autograd.grad(got, lg)
    np.testing.assert_allclose(got.item(), float(ref), **TOL)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(ref_grad), **TOL)
    if with_valid:  # padded rows get no gradient
        assert np.all(got_grad.numpy()[valid == 0] == 0)


def test_fully_padded_batch_is_zero():
    logits, labels, _ = _batch(1)
    zero = torch.zeros(len(labels))
    for wm in ("ce", "class_wt", "ldam", "gcl"):
        assert _loss_pair(wm)[1](torch.from_numpy(logits), torch.from_numpy(labels),
                                 zero).item() == 0.0


@pytest.mark.parametrize("counts", [[37, 11], [5, 5], [3, 40, 9], [0, 12]])
def test_margins_and_weights_match(counts):
    np.testing.assert_allclose(TL.ldam_margins(counts, max_m=0.5).numpy(),
                               np.asarray(JL.ldam_margins(counts, max_m=0.5)), **TOL)
    np.testing.assert_allclose(TL.gcl_margins(counts).numpy(),
                               np.asarray(JL.gcl_margins(counts)), **TOL)
    np.testing.assert_allclose(TL.inv_freq_weights(counts).numpy(),
                               np.asarray(JL.inv_freq_weights(counts)), **TOL)


def test_symmetric_kl_matches():
    rng = np.random.default_rng(3)
    a, b = (rng.normal(size=(9, 3)).astype(np.float32) for _ in range(2))
    valid = (rng.uniform(size=9) > 0.3).astype(np.float32)
    ref = JL.symmetric_kl_consistency(jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid))
    got = TL.symmetric_kl_consistency(torch.from_numpy(a), torch.from_numpy(b),
                                      torch.from_numpy(valid))
    np.testing.assert_allclose(got.item(), float(ref), **TOL)


def test_gcl_noise_statistics():
    """noise_mul > 0: the batch-mean loss over 20,000 identical rows estimates
    E[loss] under |clip(N(0, 1/3), -1, 1)| noise; it must agree with a
    numpy Monte-Carlo estimate (2e6 draws) to 1 % (the batch mean's own
    spread is about 0.3 %). A fixed generator seed repeats the draw."""
    b, m_list = 20000, TL.gcl_margins(COUNTS)
    row = np.array([0.3, -0.2], np.float32)
    logits = torch.from_numpy(np.tile(row, (b, 1)))
    labels = torch.zeros(b, dtype=torch.int64)

    def draw(seed):
        return TL.gcl_loss(logits, labels, m_list, torch.Generator().manual_seed(seed),
                           m=0.2, s=25.0, noise_mul=1.0).item()

    rng = np.random.default_rng(0)
    noise = np.abs(np.clip(rng.normal(size=(2_000_000, 2)) / 3.0, -1.0, 1.0))
    mm = m_list.numpy().astype(np.float64)
    cos = row[None, :] - noise / mm.max() * mm[None, :]
    cos[:, 0] -= 0.2
    z = 25.0 * cos
    nll = np.logaddexp(z[:, 0], z[:, 1]) - z[:, 0]
    expect = nll.mean()
    got = draw(1)
    assert abs(got - expect) <= 0.01 * expect, (got, expect)
    assert draw(1) == got and draw(2) != got
    noise_free = TL.gcl_loss(logits, labels, m_list, None, m=0.2, s=25.0, noise_mul=0.0)
    # the noise lowers only the rarer class's logit (its margin > 0): with
    # label 0, the loss falls
    assert got < noise_free.item()
