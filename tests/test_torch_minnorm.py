"""gaitpd_torch.learning.minnorm (the plain CAGrad solver, batched) against
gaitpd.learning.minnorm on the same seeded Gram matrices, the degenerate
ones included, and against scipy's SLSQP as tests/test_mtl.py holds gaitpd.

Tolerances: the objective within 1e-6 relative. w within 5e-4: near the
optimum the objective is flat to f32 rounding along some directions, so the
last golden-section comparisons are decided by the order of the sums and
the two solvers stop at different points of that flat stretch (measured up
to 3.8e-4 on such seeds, with objectives equal to 2.2e-7). The CUDA
kernel runs the plain version's operations in its order and is held to it
bit for bit on the card (tests/test_torch_kernel_card.py).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaitpd.learning.minnorm import cagrad_weights as jax_cagrad_weights  # noqa: E402
from gaitpd.learning.minnorm import project_simplex as jax_project_simplex  # noqa: E402
from gaitpd_torch.learning.minnorm import cagrad_weights, project_simplex  # noqa: E402
from gaitpd_torch.ops import cagrad_solver as cs  # noqa: E402

W_TOL = 5e-4
F_RTOL = 1e-6


def random_gram(rng, k, scale=1.0):
    g = rng.normal(size=(k, 6)) * scale
    return g @ g.T + 1e-4 * np.eye(k)


def grams(k, n=12, seed=0):
    """n seeded PSD Gram matrices of growing scale plus the degenerate ones:
    zero, rank-1, identical tasks, one task with a zero gradient."""
    rng = np.random.default_rng(seed + k)
    out = [random_gram(rng, k, 1.0 + s % 4) for s in range(n)]
    v = rng.normal(size=k)
    zero_task = random_gram(rng, k)
    zero_task[0, :] = zero_task[:, 0] = 0.0
    out += [np.zeros((k, k)), np.outer(v, v), np.full((k, k), 2.0), zero_task]
    return np.stack(out).astype(np.float32)


def c_coef(gram, c=0.5):
    return (c * np.sqrt(gram.mean((-2, -1)) + 1e-8) + 1e-8).astype(np.float32)


def objective(w, gram, c):
    k = gram.shape[-1]
    return float(w @ gram @ (np.ones(k) / k) + c * np.sqrt(w @ gram @ w + 1e-8))


def test_project_simplex_matches():
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.normal(size=(20, 4)) * 2,
                        rng.dirichlet(np.ones(4), size=3)]).astype(np.float32)
    got = project_simplex(torch.from_numpy(v)).numpy()
    ref = np.stack([np.asarray(jax_project_simplex(jnp.asarray(x))) for x in v])
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
    assert np.all(got >= 0)
    np.testing.assert_allclose(got[-3:], v[-3:], atol=1e-6)  # already on the simplex


@pytest.mark.parametrize("k", [2, 3])
def test_cagrad_weights_match_gaitpd(k):
    g = grams(k)
    cc = c_coef(g)
    got = cagrad_weights(torch.from_numpy(g), torch.from_numpy(cc)).numpy()
    for i, (gi, ci) in enumerate(zip(g, cc)):
        ref = np.asarray(jax_cagrad_weights(jnp.asarray(gi), jnp.asarray(ci)))
        g64 = gi.astype(np.float64)
        f_got = objective(got[i].astype(np.float64), g64, float(ci))
        f_ref = objective(ref.astype(np.float64), g64, float(ci))
        assert abs(f_got - f_ref) <= F_RTOL * max(abs(f_ref), 1e-12), (i, f_got, f_ref)
        np.testing.assert_allclose(got[i], ref, atol=W_TOL, err_msg=f"matrix {i}")


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cagrad_weights_match_scipy(k, seed):
    from scipy.optimize import minimize

    rng = np.random.default_rng(seed)
    gram = random_gram(rng, k, scale=1.0 + seed)
    c = 0.5 * np.sqrt(gram.mean() + 1e-8)
    w = cagrad_weights(torch.from_numpy(gram.astype(np.float32)), float(c)).numpy()
    res = minimize(lambda x: objective(x, gram, c), np.ones(k) / k, bounds=[(0, 1)] * k,
                   constraints={"type": "eq", "fun": lambda x: 1 - x.sum()})
    assert objective(w.astype(np.float64), gram, c) <= objective(res.x, gram, c) + 1e-4
    np.testing.assert_allclose(w.sum(), 1.0, atol=1e-5)
    assert np.all(w >= -1e-6)


def test_batched_equals_one_by_one():
    g = grams(3, n=1)[:3]
    cc = c_coef(g)
    batched = cagrad_weights(torch.from_numpy(g), torch.from_numpy(cc)).numpy()
    for gi, ci, wi in zip(g, cc, batched):
        np.testing.assert_array_equal(cagrad_weights(torch.from_numpy(gi), float(ci)).numpy(), wi)


def test_solver_wrapper_takes_the_plain_version_on_cpu():
    g = torch.from_numpy(grams(3, n=3))
    before = cs.launches
    got = cs.cagrad_solve(g, 0.5)
    assert cs.launches == before
    want = cagrad_weights(g, cs.cagrad_c_coef(g, 0.5))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(cs.cagrad_c_coef(g, 0.5), torch.from_numpy(c_coef(g.numpy())))
    with pytest.raises(ValueError):
        cs.cagrad_solve(torch.eye(9), 0.5)
