"""MGDA's Frank-Wolfe with the stop at its bitwise fixed point.

The kernel min_norm_solver (gaitpd_torch/csrc/mtl_solvers.cu) ends a solve
after a step, one of every min_norm_every(K), that leaves w's bits unchanged;
``min_norm_element_stop`` is its plain form, the step formed towards every
vertex as the kernel's lanes form it. A step is a fixed function of (G, w),
so the stopped w must be the 250-step ``min_norm_element``'s bit for bit:
held here at K = 1, 2, 3 and 8 on seeded matrices of chip_smoke.py's
``mtl_solver_grams`` law, on correlated ones and on degenerate ones, and at
K = 3 against gaitpd's solver.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gaitpd_torch.learning import minnorm as TN
from gaitpd_torch.ops import mtl_solvers as MS

N_SEEDED = 24


def law_grams(rng, n, k):
    """chip_smoke.py::mtl_solver_grams' seeded law: PSD, four decades of scale."""
    a = rng.normal(size=(n, k, 6)) * 10.0 ** rng.uniform(-2, 2, size=(n, 1, 1))
    return a @ a.transpose(0, 2, 1) + 1e-4 * np.eye(k)


def correlated_grams(rng, n, k):
    """Task gradients around one shared direction at scales two decades apart."""
    base = rng.normal(size=(n, 1, 6))
    a = (base + 0.3 * rng.normal(size=(n, k, 6))) * 10.0 ** rng.uniform(-1, 1, size=(n, k, 1))
    return a @ a.transpose(0, 2, 1)


def degenerate_grams(rng, k):
    """Zero, rank one, all tasks equal, one zero task, a NaN entry."""
    v = np.abs(rng.normal(size=k)) + 0.1
    zero_task = law_grams(rng, 1, k)[0]
    zero_task[0, :] = zero_task[:, 0] = 0.0
    nan = law_grams(rng, 1, k)[0]
    nan[k - 1, 0] = np.nan
    return np.stack([np.zeros((k, k)), np.outer(v, v), np.full((k, k), 2.0), zero_task, nan])


def all_grams(k):
    rng = np.random.default_rng([7, k])
    return torch.from_numpy(np.concatenate([
        law_grams(rng, N_SEEDED, k), correlated_grams(rng, 8, k), degenerate_grams(rng, k),
    ]).astype(np.float32))


def bitwise(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_stop_is_the_250_step_result_bit_for_bit(k):
    grams = all_grams(k)
    want = TN.min_norm_element(grams)
    w, stop = TN.min_norm_element_stop(grams)
    assert bitwise(w, want)
    every = TN.min_norm_every(k)
    assert ((stop % every == 0) | (stop == MS.MIN_NORM_STEPS)).all()
    assert ((stop >= every) & (stop <= MS.MIN_NORM_STEPS)).all()
    # one matrix at a time, and a compare after every step, stop alike
    for g, wi in zip(grams[[0, N_SEEDED, -1]], want[[0, N_SEEDED, -1]]):
        one, s = TN.min_norm_element_stop(g, every=1)
        assert bitwise(one, wi) and s.dim() == 0


def test_seeded_matrices_take_both_branches():
    """The seeded sets at K = 2, 3 and 8, at the kernel's cadence of the
    compare, hold a solve that stops within 10 steps and one that runs all
    250 steps: the tests above cover both."""
    stops = torch.cat([TN.min_norm_element_stop(all_grams(k))[1] for k in (2, 3, 8)])
    assert (stops <= 10).any()
    assert (stops == MS.MIN_NORM_STEPS).any()


def test_stop_matches_gaitpd_at_three_tasks():
    """tests/test_torch_mtl_methods.py::test_min_norm_matches_gaitpd_and_scipy's
    tolerance: the objective within 1e-5 of gaitpd's, w on the simplex."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from gaitpd.learning import minnorm as JN

    grams = all_grams(3)[:-1].numpy()  # not the NaN one
    got = TN.min_norm_element_stop(torch.from_numpy(grams))[0].numpy()
    ref = np.asarray(jax.vmap(JN.min_norm_element)(jnp.asarray(grams)))
    for i, g in enumerate(grams.astype(np.float64)):
        f_got, f_ref = got[i] @ g @ got[i], ref[i] @ g @ ref[i]
        assert abs(f_got - f_ref) <= 1e-5 * max(abs(f_ref), 1e-12), (i, f_got, f_ref)
        np.testing.assert_allclose(got[i].sum(), 1.0, atol=1e-5)
        assert np.all(got[i] >= 0)


@pytest.mark.parametrize("variant", MS.MIN_NORM_VARIANTS)
def test_min_norm_designs_by_name_take_a_cuda_tensor_only(variant):
    with pytest.raises(ValueError, match="CUDA"):
        MS._solve_kernel("min_norm_solver", all_grams(3)[:2], variant=variant)
