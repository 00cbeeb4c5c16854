"""gaitpd_torch.data.pipeline against gaitpd.data.pipeline on the same numpy
inputs.

Tolerance rtol = atol = 1e-5 throughout the port's tests: both sides compute
in f32, and what differs is the order of summation (and, in the models,
flax LayerNorm's fast variance E[x^2] - E[x]^2 against torch's two-pass
variance), which moves results by a few ulp of values of order 1.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaitpd.data import pipeline as jp  # noqa: E402
from gaitpd_torch.data import pipeline as tp  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _nonfinite_stream(rng, t=50, c=6):
    x = rng.normal(size=(t, c)).astype(np.float32) * 3 + 1
    x[3, 0] = np.nan
    x[7, 2] = np.inf
    x[9, c - 1] = -np.inf
    x[10:13, 4] = np.nan
    return x


def test_zscore_guards_match():
    rng = np.random.default_rng(0)
    x = _nonfinite_stream(rng)
    mean = rng.normal(size=6).astype(np.float32)
    std = np.abs(rng.normal(size=6)).astype(np.float32) + 0.5
    mean[1] = np.nan  # non-finite mean -> 0
    std[2] = 1e-9  # below MIN_STD_WG -> floored
    std[3] = np.inf  # non-finite std -> floored
    std[4] = np.nan
    std[5] = 0.0
    ref = np.asarray(jp.zscore(jnp.asarray(x), jnp.asarray(mean), jnp.asarray(std)))
    got = tp.zscore(torch.from_numpy(x), torch.from_numpy(mean), torch.from_numpy(std))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_min_std_constant_matches():
    assert tp.MIN_STD_WG == jp.MIN_STD_WG


@pytest.mark.parametrize("axis", [0, (0, 1)])
def test_fit_zscore_stats_match(axis):
    rng = np.random.default_rng(1)
    x = _nonfinite_stream(rng, t=40, c=6)
    x[:, 1] = 2.5  # constant channel: std floored at MIN_STD_WG
    if axis == (0, 1):
        x = x.reshape(4, 10, 6)
    rm, rs = jp.fit_zscore_stats(jnp.asarray(x), axis=axis)
    gm, gs = tp.fit_zscore_stats(torch.from_numpy(x), axis=axis)
    np.testing.assert_allclose(gm.numpy(), np.asarray(rm), **TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), **TOL)


# (win, hop): hop == win (reshape), win % hop == 0 (interleave), gather
@pytest.mark.parametrize("win,hop", [(64, 64), (16, 16), (64, 32), (64, 16), (64, 24), (10, 3)])
@pytest.mark.parametrize("t", [0, 9, 64, 65, 200, 301])
def test_window_stream_paths_match(win, hop, t):
    rng = np.random.default_rng(t + win + hop)
    x = rng.normal(size=(t, 3)).astype(np.float32)
    ref = np.asarray(jp.window_stream(jnp.asarray(x), win, hop))
    got = tp.window_stream(torch.from_numpy(x), win, hop).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, tp.window_stream_np(x, win, hop))


@pytest.mark.parametrize("t,win,hop", [(0, 4, 2), (3, 4, 2), (4, 4, 2), (17, 4, 3), (64, 64, 64)])
def test_numpy_helpers_match(t, win, hop):
    assert tp.window_indices(t, win, hop) == jp.window_indices(t, win, hop)
    x = np.arange(t * 2, dtype=np.float32).reshape(t, 2)
    np.testing.assert_array_equal(tp.window_stream_np(x, win, hop),
                                  jp.window_stream_np(x, win, hop))
    for target in (0, 5, t, t + 3):
        np.testing.assert_array_equal(tp.pad_or_trim(x, target, -1.0),
                                      jp.pad_or_trim(x, target, -1.0))
