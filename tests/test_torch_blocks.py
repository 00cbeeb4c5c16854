"""gaitpd_torch.models.blocks against gaitpd.models.blocks, parameters moved
by gaitpd_torch.params.load_flax_params. Tolerance: see test_torch_pipeline.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaitpd.models import blocks as jb  # noqa: E402
from gaitpd_torch.models import blocks as tb  # noqa: E402
from gaitpd_torch.params import load_flax_params  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _perturbed(variables, rng, scale=0.1):
    """Flax variables as numpy, every leaf moved off its init (LayerNorm's
    scale 1 / bias 0 would otherwise hide a layout or name mix-up)."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.normal(size=a.shape) * scale).astype(np.float32),
        variables,
    )


@pytest.mark.parametrize("t_in,t_out", [(64, 8), (101, 8), (10, 3), (5, 8), (7, 7),
                                       (426, 101), (65, 101)])
def test_pool_matrix_exact(t_in, t_out):
    got = tb.adaptive_avg_pool_matrix(t_in, t_out).numpy()
    np.testing.assert_array_equal(got, jb.adaptive_avg_pool_matrix(t_in, t_out))


@pytest.mark.parametrize("t_in,t_out", [(64, 8), (101, 8), (10, 3)])
def test_adaptive_avg_pool1d_matches(t_in, t_out):
    x = np.random.default_rng(t_in).normal(size=(3, t_in, 5)).astype(np.float32)
    ref = np.asarray(jb.adaptive_avg_pool1d(jnp.asarray(x), t_out))
    got = tb.adaptive_avg_pool1d(torch.from_numpy(x), t_out).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    # and torch's own AdaptiveAvgPool1d (NCW)
    lib = torch.nn.functional.adaptive_avg_pool1d(torch.from_numpy(x).transpose(1, 2), t_out)
    np.testing.assert_allclose(got, lib.transpose(1, 2).numpy(), **TOL)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_conv1d_same_matches_flax(k):
    rng = np.random.default_rng(k)
    x = rng.normal(size=(4, 33, 7)).astype(np.float32)
    fm = jb.Conv1dSame(11, kernel_size=k)
    v = _perturbed(fm.init(jax.random.PRNGKey(k), jnp.asarray(x)), rng)
    tm = load_flax_params(tb.Conv1dSame(7, 11, k, generator=torch.Generator()), v)
    assert tuple(tm.weight.shape) == (11, 7, k)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(fm.apply(v, jnp.asarray(x))), **TOL)


def test_conv1d_same_rejects_even_kernel():
    with pytest.raises(ValueError):
        tb.Conv1dSame(3, 4, 2, generator=torch.Generator())


@pytest.mark.parametrize("use_norm,use_cosine", [(False, False), (True, False), (False, True)])
def test_task_head_matches_flax(use_norm, use_cosine):
    rng = np.random.default_rng(int(use_norm) + 2 * int(use_cosine))
    x = rng.normal(size=(6, 128)).astype(np.float32)
    fm = jb.TaskHead(3, use_norm=use_norm, use_cosine=use_cosine)
    v = _perturbed(fm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    tm = load_flax_params(
        tb.TaskHead(128, 3, use_norm, use_cosine, generator=torch.Generator()), v
    )
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(fm.apply(v, jnp.asarray(x))), **TOL)


def test_cosine_linear_clip_and_zero_row():
    """A zero feature row takes the max(norm, eps) path, and cosines stay in
    the clipped range, as in flax."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    x[1] = 0.0
    fm = jb.CosineLinear(5)
    v = _perturbed(fm.init(jax.random.PRNGKey(1), jnp.asarray(x)), rng)
    tm = load_flax_params(tb.CosineLinear(16, 5, generator=torch.Generator()), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(fm.apply(v, jnp.asarray(x))), **TOL)
    assert np.abs(got).max() <= 1.0


def test_gelu_and_flatten_match():
    x = np.linspace(-6, 6, 97, dtype=np.float32).reshape(1, 97)
    np.testing.assert_allclose(tb.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jb.gelu(jnp.asarray(x))), **TOL)
    y = np.arange(2 * 8 * 16, dtype=np.float32).reshape(2, 8, 16)
    np.testing.assert_array_equal(tb.flatten_features(torch.from_numpy(y)).numpy(),
                                  np.asarray(jb.flatten_features(jnp.asarray(y))))


def test_torch_law_init_bounds_and_seed():
    g = torch.Generator().manual_seed(5)
    conv = tb.Conv1dSame(12, 16, 3, generator=g)
    bound = 1.0 / np.sqrt(3 * 12)
    assert conv.weight.abs().max() <= bound and conv.bias.abs().max() <= bound
    assert conv.weight.abs().max() > 0.8 * bound  # drawn over the whole range
    lin = tb.TorchLinear(128, 2, generator=torch.Generator().manual_seed(5))
    assert lin.weight.abs().max() <= 1.0 / np.sqrt(128)
    cos = tb.CosineLinear(128, 2, generator=torch.Generator().manual_seed(5))
    assert tuple(cos.weight.shape) == (128, 2)
    assert cos.weight.abs().max() <= np.sqrt(6.0 / 130)
    again = tb.Conv1dSame(12, 16, 3, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(again.weight, conv.weight, rtol=0, atol=0)


def test_loader_raises_on_missing_and_extra_leaves():
    tm = tb.TaskHead(8, 2, use_norm=True, generator=torch.Generator())
    full = {"params": {
        "LayerNorm_0": {"scale": np.ones(8, np.float32), "bias": np.zeros(8, np.float32)},
        "TorchLinear_0": {"Dense_0": {"kernel": np.ones((8, 2), np.float32),
                                      "bias": np.zeros(2, np.float32)}},
    }}
    load_flax_params(tm, full)
    missing = {"params": {"TorchLinear_0": full["params"]["TorchLinear_0"]}}
    with pytest.raises(ValueError, match="missing"):
        load_flax_params(tm, missing)
    extra = {"params": dict(full["params"], Extra_0={"bias": np.zeros(2, np.float32)})}
    with pytest.raises(ValueError, match="extra"):
        load_flax_params(tm, extra)
    wrong = {"params": dict(full["params"], TorchLinear_0={"Dense_0": {
        "kernel": np.ones((2, 8), np.float32), "bias": np.zeros(2, np.float32)}})}
    with pytest.raises(ValueError):
        load_flax_params(tm, wrong)


def test_loader_copies():
    """The loaded module shares no memory with the caller's arrays."""
    kernel = np.ones((8, 2), np.float32)
    tm = tb.TorchLinear(8, 2, generator=torch.Generator())
    load_flax_params(tm, {"params": {"Dense_0": {"kernel": kernel,
                                                 "bias": np.zeros(2, np.float32)}}})
    kernel[:] = 5.0
    assert float(tm.weight.detach().max()) == 1.0
