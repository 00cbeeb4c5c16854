"""gaitpd_torch.models.multitask.WearGaitThreeModal against the flax model,
from one set of flax parameters copied by gaitpd_torch.params. Tolerance:
see test_torch_pipeline.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaitpd.models.multitask import WearGaitThreeModal as FlaxModel  # noqa: E402
from gaitpd_torch.models.multitask import MODALITIES, WearGaitThreeModal  # noqa: E402
from gaitpd_torch.params import load_flax_params  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
HEADS = [(False, False), (True, False), (False, True)]  # plain, LDAM, GCL


def _pair(seed, **kw):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(5, 64, c)).astype(np.float32) for c in (2, 13, 24)]
    fm = FlaxModel(**kw)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.normal(size=a.shape) * 0.1).astype(np.float32),
        fm.init(jax.random.PRNGKey(seed), *map(jnp.asarray, xs)),
    )
    tm = load_flax_params(WearGaitThreeModal(**kw), v)
    return fm, v, tm, xs


@pytest.mark.parametrize("use_norm,use_cosine", HEADS)
@pytest.mark.parametrize("synchronized", [True, False])
def test_three_modal_logits_match(synchronized, use_norm, use_cosine):
    fm, v, tm, xs = _pair(int(synchronized), synchronized=synchronized,
                          use_norm=use_norm, use_cosine=use_cosine)
    ref = fm.apply(v, *map(jnp.asarray, xs))
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, xs))
    assert len(got) == 3
    for g, r in zip(got, ref):
        assert g.shape == (5, 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("synchronized", [True, False])
def test_forward_single_matches(synchronized):
    fm, v, tm, xs = _pair(7, synchronized=synchronized)
    for mod, x in zip(MODALITIES, xs):
        ref = fm.apply(v, jnp.asarray(x), mod, method=FlaxModel.forward_single)
        with torch.no_grad():
            got = tm.forward_single(torch.from_numpy(x), mod)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_pooled_encoders_take_the_per_stream_backbone():
    """With pool_len the walkway stream keeps T=64 while the others pool, so
    the backbone runs per stream; logits still match."""
    fm, v, tm, xs = _pair(3, pool_len=16)
    ref = fm.apply(v, *map(jnp.asarray, xs))
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, xs))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_unequal_batches_share_one_backbone_call():
    """The three streams may carry different batch sizes: the concatenated
    backbone call splits them back correctly."""
    fm, v, tm, _ = _pair(4)
    rng = np.random.default_rng(4)
    xs = [rng.normal(size=(n, 64, c)).astype(np.float32)
          for n, c in zip((2, 5, 3), (2, 13, 24))]
    ref = fm.apply(v, *map(jnp.asarray, xs))
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, xs))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("synchronized", [True, False])
def test_partition_names_match(synchronized):
    fm = FlaxModel(synchronized=synchronized)
    tm = WearGaitThreeModal(synchronized=synchronized)
    assert tm.shared_modules == fm.shared_modules
    assert tm.task_modules == fm.task_modules
    tops = {name.split(".")[0] for name, _ in tm.named_parameters()}
    named = set(tm.shared_modules) | {m for grp in tm.task_modules for m in grp}
    assert tops == named


def test_parameter_count_and_seeded_init():
    fm = FlaxModel()
    xs = [jnp.ones((1, 64, c)) for c in (2, 13, 24)]
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves(fm.init(jax.random.PRNGKey(0), *xs)))
    a = WearGaitThreeModal(generator=torch.Generator().manual_seed(3))
    b = WearGaitThreeModal(generator=torch.Generator().manual_seed(3))
    assert sum(p.numel() for p in a.parameters()) == n_flax
    for pa, pb in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
