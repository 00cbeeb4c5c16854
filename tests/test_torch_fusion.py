"""gaitpd_torch.models.fusion against gaitpd.models.fusion: all eight fusion
models, sync and async, from one set of flax parameters copied by
gaitpd_torch.params. Forward outputs, and the gradients of every parameter
for the same cotangents.

Tolerances: forwards within 1e-5, gradients within 1e-5 absolute plus 1e-4
relative (f32 on both sides; only the order of summation differs).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaitpd.models import fusion as JF  # noqa: E402
from gaitpd_torch.models import fusion as TF  # noqa: E402
from gaitpd_torch.params import export_flax_params, load_flax_params  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# Seeds of the inputs and the parameter noise. A ReLU pre-activation within
# f32 rounding of zero makes ReLU' differ between the two packages (seed 2
# of SharedLatent3 puts one at 1.3e-7); these seeds keep every one clear.
SEED = 20

THREE_MOD = ["EarlyFusion3", "LateFusion3", "SharedLatent3", "CheapXAttn3"]
TWO_MOD = sorted(TF.TWO_MOD_FUSIONS)
# FoG's widths (gaitpd/config.py:60-70) at tests/test_models.py's sizes
TWO_MOD_KW = dict(skeleton_output_dim=6, sensor_out_channels=6, sensor_length=426)
TWO_MOD_IN = dict(skeleton_input_dim=21, sensor_in_channels=6)


def _perturbed_init(fm, xs, rng, **call_kw):
    """flax parameters with seeded noise added, so no bias is zero."""
    v = fm.init(jax.random.PRNGKey(0), *map(jnp.asarray, xs), **call_kw)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.normal(size=a.shape) * 0.1).astype(np.float32), v)


def _as_tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _compare(fm, v, tm, xs, rng, j_kw=None, t_kw=None):
    """Forward outputs and parameter gradients for seeded cotangents."""
    j_kw, t_kw = j_kw or {}, t_kw or {}
    jx = [jnp.asarray(x) for x in xs]
    ref = _as_tuple(fm.apply(v, *jx, **j_kw))
    got = _as_tuple(tm(*map(torch.from_numpy, xs), **t_kw))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), **TOL)
    cots = [rng.normal(size=r.shape).astype(np.float32) for r in ref]

    def j_loss(params):
        outs = _as_tuple(fm.apply({"params": params}, *jx, **j_kw))
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))

    want = jax.grad(j_loss)(v["params"])
    loss = sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, cots))
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    got_tree = export_flax_params(tm, dict(zip(names, grads)))["params"]
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    assert {jax.tree_util.keystr(k) for k in flat_got} == {
        jax.tree_util.keystr(k) for k in flat_want}
    by_name = {jax.tree_util.keystr(k): a for k, a in flat_got.items()}
    for path, w in flat_want.items():
        name = jax.tree_util.keystr(path)
        np.testing.assert_allclose(by_name[name], np.asarray(w), **GRAD_TOL, err_msg=name)


def _three_mod_pair(name, sync, seed, **kw):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(5, 64, c)).astype(np.float32) for c in (2, 13, 24)]
    fm = getattr(JF, name)(synchronized=sync, **kw)
    v = _perturbed_init(fm, xs, rng)
    tm = load_flax_params(getattr(TF, name)(synchronized=sync, **kw), v)
    return fm, v, tm, xs, rng


@pytest.mark.parametrize("sync", [True, False])
@pytest.mark.parametrize("name", THREE_MOD)
def test_three_mod_fusion_matches_flax(name, sync):
    fm, v, tm, xs, rng = _three_mod_pair(name, sync, seed=SEED + THREE_MOD.index(name))
    _compare(fm, v, tm, xs, rng)


def test_shared_latent3_takes_proj_ch():
    fm, v, tm, xs, rng = _three_mod_pair("SharedLatent3", True, seed=SEED + 9, proj_ch=8)
    assert tm.proj_w.weight.shape == (8, 12)
    _compare(fm, v, tm, xs, rng)


@pytest.mark.parametrize("mask", [(True, False, True), (False, False, True), (True, True, True)],
                         ids=str)
@pytest.mark.parametrize("sync", [True, False])
def test_cheap_xattn3_mask_matches_flax(sync, mask):
    fm, v, tm, xs, rng = _three_mod_pair("CheapXAttn3", sync, seed=SEED + 11)
    _compare(fm, v, tm, xs, rng, j_kw=dict(mask=jnp.asarray(mask)),
             t_kw=dict(mask=torch.tensor(mask)))


@pytest.mark.parametrize("sync", [True, False])
@pytest.mark.parametrize("name", TWO_MOD)
def test_two_mod_fusion_matches_flax(name, sync):
    rng = np.random.default_rng(SEED + TWO_MOD.index(name))
    xs = [rng.normal(size=(4, 101, 21)).astype(np.float32),
          rng.normal(size=(4, 426, 6)).astype(np.float32)]
    fm = JF.TWO_MOD_FUSIONS[name](synchronized_loading=sync, **TWO_MOD_KW)
    v = _perturbed_init(fm, xs, rng)
    tm = load_flax_params(
        TF.TWO_MOD_FUSIONS[name](synchronized_loading=sync, **TWO_MOD_KW, **TWO_MOD_IN), v)
    _compare(fm, v, tm, xs, rng)


def test_sensor_encoder_pools_only_at_sensor_length():
    """A stream of another length than sensor_length is not pooled, as in
    the reference; the 2-mod early fusion then needs it at pose length."""
    rng = np.random.default_rng(SEED + 3)
    xs = [rng.normal(size=(2, 101, 21)).astype(np.float32),
          rng.normal(size=(2, 101, 6)).astype(np.float32)]
    fm = JF.EarlyFusionModel(synchronized_loading=True, **TWO_MOD_KW)
    v = _perturbed_init(fm, xs, rng)
    tm = load_flax_params(TF.EarlyFusionModel(synchronized_loading=True, **TWO_MOD_KW,
                                              **TWO_MOD_IN), v)
    _compare(fm, v, tm, xs, rng)


@pytest.mark.parametrize("cls", ["LateFusionModel", "CheapXAttnModel"])
def test_shared_backbone_two_mod_models_need_equal_widths(cls):
    kw = dict(TWO_MOD_KW, sensor_out_channels=8)
    with pytest.raises(ValueError, match="equal feature dims"):
        getattr(TF, cls)(**kw, **TWO_MOD_IN)


@pytest.mark.parametrize("name", THREE_MOD)
def test_parameter_count_and_seeded_init(name):
    xs = [jnp.ones((1, 64, c)) for c in (2, 13, 24)]
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves(
        getattr(JF, name)().init(jax.random.PRNGKey(0), *xs)))
    a = getattr(TF, name)(generator=torch.Generator().manual_seed(3))
    b = getattr(TF, name)(generator=torch.Generator().manual_seed(3))
    assert sum(p.numel() for p in a.parameters()) == n_flax
    for pa, pb in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
