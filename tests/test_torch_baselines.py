"""gaitpd_torch.models.baselines against gaitpd.models.baselines: DeepAV-Lite,
FOCAL and TACA for the 3-modality stack, sync and async, from one set of
flax parameters copied by gaitpd_torch.params. Forward outputs at
train=False, and the gradient of every parameter for the same cotangents.
Then the init laws and dropout, by statistics: dropout masks cannot match
JAX's PRNG.

Tolerances: forwards within 1e-5 absolute plus 1e-5 relative, gradients
within 1e-5 absolute plus 1e-4 relative, those of tests/test_torch_fusion.py
(f32 on both sides; only the order of summation differs). A parameter the
port's forward does not reach (the async DeepAV fusion stack, TACA's unused
fuser and directions) has gradient zero, as gaitpd's.

The gradients are compared element by element at narrow widths
(``SMALL``). At the defaults (DeepAV embed 96, depth 3; TACA d_model 128)
the largest gradients reach the tens and the f32 sums round apart by up to
2e-4 in absolute terms, far above 1e-4 of a gradient entry near 0: there
each leaf's gradients are held within 1e-4 of that leaf's largest gradient
(``LEAF_GRAD_RTOL``). The worst reading at the defaults (DeepAV sync,
largest gradient 89) is 1.8e-5 of the leaf's largest gradient between the
packages, with the port 1.3e-5 and gaitpd 0.6e-5 from the port's f64
evaluation of the same parameters. The forwards are compared at the
defaults too.
"""

import copy
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaitpd.models import baselines as JB  # noqa: E402
from gaitpd.models.encoders import GELUBackbone as FlaxGELUBackbone  # noqa: E402
from gaitpd_torch.models import baselines as TB  # noqa: E402
from gaitpd_torch.models.blocks import TRUNCATED_NORMAL_STD, dropout, normal_param  # noqa: E402
from gaitpd_torch.models.encoders import GELUBackbone  # noqa: E402
from gaitpd_torch.params import export_flax_params, load_flax_params  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LEAF_GRAD_RTOL = 1e-4  # of each leaf's largest gradient, at the default widths
SEED = 40
WIN = 64

# name -> (flax module, port module, flat inputs, flax leaves sync/async)
MODELS = {
    "deepav_lite": (lambda sync, **kw: JB.DeepAVLite3(num_classes=2, synchronized=sync, **kw),
                    lambda sync, **kw: TB.DeepAVLite3(num_classes=2, synchronized=sync, **kw),
                    False, (152, 156)),
    "focal": (lambda sync, **kw: JB.FOCALSharedLatent3(num_classes=2, synchronized=sync, **kw),
              lambda sync, **kw: TB.FOCALSharedLatent3(num_classes=2, synchronized=sync, **kw),
              False, (16, 20)),
    "taca": (lambda sync, **kw: JB.TACA3TriWrapper(win_len=WIN, num_classes=2,
                                                   synchronized=sync, **kw),
             lambda sync, **kw: TB.TACA3TriWrapper(win_len=WIN, num_classes=2,
                                                   synchronized=sync, **kw),
             True, (29, 33)),
}


# narrow widths for the gradient comparisons: a few layers, narrow heads
# (FOCAL keeps its 320-channel backbone, the point of its port)
SMALL = {"deepav_lite": dict(embed_dim=24, depth=2, heads=3), "focal": {},
         "taca": dict(d_model=32, n_heads=4)}


def _inputs(rng, flat, bsz=5):
    xs = [rng.normal(size=(bsz, WIN, c)).astype(np.float32) for c in (2, 13, 24)]
    return [x.reshape(bsz, -1) for x in xs] if flat else xs


def _pair(name, sync, seed, **kw):
    """gaitpd's module with seeded noise added to its init (so no bias or
    zero-initialised parameter stays 0), and the port's with those
    parameters loaded."""
    make_flax, make_port, flat, _ = MODELS[name]
    rng = np.random.default_rng(seed)
    xs = _inputs(rng, flat)
    fm = make_flax(sync, **kw)
    v = fm.init(jax.random.PRNGKey(0), *map(jnp.asarray, xs))
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.normal(size=a.shape) * 0.1).astype(np.float32), v)
    tm = load_flax_params(make_port(sync, generator=torch.Generator().manual_seed(1), **kw), v)
    return fm, v, tm, xs, rng


def _eval_kw(name):
    return {} if name == "focal" else {"train": False}


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(a)
            for k, a in jax.tree_util.tree_leaves_with_path(tree)}


def _flax_grads(name, fm, v, xs, cots):
    """gaitpd's gradient of sum(outputs * cots), by leaf path."""
    jx = [jnp.asarray(x) for x in xs]

    def j_loss(params):
        outs = fm.apply({"params": params}, *jx, **_eval_kw(name))
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))

    return _flat(jax.grad(j_loss)(v["params"]))


def _port_grads(name, tm, xs, cots, dtype=torch.float32):
    """The port's gradient of sum(outputs * cots) in ``dtype``, by flax leaf
    path (a parameter the forward does not reach has gradient 0)."""
    tm = copy.deepcopy(tm).to(dtype)
    outs = tm(*(torch.from_numpy(x).to(dtype) for x in xs), **_eval_kw(name))
    loss = sum((o * torch.from_numpy(c).to(dtype)).sum() for o, c in zip(outs, cots))
    named = list(tm.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for (_, p), g in zip(named, grads)]
    return _flat(export_flax_params(tm, {n: g for (n, _), g in zip(named, grads)})["params"])


def _compare(name, fm, v, tm, xs, rng, per_leaf=False):
    """Forward outputs, then every parameter's gradient: within GRAD_TOL,
    or with ``per_leaf`` within LEAF_GRAD_RTOL of the leaf's largest
    gradient (plus GRAD_TOL's atol, for a leaf whose gradient is 0)."""
    kw = _eval_kw(name)
    ref = fm.apply(v, *map(jnp.asarray, xs), **kw)
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, xs), **kw)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    cots = [rng.normal(size=r.shape).astype(np.float32) for r in ref]
    want = _flax_grads(name, fm, v, xs, cots)
    flat_got = _port_grads(name, tm, xs, cots)
    assert set(flat_got) == set(want)
    for path, w in want.items():
        tol = (dict(rtol=0.0, atol=LEAF_GRAD_RTOL * np.abs(w).max() + GRAD_TOL["atol"])
               if per_leaf else GRAD_TOL)
        np.testing.assert_allclose(flat_got[path], w, **tol, err_msg=path)


@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_baseline_matches_flax(name, sync):
    fm, v, tm, xs, rng = _pair(name, sync, SEED + sorted(MODELS).index(name), **SMALL[name])
    _compare(name, fm, v, tm, xs, rng)


@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_baseline_forward_matches_flax_at_default_widths(name, sync):
    fm, v, tm, xs, _ = _pair(name, sync, SEED + 10 + sorted(MODELS).index(name))
    kw = _eval_kw(name)
    ref = fm.apply(v, *map(jnp.asarray, xs), **kw)
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, xs), **kw)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
@pytest.mark.parametrize("name", ["deepav_lite", "taca"])
def test_baseline_grads_match_flax_at_default_widths(name, sync):
    """The widths that train (FOCAL's gradients are compared at its defaults
    above): every leaf's gradient against gaitpd, per leaf."""
    fm, v, tm, xs, rng = _pair(name, sync, SEED + 20 + sorted(MODELS).index(name))
    _compare(name, fm, v, tm, xs, rng, per_leaf=True)


@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
def test_deepav_torch_init_matches_flax(sync):
    fm, v, tm, xs, rng = _pair("deepav_lite", sync, SEED + 5, torch_init=True,
                               **SMALL["deepav_lite"])
    _compare("deepav_lite", fm, v, tm, xs, rng)


@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
def test_taca_without_async_cross_matches_flax(sync):
    fm, v, tm, xs, rng = _pair("taca", sync, SEED + 6, allow_async_cross=False,
                               **SMALL["taca"])
    _compare("taca", fm, v, tm, xs, rng)


@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_loader_takes_every_leaf(name, sync):
    """gaitpd's tree has exactly the port's parameters, no leaf missing or
    extra: 152/156 (sync/async) for DeepAV-Lite, 16/20 for FOCAL, 29/33 for
    TACA."""
    make_flax, make_port, flat, counts = MODELS[name]
    xs = _inputs(np.random.default_rng(0), flat, bsz=1)
    v = make_flax(sync).init(jax.random.PRNGKey(0), *map(jnp.asarray, xs))
    n_flax = len(jax.tree_util.tree_leaves(v["params"]))
    tm = make_port(sync)
    assert n_flax == len(list(tm.parameters())) == counts[0 if sync else 1]
    load_flax_params(tm, v)  # raises on a missing or extra leaf
    n_values = sum(a.size for a in jax.tree_util.tree_leaves(v["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_values


@pytest.mark.parametrize("name", sorted(MODELS))
def test_seeded_init_is_reproducible(name):
    make_port = MODELS[name][1]
    a = make_port(True, generator=torch.Generator().manual_seed(3))
    b = make_port(True, generator=torch.Generator().manual_seed(3))
    c = make_port(True, generator=torch.Generator().manual_seed(4))
    for pa, pb in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    assert any(not torch.equal(pa, pc) for pa, pc in zip(a.parameters(), c.parameters()))


def test_focal_gelu_backbone_matches_flax_at_320_channels():
    """FOCAL's backbone alone: Conv1d(k3) over 320 channels, exact GELU and
    the pool, against gaitpd's GELUBackbone."""
    rng = np.random.default_rng(SEED + 7)
    x = rng.normal(size=(4, WIN, 320)).astype(np.float32)
    fm = FlaxGELUBackbone(16, 8)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.normal(size=a.shape) * 0.01).astype(np.float32),
        fm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tm = load_flax_params(GELUBackbone(320, 16, 8, generator=torch.Generator()), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(fm.apply(v, jnp.asarray(x))), **TOL)


# ---------------------------------------------------------------------------
# init laws, by statistics
# ---------------------------------------------------------------------------


def test_patch_embed_default_law():
    """Zero bias exactly; the kernel flax's lecun_normal: standard deviation
    1/sqrt(patch * C_in), truncated at two standard deviations of the
    untruncated normal."""
    pe = TB.PatchEmbed1D(24, 512, 8, 8, generator=torch.Generator().manual_seed(0))
    assert torch.equal(pe.bias, torch.zeros(512))
    w = pe.weight.detach().double()
    std = 1.0 / math.sqrt(8 * 24)
    n = w.numel()  # 98304 draws: the sample std is within 1 % at 3 sigma
    assert abs(w.std().item() / std - 1.0) < 0.01
    assert abs(w.mean().item()) < 4 * std / math.sqrt(n)
    assert w.abs().max().item() <= 2.0 * std / TRUNCATED_NORMAL_STD


def test_patch_embed_torch_law():
    pe = TB.PatchEmbed1D(24, 512, 8, 8, torch_init=True,
                         generator=torch.Generator().manual_seed(0))
    bound = 1.0 / math.sqrt(8 * 24)
    for p in (pe.weight, pe.bias):
        assert p.abs().max().item() <= bound
    # U(-b, b) has standard deviation b / sqrt(3)
    assert abs(pe.weight.detach().double().std().item() / (bound / math.sqrt(3)) - 1) < 0.01
    assert pe.bias.abs().max().item() > 0.5 * bound


def test_normal_002_law():
    p = normal_param((400, 250), 0.02, torch.Generator().manual_seed(0)).detach().double()
    assert abs(p.std().item() / 0.02 - 1.0) < 0.01
    assert abs(p.mean().item()) < 4 * 0.02 / math.sqrt(p.numel())


def test_deepav_tokens_and_queries_are_normal_002():
    """type/agg_q/fus_tok/type_cls of DeepAV-Lite draw from normal(0.02)."""
    core = TB.DeepAVLite3(num_classes=2, generator=torch.Generator().manual_seed(0)).core
    vals = torch.cat([p.detach().flatten() for n, p in core.named_parameters()
                      if n.startswith(("type_", "agg_q_", "fus_tok"))]).double()
    assert vals.numel() == 3 * 96 + 96 + 3 * 4 * 96 + 5 * 96
    assert abs(vals.std().item() / 0.02 - 1.0) < 0.1  # 2016 draws: 3 sigma is 4.7 %


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


def test_dropout_keep_rate_and_scale():
    x = torch.randn(1_000_000, generator=torch.Generator().manual_seed(1)) + 3.0
    before = torch.get_rng_state()
    y = dropout(x, 0.1, torch.Generator().manual_seed(2), train=True)
    assert torch.equal(torch.get_rng_state(), before)  # the global generator is untouched
    kept = y != 0
    n = x.numel()
    sigma = math.sqrt(n * 0.9 * 0.1)
    assert abs(kept.sum().item() - 0.9 * n) <= 5 * sigma
    torch.testing.assert_close(y[kept], x[kept] / torch.tensor(0.9), rtol=0, atol=0)


def test_dropout_is_the_identity_at_eval_and_rate_zero():
    x = torch.randn(64, 8)
    assert dropout(x, 0.5, None, train=False) is x
    assert dropout(x, 0.0, None, train=True) is x
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.5, None, train=True)


@pytest.mark.parametrize("name", ["deepav_lite", "taca"])
def test_model_dropout_follows_its_generator(name):
    """Train mode with dropout draws only from the generator it is given:
    one seed gives one output, another seed another; eval mode is the
    dropout-free forward."""
    make_port, flat = MODELS[name][1], MODELS[name][2]
    xs = [torch.from_numpy(x) for x in _inputs(np.random.default_rng(0), flat)]
    model = make_port(True, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = model(*xs, train=True, generator=torch.Generator().manual_seed(5))[0]
        b = model(*xs, train=True, generator=torch.Generator().manual_seed(5))[0]
        c = model(*xs, train=True, generator=torch.Generator().manual_seed(6))[0]
        plain = model(*xs, train=False)[0]
        no_drop = make_port(True, generator=torch.Generator().manual_seed(0), drop=0.0)
        want = no_drop(*xs, train=True, generator=torch.Generator().manual_seed(5))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(plain, want)


def _leaf_gap(a, b):
    """The largest gap between two gradient trees, as a share of the leaf's
    largest gradient in ``b``."""
    return max(float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max())
               for k in b if np.abs(b[k]).max() > 0)


if __name__ == "__main__":
    # The readings behind LEAF_GRAD_RTOL: at the default widths, each
    # package's f32 gradients against the port's f64 evaluation of the same
    # parameters, as shares of each leaf's largest gradient
    # (JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_baselines.py).
    for model in ("deepav_lite", "taca"):
        for is_sync in (True, False):
            fm_, v_, tm_, xs_, rng_ = _pair(model, is_sync,
                                           SEED + 20 + sorted(MODELS).index(model))
            ref_ = fm_.apply(v_, *map(jnp.asarray, xs_), **_eval_kw(model))
            cots_ = [rng_.normal(size=r.shape).astype(np.float32) for r in ref_]
            flax32 = _flax_grads(model, fm_, v_, xs_, cots_)
            port32 = _port_grads(model, tm_, xs_, cots_)
            port64 = _port_grads(model, tm_, xs_, cots_, torch.float64)
            top = max(float(np.abs(g).max()) for g in port64.values())
            print(f"{model} {'sync' if is_sync else 'async'}: largest gradient {top:.3g}; "
                  f"port f32 vs gaitpd f32 {_leaf_gap(port32, flax32):.3e}, port f32 vs f64 "
                  f"{_leaf_gap(port32, port64):.3e}, gaitpd f32 vs f64 "
                  f"{_leaf_gap(flax32, port64):.3e} of the leaf's largest gradient")
