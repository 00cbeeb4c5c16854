"""The FBG/FoG SOTA baselines and the baseline drivers' optimizers against
gaitpd on the CPU.

Models: gaitpd_torch.models.baselines' DeepAVLite, FOCALSharedLatent and
TACAWrapper against gaitpd.models.baselines', sync and async, at the FBG
and FoG input widths and the drivers' sensor lengths (FoG 426, FBG 65),
from one set of flax parameters: the port's init in flax's layout
(gaitpd_torch.params.export_flax_params, its tree held equal to the tree
gaitpd's init makes) with seeded noise added, so no zero-initialised leaf
stays 0, loaded into the port by load_flax_params. Forward
outputs at train=False within 1e-5; the gradient of a weighted sum of the
outputs within rtol 1e-4 and atol 1e-5 of the leaf's largest value
(floored at 1), as tests/test_torch_fbg_fog_models.py holds the FBG/FoG
models (f32 on both sides; only the order of summation differs), and every
leaf also within that tolerance of gaitpd's exact gradient: gaitpd's
value_and_grad of the same parameters and inputs in f64 (jax.enable_x64).
A leaf whose gaitpd f32 gradient lies outside the tolerance of gaitpd's own
f64 one is held to the f64 one alone, and such leaves are named
(GAITPD_ROUNDING): FBG's skeleton encoder in FOCAL's async case, whose
LayerNorm over 3 features a frame makes its input layer's gradient a sum of
cancelling terms (gaitpd's f32 lies 3.4e-5 from its f64 value there, the
port's 1.3e-6; largest entry 0.24). A leaf the port's forward does not
reach (DeepAV-Lite's async fusion stack) has gradient 0, as gaitpd's.

Optimizers: one and two steps of gaitpd_torch.train.optim's adam_torch and
adamw_torch (+ the global-norm clip) from equal parameters and gradients
against gaitpd.train.optim's optax chains, with the gradient's global norm
above the clip and below it. The port's bias corrections are double on the
host, optax's f32 on the device, and the port divides sqrt(v) by
sqrt(1 - b2^t) where optax takes sqrt(v / (1 - b2^t)): the parameters agree
within two f32 ulps of the largest, 2.4e-7 of it (the update is lr = 1e-3
times a ratio of order 1 whose last bits differ, and the sum rounds to one
ulp or the other), the moments within 1e-6 relative.
"""


import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from gaitpd.config import FBG_FOG_DIMS  # noqa: E402
from gaitpd.models import baselines as JB  # noqa: E402
from gaitpd.train import optim as JO  # noqa: E402
from gaitpd_torch.models import baselines as TB  # noqa: E402
from gaitpd_torch.models.blocks import flatten_features  # noqa: E402
from gaitpd_torch.params import export_flax_params, load_flax_params  # noqa: E402
from gaitpd_torch.train import optim as TO  # noqa: E402
from gaitpd_torch.train.step import (  # noqa: E402
    StepSettings,
    TrainState,
    make_loss_ctx,
    make_train_step,
)

LOGIT_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
PARAM_TOL, MOMENT_RTOL = 2.4e-7, 1e-6
BATCH = 3
SENSOR_LENGTH = {"fog": 426, "fbg": 65}  # the SOTA drivers' (baseline_drivers._hp)


def _models(kind, dataset, sync):
    """(flax model, port model, whether the inputs are flattened, extra
    forward arguments) of one case, at the drivers' settings."""
    d = FBG_FOG_DIMS[dataset]
    t_sens = SENSOR_LENGTH[dataset]
    if kind == "deepav":
        return (JB.DeepAVLite(num_classes=d.num_classes, synchronized=sync),
                TB.DeepAVLite(d.skeleton_input_dim, d.sensor_in_channels,
                              num_classes=d.num_classes, synchronized=sync),
                False, {"train": False})
    if kind == "focal":
        common = dict(pose_length=d.pose_length, d_shared=16, d_private=8,
                      shared_out_channels=4, backbone_dim=4, num_classes=d.num_classes,
                      synchronized=sync)
        return (JB.FOCALSharedLatent(d.skeleton_output_dim, d.sensor_out_channels, t_sens,
                                     **common),
                TB.FOCALSharedLatent(d.skeleton_output_dim, d.sensor_out_channels, t_sens,
                                     skeleton_input_dim=d.skeleton_input_dim,
                                     sensor_in_channels=d.sensor_in_channels, **common),
                False, {})
    # TACA at the driver's defaults; the epoch schedule at an f32 epoch fraction
    kw = dict(skel_t=d.pose_length, skel_d=d.skeleton_input_dim, sens_t=t_sens,
              sens_d=d.sensor_in_channels, num_classes=d.num_classes, schedule="epoch",
              synchronized=sync)
    frac = np.float32(1) / np.float32(3)
    return (JB.TACAWrapper(**kw), TB.TACAWrapper(**kw), True,
            {"train": False, "epoch_frac": frac})


def _inputs(dataset, flat, seed=0):
    d = FBG_FOG_DIMS[dataset]
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(BATCH, d.pose_length, d.skeleton_input_dim)),
          rng.normal(size=(BATCH, SENSOR_LENGTH[dataset], d.sensor_in_channels))]
    xs = [x.astype(np.float32) for x in xs]
    return [x.reshape(BATCH, -1) for x in xs] if flat else xs


CASES = [(k, ds, s) for k in ("deepav", "focal", "taca") for ds in ("fbg", "fog")
         for s in (False, True)]


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}-{'sync' if c[2] else 'async'}")
def test_forward_and_gradients_match_gaitpd(case):
    kind, dataset, sync = case
    fm, tm, flat, kw = _models(kind, dataset, sync)
    xs = _inputs(dataset, flat)
    rng = np.random.default_rng(1)
    # the port's tree is flax's, leaf by leaf and shape by shape
    shapes = flatten_dict(jax.eval_shape(fm.init, jax.random.PRNGKey(1),
                                         *map(jnp.asarray, xs)))
    params = jax.tree_util.tree_map(
        lambda a: a + (rng.normal(size=a.shape) * 0.1).astype(np.float32),
        export_flax_params(tm))
    assert {k: v.shape for k, v in shapes.items()} == {
        k: v.shape for k, v in flatten_dict(params).items()}
    load_flax_params(tm, params)
    n_out = 1 if sync else 2
    coef = rng.normal(size=(n_out, BATCH, 3)).astype(np.float32)
    j_out, j_grads = _gaitpd_grads(fm, params, xs, kw, coef, jnp.float32)
    with jax.enable_x64(True):
        _, exact = _gaitpd_grads(fm, params, xs, kw, coef, jnp.float64)
    t_out, grads = _port_grads(tm, xs, kw, coef)
    assert len(t_out) == len(j_out) == n_out
    for t, j in zip(t_out, j_out):
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=LOGIT_TOL)
    got = flatten_dict(grads)
    assert set(got) == set(j_grads) == set(exact)
    assert {v.dtype for v in exact.values()} == {np.dtype(np.float64)}
    off = set()
    for key, w in j_grads.items():
        tol = dict(rtol=GRAD_RTOL, atol=GRAD_ATOL * max(1.0, float(np.abs(w).max())),
                   err_msg="/".join(key))
        np.testing.assert_allclose(got[key], exact[key], **tol)
        if np.allclose(w, exact[key], rtol=tol["rtol"], atol=tol["atol"]):
            np.testing.assert_allclose(got[key], w, **tol)
        else:
            off.add("/".join(key[1:]))
    assert off == GAITPD_ROUNDING.get(case, set())


# the leaves whose gaitpd f32 gradient lies outside the tolerance of its
# own f64 gradient, by case
GAITPD_ROUNDING = {("focal", "fbg", False): {"skel_enc/TorchLinear_0/Dense_0/bias",
                                             "skel_enc/TorchLinear_0/Dense_0/kernel"}}


def _gaitpd_grads(fm, params, xs, kw, coef, dtype):
    """gaitpd's outputs and its gradient of sum(outputs * coef), parameters,
    inputs and coefficients cast to ``dtype`` (f64 only under
    jax.enable_x64), as numpy arrays by flax leaf path."""
    j_kw = {k: (jnp.asarray(v, dtype) if k == "epoch_frac" else v) for k, v in kw.items()}
    c = jnp.asarray(coef, dtype)

    def objective(p):
        out = fm.apply(p, *(jnp.asarray(x, dtype) for x in xs), **j_kw)
        out = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o * c[i]) for i, o in enumerate(out)), out

    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)
    (_, out), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(p)
    return ([np.asarray(o) for o in out],
            {k: np.asarray(v) for k, v in flatten_dict(grads).items()})


def _port_grads(tm, xs, kw, coef):
    """The port's outputs and its gradient of sum(outputs * coef), by flax
    leaf path (a parameter the forward does not reach has gradient 0)."""
    out = tm(*(torch.from_numpy(x) for x in xs), **kw)
    out = out if isinstance(out, tuple) else (out,)
    objective = sum((o * torch.from_numpy(coef[i])).sum() for i, o in enumerate(out))
    named = list(tm.named_parameters())
    grads = torch.autograd.grad(objective, [p for _, p in named], allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for (_, p), g in zip(named, grads)]
    return ([o.detach() for o in out],
            export_flax_params(tm, {n: g for (n, _), g in zip(named, grads)}))


@pytest.mark.parametrize("sync", [False, True], ids=["async", "sync"])
def test_deepav_lite_tree(sync):
    """The flax tree the loader must fill: one block shared by both
    modalities (blk_shared_0), one aggregation query a modality, and
    fusion tokens with a CLS row and its type embedding only when synced."""
    _, tm, _, _ = _models("deepav", "fog", sync)
    names = dict(tm.named_parameters())
    assert "core.blk_shared_0.Attn_0.q.weight" in names
    assert not any(n.startswith("core.blk_skel") for n in names)
    assert names["core.Attn_0.q.weight".replace("Attn_0", "blk_shared_0.Attn_0")].shape == (8, 12)
    assert names["core.agg_q_skel"].shape == (1, 12)
    assert names["core.fus_tok"].shape == ((2, 12) if sync else (1, 12))
    assert ("core.type_cls" in names) == sync
    assert ("core.head_joint.weight" in names) == sync


def test_focal_async_is_one_backbone_launch(monkeypatch):
    """Both async streams go through the backbone in one call, and each
    stream's result equals the backbone run on that stream alone."""
    _, tm, _, _ = _models("focal", "fog", False)
    calls = []
    forward = type(tm.backbone).forward

    def counted(self, x):
        calls.append(x.shape[0])
        return forward(self, x)

    monkeypatch.setattr(type(tm.backbone), "forward", counted)
    xs = [torch.from_numpy(x) for x in _inputs("fog", False)]
    with torch.no_grad():
        y_s, y_m = tm(*xs)
        s, m = tm.skel_enc(xs[0]), tm.sens_enc(xs[1])
        alone = tm.head_skel(flatten_features(tm.backbone(torch.cat(
            [tm.sk_sh(s), tm.sk_pr(s), torch.zeros_like(tm.im_pr(m))], dim=-1))))
    assert calls[0] == 2 * BATCH
    np.testing.assert_allclose(y_s.numpy(), alone.numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def _leaves(seed, scale):
    rng = np.random.default_rng(seed)
    params = {"a": rng.normal(size=(7, 5)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * scale).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    return params, grads


OPTIMIZERS = {
    "adam": (lambda: JO.adam_torch(1e-3), lambda ps: TO.adam_torch(ps, 1e-3)),
    "adam_clip": (lambda: JO.adam_torch(1e-3, grad_clip=1.0),
                  lambda ps: TO.adam_torch(ps, 1e-3, grad_clip=1.0)),
    "adamw_clip": (lambda: JO.adamw_torch(1e-3, weight_decay=1e-4, grad_clip=1.0),
                   lambda ps: TO.adamw_torch(ps, 1e-3, weight_decay=1e-4, grad_clip=1.0)),
}


@pytest.mark.parametrize("scale", [3.0, 0.05], ids=["norm_above_clip", "norm_below_clip"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_optax(name, scale):
    make_tx, make_port = OPTIMIZERS[name]
    params, grads = _leaves(0, scale)
    tx = make_tx()
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = tx.init(j_params)
    t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_port(list(t_params.values()))
    for g in grads:
        updates, j_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k, p in t_params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        scale_p = max(float(np.abs(np.asarray(v)).max()) for v in j_params.values())
        for k, p in t_params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_params[k]), rtol=0,
                                       atol=PARAM_TOL * scale_p, err_msg=k)
    adam = next(s for s in jax.tree_util.tree_leaves(
        j_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))
    assert int(adam.count) == 2
    for k, p in t_params.items():
        st = opt.state[p]
        assert float(st["step"]) == 2
        np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(adam.mu[k]),
                                   rtol=MOMENT_RTOL, atol=0)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(adam.nu[k]),
                                   rtol=MOMENT_RTOL, atol=0)


def test_clip_is_optax_law():
    """At or above the bound each leaf becomes (g / ‖g‖) * bound, below it
    the gradient is unchanged: not torch's clip_grad_norm_ (max / (‖g‖ +
    1e-6))."""
    params, (g, _) = _leaves(1, 3.0)
    clip = optax.clip_by_global_norm(1.0)
    want, _ = clip.update({k: jnp.asarray(v) for k, v in g.items()}, clip.init(None))
    got = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    TO.clip_by_global_norm_(got.values(), 1.0)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-7, atol=0)
    small = {k: torch.from_numpy(v * 1e-3) for k, v in g.items()}
    kept = {k: v.clone() for k, v in small.items()}
    TO.clip_by_global_norm_(small.values(), 1.0)
    assert all(torch.equal(small[k], kept[k]) for k in g)


def test_padded_batch_keeps_adam_step_count():
    """A fully padded batch changes neither the parameters nor Adam's step
    count, as gaitpd's jnp.where keeps opt_state (gaitpd/train/step.py:
    308-322)."""
    model = torch.nn.Linear(4, 3)
    opt = TO.adamw_torch(model.parameters(), 1e-3, weight_decay=1e-4, grad_clip=1.0)
    settings = StepSettings(n_streams=1, wm="ce")
    step = make_train_step(settings)
    state = TrainState(module=model, optimizer=opt, mtl_state={})
    ctx = make_loss_ctx(settings, [[2, 2, 1]])
    x = torch.randn(5, 4, generator=torch.Generator().manual_seed(0))
    batch = {"xs": (x,), "ys": (torch.tensor([0, 1, 2, 0, 1]),),
             "valid": torch.ones(5), "n_valid": 5}
    step(state, batch, None, ctx)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step(state, dict(batch, valid=torch.zeros(5), n_valid=0), None, ctx)
    assert all(float(opt.state[p]["step"]) == 1 for p in model.parameters())
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
