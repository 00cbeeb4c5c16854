"""gaitpd_torch.train.step and train.optim against gaitpd.train.step and
gaitpd.train.optim: CAGrad train steps from equal parameters and batches,
the fully padded batch, the DRW switch and the masked eval step for all 7
sensor subsets.

Tolerances, each relative to the largest leaf value (floored at 1): the
momentum buffers after one and three steps within 1e-5, the gradients'
own tolerance (test_torch_mtl: the two CAGrad solvers' weights agree only
to the flatness of their objective); the parameters within 1e-6, since SGD
at lr 1e-3 scales those differences down. Losses within 1e-5 relative; eval
predictions and counts exactly (the inputs keep the logits far from ties).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from gaitpd.learning import mtl as JM  # noqa: E402
from gaitpd.models.multitask import WearGaitThreeModal as FlaxModel  # noqa: E402
from gaitpd.train import optim as JO  # noqa: E402
from gaitpd.train import step as JS  # noqa: E402
from gaitpd.train.weargait_driver import MASK_COMBOS  # noqa: E402
from gaitpd_torch.learning import mtl as TM  # noqa: E402
from gaitpd_torch.models.multitask import WearGaitThreeModal  # noqa: E402
from gaitpd_torch.params import export_flax_params, load_flax_params  # noqa: E402
from gaitpd_torch.train import optim as TO  # noqa: E402
from gaitpd_torch.train import step as TS  # noqa: E402

COUNTS = [[40, 25], [40, 25], [40, 25]]
LR = 1e-3


def _batches(seed, n, bsz=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        xs = [rng.normal(size=(bsz, 64, c)).astype(np.float32) for c in (2, 13, 24)]
        ys = [rng.integers(0, 2, size=bsz).astype(np.int32) for _ in range(3)]
        valid = np.ones(bsz, np.float32)
        valid[-2:] = 0.0
        out.append((xs, ys, valid))
    return out


def _j_batch(xs, ys, valid):
    return {"xs": tuple(map(jnp.asarray, xs)), "ys": tuple(map(jnp.asarray, ys)),
            "valid": jnp.asarray(valid)}


def _t_batch(xs, ys, valid):
    return {"xs": tuple(map(torch.from_numpy, xs)),
            "ys": tuple(torch.from_numpy(y.astype(np.int64)) for y in ys),
            "valid": torch.from_numpy(valid), "n_valid": int(valid.sum())}


def _pair(sync, seed=0, **settings_kw):
    rng = np.random.default_rng(seed)
    xs = [np.zeros((2, 64, c), np.float32) for c in (2, 13, 24)]
    fm = FlaxModel(synchronized=sync)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.normal(size=a.shape) * 0.1).astype(np.float32),
        fm.init(jax.random.PRNGKey(seed), *map(jnp.asarray, xs)),
    )
    tm = load_flax_params(WearGaitThreeModal(synchronized=sync), params)
    kw = dict(n_streams=3, wm="gcl", synchronized=sync, private_grads="sum_plus_own",
              **settings_kw)
    return fm, params, tm, JS.StepSettings(**kw), TS.StepSettings(**kw)


def _leaves(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree).items()}


def _assert_close(got, want, atol):
    """Per leaf within atol; atol is relative to the largest leaf value
    (floored at 1), as in test_torch_mtl."""
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w)
    atol = atol * max(max(np.abs(v).max() for v in w.values()), 1.0)
    for key in w:
        np.testing.assert_allclose(g[key], w[key], rtol=0, atol=atol, err_msg="/".join(key))


def _momentum(tm, optimizer):
    return export_flax_params(tm, {n: optimizer.state[p]["momentum_buffer"]
                                   for n, p in tm.named_parameters()})


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("sync", [True, False])
def test_cagrad_steps_leave_equal_params_and_momentum(sync, n_steps):
    fm, params, tm, js, ts = _pair(sync)
    tx = JO.sgd_torch(LR, 0.9, 1e-4)
    bound = fm.bind(params)
    jp = JM.build_flat_partition(params, bound.shared_modules, bound.task_modules)
    train_apply, _ = JS.make_apply_adapters(fm.apply, js)
    j_step = jax.jit(JS.make_train_step(train_apply, tx, js, JM.make_method("cagrad", 3, c=0.5),
                                        jp))
    j_state = JS.TrainState(params=params, opt_state=tx.init(params), mtl_state={},
                            epoch=jnp.asarray(0, jnp.int32))
    j_ctx = JS.make_loss_ctx(js, COUNTS)

    t_state = TS.TrainState(module=tm, optimizer=TO.sgd_torch(tm.parameters(), LR, 0.9, 1e-4),
                            mtl_state={})
    t_step = TS.make_train_step(ts, TM.make_method("cagrad", 3, c=0.5),
                                TM.build_flat_partition(tm, tm.shared_modules, tm.task_modules))
    t_ctx = TS.make_loss_ctx(ts, COUNTS)
    for b in _batches(n_steps, n_steps):
        j_state, j_m = j_step(j_state, _j_batch(*b), jax.random.PRNGKey(0), j_ctx)
        t_state, t_m = t_step(t_state, _t_batch(*b), None, t_ctx)
        np.testing.assert_allclose(t_m["losses"].numpy(), np.asarray(j_m["losses"]), rtol=1e-5)
        np.testing.assert_array_equal(t_m["correct"].numpy(), np.asarray(j_m["correct"]))
        assert t_m["n"].item() == float(j_m["n"])
    _assert_close(export_flax_params(tm), j_state.params, atol=1e-6)
    _assert_close(_momentum(tm, t_state.optimizer), j_state.opt_state[1].trace, atol=1e-5)


def test_fully_padded_batch_is_a_no_op():
    _, _, tm, _, ts = _pair(True)
    state = TS.TrainState(module=tm, optimizer=TO.sgd_torch(tm.parameters(), LR), mtl_state={})
    step = TS.make_train_step(ts, TM.make_method("cagrad", 3, c=0.5),
                              TM.build_flat_partition(tm, tm.shared_modules, tm.task_modules))
    ctx = TS.make_loss_ctx(ts, COUNTS)
    real, = _batches(0, 1)
    state, _ = step(state, _t_batch(*real), None, ctx)  # momentum now non-zero
    before = (export_flax_params(tm), _momentum(tm, state.optimizer))
    xs, ys, valid = real
    state, m = step(state, _t_batch(xs, ys, np.zeros_like(valid)), None, ctx)
    assert m["n"].item() == 0 and m["losses"].abs().sum().item() == 0
    _assert_close(export_flax_params(tm), before[0], atol=0)
    _assert_close(_momentum(tm, state.optimizer), before[1], atol=0)


def test_sgd_first_momentum_is_the_decayed_gradient():
    p = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    opt = TO.sgd_torch([p], lr=0.1, momentum=0.9, weight_decay=1e-2)
    p.grad = torch.tensor([0.5, 0.25])
    opt.step()
    torch.testing.assert_close(opt.state[p]["momentum_buffer"],
                               torch.tensor([0.5 + 1e-2, 0.25 - 2e-2]))


@pytest.mark.parametrize("epoch", [0, 1, 2])
def test_drw_switch_at_warmup(epoch):
    fm, params, tm, js, ts = _pair(True, drw_warmup=1)
    xs, ys, valid = _batches(5, 1)[0]
    train_apply, _ = JS.make_apply_adapters(fm.apply, js)
    j_loss, _ = JS.make_multitask_loss_fn(train_apply, js)(
        params, *_j_batch(xs, ys, valid).values(), JS.make_loss_ctx(js, COUNTS),
        jax.random.PRNGKey(0), jnp.asarray(epoch))
    tb = _t_batch(xs, ys, valid)
    ctx = TS.make_loss_ctx(ts, COUNTS)
    with torch.no_grad():
        t_loss, _ = TS.make_multitask_loss_fn(ts)(tm, tb["xs"], tb["ys"], tb["valid"], ctx,
                                                  None, epoch)
        unweighted, _ = TS.make_multitask_loss_fn(ts)(tm, tb["xs"], tb["ys"], tb["valid"],
                                                      ctx, None, 0)
    np.testing.assert_allclose(t_loss.numpy(), np.asarray(j_loss), rtol=1e-5)
    resolved = TS._resolve_drw(ts, ctx, epoch)[0]["drw_w"]
    if epoch < 1:
        assert torch.equal(resolved, torch.ones(2))
    else:
        torch.testing.assert_close(resolved, ctx[0]["drw_base"], rtol=0, atol=0)
        assert not torch.allclose(t_loss, unweighted)


@pytest.mark.parametrize("sync", [True, False])
def test_eval_step_all_masks(sync):
    fm, params, tm, js, ts = _pair(sync, seed=4)
    xs, ys, valid = _batches(6, 1, bsz=16)[0]
    _, eval_apply = JS.make_apply_adapters(fm.apply, js)
    j_eval = jax.jit(JS.make_eval_step(eval_apply, js))
    t_eval = TS.make_eval_step(ts)
    j_ctx, t_ctx = JS.make_loss_ctx(js, COUNTS), TS.make_loss_ctx(ts, COUNTS)
    for name, mask in list(MASK_COMBOS.items()) + [("none", (False, False, False))]:
        ref = j_eval(params, _j_batch(xs, ys, valid), j_ctx, jax.random.PRNGKey(0),
                     jnp.asarray(0), jnp.asarray(mask))
        got = t_eval(tm, _t_batch(xs, ys, valid), t_ctx, None, 0, mask)
        np.testing.assert_allclose(got["losses"].numpy(), np.asarray(ref["losses"]), rtol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(got["logits"].numpy(), np.asarray(ref["logits"]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        for key in ("correct", "ens_correct", "n", "preds", "pred_ens"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                          err_msg=f"{name} {key}")


@pytest.mark.parametrize("option", [dict(remat="dots"), dict(remat="nothing")])
def test_unported_settings_raise(option):
    """Once refused (ROADMAP Queue 1, item 14), remat now runs: one CAGrad
    step under it leaves the parameters and momentum of the step without it,
    bitwise (tests/test_torch_remat.py holds it against gaitpd's)."""
    out = []
    for kw in (dict(), option):
        _, _, tm, _, ts = _pair(True, **kw)
        state = TS.TrainState(module=tm, optimizer=TO.sgd_torch(tm.parameters(), LR, 0.9, 1e-4),
                              mtl_state={})
        step = TS.make_train_step(ts, TM.make_method("cagrad", 3, c=0.5),
                                  TM.build_flat_partition(tm, tm.shared_modules, tm.task_modules))
        state, _ = step(state, _t_batch(*_batches(0, 1)[0]), None, TS.make_loss_ctx(ts, COUNTS))
        out.append((export_flax_params(tm), _momentum(tm, state.optimizer)))
    for got, want in zip(out[1], out[0]):
        _assert_close(got, want, atol=0)


# --- the two-stream consistency term (FBG/FoG, synchronized GCL) ----------

FOG_COUNTS = [[30, 20, 12], [30, 20, 12]]


def _fog_pair(sync, seed=0):
    """gaitpd's and the port's FoG MultiModalMultiTask from one flax init."""
    from gaitpd.config import FOG
    from gaitpd.models.multitask import MultiModalMultiTask as FlaxFoG
    from gaitpd_torch.models.multitask import MultiModalMultiTask

    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(6, 101, 21)).astype(np.float32),
          rng.normal(size=(6, 426, 6)).astype(np.float32)]
    ys = [rng.integers(0, 3, size=6).astype(np.int32)] * 2
    valid = np.ones(6, np.float32)
    valid[-1] = 0.0
    fm = FlaxFoG(skeleton_output_dim=6, sensor_out_channels=6, sensor_length=426,
                 use_norm=True, use_cosine=True, synchronized_loading=sync)
    params = fm.init(jax.random.PRNGKey(seed), *map(jnp.asarray, xs))
    tm = load_flax_params(MultiModalMultiTask(
        FOG.skeleton_input_dim, 6, FOG.sensor_in_channels, 6, 426, use_norm=True,
        use_cosine=True, synchronized_loading=sync), params)
    return fm, params, tm, (xs, ys, valid)


@pytest.mark.parametrize("lam", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
def test_consistency_term_losses_match_gaitpd(sync, lam):
    """In sync GCL mode each branch loss carries 0.5 * lam * the symmetric
    KL of the two heads; in async mode none does (gaitpd/train/
    step.py:233-243)."""
    fm, params, tm, (xs, ys, valid) = _fog_pair(sync)
    kw = dict(n_streams=2, wm="gcl", synchronized=sync, consistency_lambda=lam)
    js, ts = JS.StepSettings(**kw), TS.StepSettings(**kw)
    train_apply, _ = JS.make_apply_adapters(fm.apply, js)
    want, _ = JS.make_multitask_loss_fn(train_apply, js)(
        params, *_j_batch(xs, ys, valid).values(), JS.make_loss_ctx(js, FOG_COUNTS),
        jax.random.PRNGKey(0), jnp.asarray(0))
    tb = _t_batch(xs, ys, valid)
    with torch.no_grad():
        got, logits = TS.make_multitask_loss_fn(ts)(tm, tb["xs"], tb["ys"], tb["valid"],
                                                    TS.make_loss_ctx(ts, FOG_COUNTS), None, 0)
        plain, _ = TS.make_multitask_loss_fn(TS.StepSettings(**{**kw, "consistency_lambda": 0}))(
            tm, tb["xs"], tb["ys"], tb["valid"], TS.make_loss_ctx(ts, FOG_COUNTS), None, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    from gaitpd_torch.learning.losses import symmetric_kl_consistency

    with torch.no_grad():
        cons = symmetric_kl_consistency(logits[0], logits[1], tb["valid"])
    assert float(cons) > 0
    if sync and lam > 0:
        assert torch.equal(got, plain + 0.5 * lam * cons) and not torch.equal(got, plain)
    else:
        assert torch.equal(got, plain)


def test_consistency_cagrad_step_matches_gaitpd():
    """One CAGrad step at K = 2 (c 0.1, max_norm 1, private grads "sum") of
    the synchronized FoG model with the consistency term: the parameters
    within 1e-6 and the momentum within 1e-5 of the largest value, as the
    three-stream steps above."""
    fm, params, tm, (xs, ys, valid) = _fog_pair(True, seed=3)
    kw = dict(n_streams=2, wm="gcl", synchronized=True, consistency_lambda=1.0,
              private_grads="sum")
    js, ts = JS.StepSettings(**kw), TS.StepSettings(**kw)
    tx = JO.sgd_torch(LR, 0.9, 1e-4)
    bound = fm.bind(params)
    jp = JM.build_flat_partition(params, bound.shared_modules, bound.task_modules)
    train_apply, _ = JS.make_apply_adapters(fm.apply, js)
    j_step = jax.jit(JS.make_train_step(train_apply, tx, js,
                                        JM.make_method("cagrad", 2, c=0.1, max_norm=1.0), jp))
    j_state = JS.TrainState(params=params, opt_state=tx.init(params), mtl_state={},
                            epoch=jnp.asarray(0, jnp.int32))
    j_state, j_m = j_step(j_state, _j_batch(xs, ys, valid), jax.random.PRNGKey(0),
                          JS.make_loss_ctx(js, FOG_COUNTS))
    t_state = TS.TrainState(module=tm, optimizer=TO.sgd_torch(tm.parameters(), LR, 0.9, 1e-4),
                            mtl_state={})
    t_step = TS.make_train_step(ts, TM.make_method("cagrad", 2, c=0.1, max_norm=1.0),
                                TM.build_flat_partition(tm, tm.shared_modules, tm.task_modules))
    t_state, t_m = t_step(t_state, _t_batch(xs, ys, valid), None, TS.make_loss_ctx(ts, FOG_COUNTS))
    np.testing.assert_allclose(t_m["losses"].numpy(), np.asarray(j_m["losses"]), rtol=1e-5)
    np.testing.assert_array_equal(t_m["correct"].numpy(), np.asarray(j_m["correct"]))
    _assert_close(export_flax_params(tm), j_state.params, atol=1e-6)
    _assert_close(_momentum(tm, t_state.optimizer), j_state.opt_state[1].trace, atol=1e-5)


class _Recorder(torch.nn.Module):
    def forward(self, *xs, **kw):
        self.kw = kw
        return xs


@pytest.mark.parametrize("dropout", [False, True])
def test_apply_adapters_follow_the_dropout_setting(dropout):
    """With dropout the train forward gets train=True and the step's
    generator, the eval forward train=False (gaitpd/train/step.py:84-101);
    without, both call the module on the inputs alone."""
    train_apply, eval_apply = TS.make_apply_adapters(TS.StepSettings(n_streams=1,
                                                                     dropout=dropout))
    module, gen = _Recorder(), torch.Generator()
    train_apply(module, (torch.ones(1),), gen, 0)
    assert module.kw == ({"train": True, "generator": gen} if dropout else {})
    eval_apply(module, (torch.ones(1),), 0)
    assert module.kw == ({"train": False} if dropout else {})
