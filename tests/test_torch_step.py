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


@pytest.mark.parametrize("option", [
    dict(augment=(None, None, None)), dict(modality_dropout=0.1), dict(remat="dots"),
    dict(dropout=True), dict(consistency_lambda=0.5),
])
def test_unported_settings_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TS.StepSettings(n_streams=3, **option)
