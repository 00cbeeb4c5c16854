"""StepSettings.remat (gaitpd_torch/runtime/remat.py) on the CPU, at the
sizes of gaitpd's tests/test_aux.py:110-140 (enc_out_ch and shared_out_ch
4, 8 windows of 16 frames).

* The port's CAGrad step under "dots" and "nothing" against its "none" step,
  with the GCL noise drawn: parameters, momentum and the generator bitwise
  equal. Under "nothing" the forward runs 1 + K = 4 times a step; under
  "dots" once, with the elementwise ops checkpointed.
* Against gaitpd's remat step from gaitpd's parameters (load_flax_params),
  within tests/test_torch_step.py's tolerances.
* DeepAV-Lite with dropout inside the recomputed forward: bitwise equal to
  no remat, so every recomputation replayed the first run's masks.
* The stacked runner (gaitpd_torch/train/vmap_cv.py) at F = 2 folds with
  the GCL noise and modality dropout drawn from each fold's generator
  inside the recomputed region: bitwise equal to its "none" step, the
  generators too.
"""

import functools

import numpy as np
import pytest
import torch

import gaitpd_torch.train.vmap_cv as TV
from gaitpd_torch.learning import mtl as TM
from gaitpd_torch.models.baselines import DeepAVLite3
from gaitpd_torch.models.multitask import WearGaitThreeModal
from gaitpd_torch.runtime import remat as R
from gaitpd_torch.train import optim as TO
from gaitpd_torch.train import step as TS

POLICIES = ["dots", "nothing"]
SMALL = dict(enc_out_ch=4, shared_out_ch=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, lead=()):
    rng = np.random.default_rng(seed)
    xs = tuple(torch.from_numpy(rng.normal(size=lead + (8, 16, c)).astype(np.float32))
               for c in (2, 13, 24))
    ys = tuple(torch.from_numpy(rng.integers(0, 2, size=lead + (8,))) for _ in range(3))
    valid = torch.ones(lead + (8,))
    valid[..., -2:] = 0.0
    return {"xs": xs, "ys": ys, "valid": valid, "n_valid": int(valid.sum())}


def _state(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _momenta(optimizer):
    return [optimizer.state[p]["momentum_buffer"].clone()
            for g in optimizer.param_groups for p in g["params"]]


def _assert_equal(got, want):
    assert set(got) == set(want) if isinstance(want, dict) else len(got) == len(want)
    for k in (want if isinstance(want, dict) else range(len(want))):
        assert torch.equal(got[k], want[k]), k


def _counted_forward(calls):
    def train_apply(module, xs, generator, epoch):
        calls.append(1)
        return module(*xs)
    return train_apply


@functools.lru_cache(maxsize=None)
def _flagship_steps(remat):
    """A CAGrad step of the small flagship (GCL noise 0.5) under ``remat``:
    parameters, momenta, the generator's state, the forward's runs and the
    elementwise checkpoints."""
    model = WearGaitThreeModal(synchronized=True, **SMALL,
                               generator=torch.Generator().manual_seed(0))
    settings = TS.StepSettings(n_streams=3, wm="gcl", synchronized=True, noise_mul=0.5,
                               private_grads="sum_plus_own", remat=remat)
    calls, ckpts = [], []
    orig = R.checkpoint

    def counting(*a, **k):
        ckpts.append(1)
        return orig(*a, **k)

    R.checkpoint = counting
    try:
        state = TS.TrainState(module=model,
                              optimizer=TO.sgd_torch(model.parameters(), 1e-2, 0.9, 1e-4),
                              mtl_state={})
        step = TS.make_train_step(
            settings, TM.make_method("cagrad", 3, c=0.5),
            TM.build_flat_partition(model, model.shared_modules, model.task_modules),
            _counted_forward(calls))
        gen = torch.Generator().manual_seed(3)
        ctx = TS.make_loss_ctx(settings, [(5, 3)] * 3)
        state, _ = step(state, _batch(0), gen, ctx)
    finally:
        R.checkpoint = orig
    return _state(model), _momenta(state.optimizer), gen.get_state(), len(calls), len(ckpts)


@pytest.mark.parametrize("remat", POLICIES)
def test_remat_step_equals_the_none_step(remat):
    params, momenta, gen, calls, ckpts = _flagship_steps(remat)
    want_params, want_momenta, want_gen, want_calls, _ = _flagship_steps("none")
    _assert_equal(params, want_params)
    _assert_equal(momenta, want_momenta)
    assert torch.equal(gen, want_gen)
    assert want_calls == 1
    if remat == "nothing":
        assert (calls, ckpts) == (4, 1)  # 1 + K forwards, one checkpoint
    else:
        assert calls == 1 and ckpts > 0  # one forward, its elementwise ops checkpointed


@pytest.mark.parametrize("remat", POLICIES)
def test_remat_step_matches_gaitpd(remat):
    """One CAGrad step of gaitpd's remat step and the port's from gaitpd's
    parameters: losses within 1e-5, parameters within 1e-6 and momentum
    within 1e-5 of the largest value (tests/test_torch_step.py)."""
    pytest.importorskip("jax")
    import jax

    from gaitpd.learning import mtl as JM
    from gaitpd.train import optim as JO
    from gaitpd.train import step as JS
    from gaitpd_torch.params import export_flax_params
    from test_torch_step import COUNTS, LR, _assert_close, _batches, _j_batch, _momentum
    from test_torch_step import _pair, _t_batch

    fm, params, tm, js, ts = _pair(True, remat=remat)
    tx = JO.sgd_torch(LR, 0.9, 1e-4)
    bound = fm.bind(params)
    jp = JM.build_flat_partition(params, bound.shared_modules, bound.task_modules)
    train_apply, _ = JS.make_apply_adapters(fm.apply, js)
    j_step = jax.jit(JS.make_train_step(train_apply, tx, js, JM.make_method("cagrad", 3, c=0.5),
                                        jp))
    j_state = JS.TrainState(params=params, opt_state=tx.init(params), mtl_state={},
                            epoch=jax.numpy.asarray(0, jax.numpy.int32))
    t_state = TS.TrainState(module=tm, optimizer=TO.sgd_torch(tm.parameters(), LR, 0.9, 1e-4),
                            mtl_state={})
    t_step = TS.make_train_step(ts, TM.make_method("cagrad", 3, c=0.5),
                                TM.build_flat_partition(tm, tm.shared_modules, tm.task_modules))
    batch, = _batches(1, 1)
    j_state, j_m = j_step(j_state, _j_batch(*batch), jax.random.PRNGKey(0),
                          JS.make_loss_ctx(js, COUNTS))
    t_state, t_m = t_step(t_state, _t_batch(*batch), None, TS.make_loss_ctx(ts, COUNTS))
    np.testing.assert_allclose(t_m["losses"].numpy(), np.asarray(j_m["losses"]), rtol=1e-5)
    _assert_close(export_flax_params(tm), j_state.params, atol=1e-6)
    _assert_close(_momentum(tm, t_state.optimizer), j_state.opt_state[1].trace, atol=1e-5)


@pytest.mark.parametrize("remat", POLICIES)
def test_dropout_inside_the_recomputed_forward_replays_its_masks(remat):
    """DeepAV-Lite (dropout 0.1) on the mean of its branch losses, two steps:
    bitwise equal to no remat, and its generator where no remat leaves it."""
    out = {}
    for policy in ("none", remat):
        model = DeepAVLite3(num_classes=2, synchronized=True,
                            generator=torch.Generator().manual_seed(0))
        settings = TS.StepSettings(n_streams=3, wm="gcl", synchronized=True, dropout=True,
                                   remat=policy)
        state = TS.TrainState(module=model,
                              optimizer=TO.sgd_torch(model.parameters(), 1e-2, 0.9, 1e-4),
                              mtl_state={})
        step = TS.make_train_step(settings)
        gen = torch.Generator().manual_seed(3)
        for s in range(2):
            state, _ = step(state, _batch(s), gen, TS.make_loss_ctx(settings, [(5, 3)] * 3))
        out[policy] = (_state(model), _momenta(state.optimizer), gen.get_state())
    _assert_equal(out[remat][0], out["none"][0])
    _assert_equal(out[remat][1], out["none"][1])
    assert torch.equal(out[remat][2], out["none"][2])


@functools.lru_cache(maxsize=None)
def _stacked_steps(remat):
    """A stacked CAGrad step of 2 folds (GCL noise 0.5, modality dropout 0.3,
    fold 2's batch part padding) under ``remat``."""
    model = WearGaitThreeModal(synchronized=True, **SMALL,
                               generator=torch.Generator().manual_seed(0))
    settings = TS.StepSettings(n_streams=3, wm="gcl", synchronized=True, noise_mul=0.5,
                               modality_dropout=0.3, private_grads="sum_plus_own", remat=remat)
    ctx = TV.stack_ctx([TS.make_loss_ctx(settings, [(5, 3)] * 3) for _ in range(2)])
    mtl = TM.make_method("cagrad", 3, c=0.5)
    state, partition = TV.init_stacked_state(
        model, functools.partial(TO.sgd_torch, lr=1e-2, momentum=0.9), mtl, 2, "cpu")
    runner = TV.VmapEpochRunner(settings, mtl, partition)
    gens = [torch.Generator().manual_seed(10 + f) for f in range(2)]
    batch = _batch(0, (2,))
    batch["valid"][1, -4:] = 0.0
    state, _ = runner.train_step(state, batch, ctx, False, gens)
    return ({k: v.detach().clone() for k, v in state.params.items()},
            _momenta(state.optimizer), tuple(g.get_state() for g in gens))


@pytest.mark.parametrize("remat", POLICIES)
def test_stacked_runner_remat_equals_none(remat):
    got, want = _stacked_steps(remat), _stacked_steps("none")
    _assert_equal(got[0], want[0])
    _assert_equal(got[1], want[1])
    assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="remat"):
        TS.StepSettings(n_streams=3, remat="everything")
