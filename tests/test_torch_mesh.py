"""gaitpd_torch/runtime/mesh.py and the data-parallel step on the CPU: the
helpers in this process (a group of one rank), then spawned gloo ranks
(gaitpd_torch.entry.run_ranks, each on one intra-op thread, a file store in
a temporary directory, a timeout of its own).

* 2 ranks: the flagship's CAGrad step with the batch sharded over them,
  against the single-process step, with every draw of the recipe on
  (augmentation, modality dropout, GCL noise: RowShard's rows of the global
  draw), and without draws against gaitpd's step on its 8-device virtual
  mesh (tests/conftest.py) from the same parameters; then run_cv_vmapped's
  two folds sharded one a rank against the single-process run.
* 4 ranks: the step on the 2 x 2 ("slices", "data") mesh against the 1-level
  mesh's and the single-process step.

This process and every rank run torch on one intra-op thread (the parallel
test workers' threads would otherwise oversubscribe the cores).

Tolerances: tests/test_torch_step.py's (parameters within 1e-6 and momentum
within 1e-5 of the largest value, losses within 1e-5 relative; correct
counts exactly), since the ranks' partial sums of J add in another order.
With the draws on, and against gaitpd's mesh step, the momentum within 1e-4
of the largest value: it is the first gradient, whose shared part moves
with the CAGrad weights, and those move by up to 4e-4 where the dual
objective is flat to f32 rounding (chip_smoke.py's rule for the card
against the CPU; the drawn step under linear scalarization agrees within
2e-6 of the single-process step). The fold-sharded CV's
per-fold macro within gaitpd's atol 1e-3 (__graft_entry__.py:242-247).
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gaitpd_torch.data.augment import AugmentSpec, make_aug_params
from gaitpd_torch.entry import run_ranks
from gaitpd_torch.learning import mtl as TM
from gaitpd_torch.models.multitask import WearGaitThreeModal
from gaitpd_torch.runtime import mesh as MESH
from gaitpd_torch.train import optim as TO
from gaitpd_torch.train import step as TS

B, T = 16, 16
SMALL = dict(enc_out_ch=4, shared_out_ch=4)  # gaitpd's tests/test_aux.py:122's widths
COUNTS = [[40, 25], [40, 25], [40, 25]]
CV = dict(n_folds=2, test_per_class=1, epochs=1, patience=50, wm="gcl", alpha=0.5, seed=0,
          synthetic=True, verbose=False, device="cpu")
SPAWN_TIMEOUT = 240.0


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(B, T, c)).astype(np.float32) for c in (2, 13, 24)]
    ys = [rng.integers(0, 2, size=B).astype(np.int32) for _ in range(3)]
    valid = np.ones(B, np.float32)
    valid[-3:] = 0.0
    return xs, ys, valid


def _settings(draws):
    kw = dict(n_streams=3, wm="gcl", synchronized=True, private_grads="sum_plus_own")
    if draws:
        kw.update(noise_mul=0.5, modality_dropout=0.3,
                  augment=(AugmentSpec(noise=True, axis_mask=True),) * 3)
    return TS.StepSettings(**kw)


def _port_step(state, batch, sharding=None, draws=False):
    """One CAGrad step (SGD 1e-3, momentum 0.9, decay 1e-4) of the flagship
    from ``state`` (numpy) on ``batch``, the generator seeded 0; returns the
    metrics, parameters and momenta on the host."""
    model = WearGaitThreeModal(synchronized=True, **SMALL)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    settings = _settings(draws)
    aug = [make_aug_params(noise_std=0.05, axis_p=0.2)] * 3 if draws else None
    opt = TO.sgd_torch(model.parameters(), 1e-3, 0.9, 1e-4)
    step = TS.make_train_step(settings, TM.make_method("cagrad", 3, c=0.5),
                              TM.build_flat_partition(model, model.shared_modules,
                                                      model.task_modules), sharding=sharding)
    xs, ys, valid = batch
    t_batch = {"xs": tuple(map(torch.from_numpy, xs)),
               "ys": tuple(torch.from_numpy(y.astype(np.int64)) for y in ys),
               "valid": torch.from_numpy(valid), "n_valid": int(valid.sum())}
    _, m = step(TS.TrainState(module=model, optimizer=opt, mtl_state={}), t_batch,
                torch.Generator().manual_seed(0), TS.make_loss_ctx(settings, COUNTS,
                                                                   aug_params=aug))
    return ({k: v.numpy() for k, v in m.items()},
            {k: v.detach().numpy().copy() for k, v in model.state_dict().items()},
            {n: opt.state[p]["momentum_buffer"].numpy().copy()
             for n, p in model.named_parameters()})


def _initial_state(seed=0):
    model = WearGaitThreeModal(synchronized=True, **SMALL,
                               generator=torch.Generator().manual_seed(seed))
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _assert_step_close(got, want, momentum_atol=1e-5):
    (gm, gp, gmom), (wm, wp, wmom) = got, want
    np.testing.assert_allclose(gm["losses"], wm["losses"], rtol=1e-5)
    np.testing.assert_array_equal(gm["correct"], wm["correct"])
    assert float(gm["n"]) == float(wm["n"])
    for tree, ref, atol in ((gp, wp, 1e-6), (gmom, wmom, momentum_atol)):
        scale = max(max(float(np.abs(v).max()) for v in ref.values()), 1.0)
        for k in ref:
            np.testing.assert_allclose(tree[k], ref[k], rtol=0, atol=atol * scale, err_msg=k)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def one_thread_here():
    """One intra-op thread within, the count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# --- helpers, in a group of one rank -----------------------------------------


@contextlib.contextmanager
def one_rank_mesh():
    """A mesh over a gloo group of this process alone, destroyed after."""
    mesh = MESH.make_mesh(device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_mesh_helpers_in_one_rank():
    assert MESH.pad_to_multiple(10, 4) == 12 and MESH.pad_to_multiple(8, 4) == 8
    whole = MESH.shard_folds(5, None)
    assert (whole.start, whole.stop, whole.take("abcde"), whole.gather([1, 2])) == (
        0, 5, list("abcde"), [1, 2])
    assert whole.checkpoint_root("ck") == "ck"
    assert MESH.mesh_rank(None) == 0 and MESH.mesh_size(None) == 1
    assert not dist.is_initialized()
    with one_rank_mesh() as mesh:
        assert mesh.mesh_dim_names == ("data",) and mesh.size() == 1
        with pytest.raises(ValueError, match="2 devices"):
            MESH.make_mesh(2, device="cpu")
        sharding = MESH.batch_sharding(mesh)
        x = torch.arange(6.0)
        assert (sharding.count, sharding.index) == (1, 0)
        assert torch.equal(sharding.rows(x), x) and torch.equal(sharding.sum(x), x)
        batch = {"xs": (x, x[:, None]), "n": 3}
        assert MESH.shard_batch(batch, mesh)["n"] == 3
        t = torch.ones(2)
        assert MESH.replicate({"t": t}, mesh)["t"] is t
        assert MESH.replicated(mesh).mesh is mesh
        one = MESH.shard_folds(3, mesh)
        assert (one.start, one.stop, one.gather(["a", "b", "c"])) == (0, 3, ["a", "b", "c"])
        assert one.checkpoint_root("ck") == "ck/shard0of1"


# --- spawned ranks ----------------------------------------------------------


def _two_rank_worker(rank, n, state, batch):
    mesh = MESH.make_mesh(device="cpu")
    sharding = MESH.mesh_sharding(mesh)
    assert (sharding.count, sharding.index) == (n, rank)
    rows = sharding.rows(torch.arange(8 * n))
    assert rows.tolist() == list(range(8 * rank, 8 * rank + 8))
    with pytest.raises(ValueError, match="divisible"):
        sharding.rows(torch.arange(3))
    plain = _port_step(state, batch, sharding)
    drawn = _port_step(state, batch, sharding, draws=True)
    folds = MESH.shard_folds(3, mesh)  # not divisible: every rank runs all
    assert (folds.start, folds.stop) == (0, 3)
    from gaitpd_torch.train.vmap_cv import run_cv_vmapped
    from gaitpd_torch.train.weargait_driver import WearGaitArgs

    cv = run_cv_vmapped(WearGaitArgs(mesh=mesh, **CV))
    return plain, drawn, cv


def test_two_rank_dp_step_and_fold_sharded_cv():
    """Each rank ends the step with the single-process step's parameters
    (with the recipe's draws too) and gaitpd's 8-device mesh step's; the
    fold-sharded CV equals the single-process run."""
    jax = pytest.importorskip("jax")
    if len(jax.devices()) < 8:
        pytest.skip("gaitpd's mesh needs tests/conftest.py's 8 virtual devices")
    state, batch = _initial_state(), _batch()
    (plain0, drawn0, cv0), (plain1, drawn1, cv1) = run_ranks(
        _two_rank_worker, 2, state, batch, timeout=SPAWN_TIMEOUT)
    for a, b in ((plain0, plain1), (drawn0, drawn1)):  # the ranks agree bitwise
        for k in a[1]:
            np.testing.assert_array_equal(a[1][k], b[1][k])
    _assert_step_close(plain0, _port_step(state, batch))
    _assert_step_close(drawn0, _port_step(state, batch, draws=True), momentum_atol=1e-4)

    from gaitpd_torch.train.vmap_cv import run_cv_vmapped
    from gaitpd_torch.train.weargait_driver import WearGaitArgs

    single = run_cv_vmapped(WearGaitArgs(**CV))
    assert cv0 == cv1
    np.testing.assert_allclose(cv0["per_fold_macro"], single["per_fold_macro"], atol=1e-3)
    for mk, scores in single["per_fold_masks"].items():
        np.testing.assert_allclose(cv0["per_fold_masks"][mk], scores, atol=1e-3, err_msg=mk)

    # gaitpd's data-parallel step on its 8-device virtual mesh, same parameters
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from gaitpd.learning import mtl as JM
    from gaitpd.models.multitask import WearGaitThreeModal as FlaxModel
    from gaitpd.runtime.mesh import make_mesh
    from gaitpd.train import optim as JO
    from gaitpd.train import step as JS
    from gaitpd_torch.params import export_flax_params

    fm = FlaxModel(synchronized=True, **SMALL)
    tm = WearGaitThreeModal(synchronized=True, **SMALL)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    params = export_flax_params(tm)  # the port's initial parameters, as flax's
    js = JS.StepSettings(n_streams=3, wm="gcl", synchronized=True, private_grads="sum_plus_own")
    tx = JO.sgd_torch(1e-3, 0.9, 1e-4)
    bound = fm.bind(params)
    jp = JM.build_flat_partition(params, bound.shared_modules, bound.task_modules)
    train_apply, _ = JS.make_apply_adapters(fm.apply, js)
    j_step = jax.jit(JS.make_train_step(train_apply, tx, js, JM.make_method("cagrad", 3, c=0.5),
                                        jp))
    sh = NamedSharding(make_mesh(8), P("data"))
    xs, ys, valid = batch
    j_batch = {"xs": tuple(jax.device_put(x, sh) for x in xs),
               "ys": tuple(jax.device_put(y, sh) for y in ys), "valid": jax.device_put(valid, sh)}
    j_state = JS.TrainState(params=params, opt_state=tx.init(params), mtl_state={},
                            epoch=jax.numpy.asarray(0, jax.numpy.int32))
    j_state, j_m = j_step(j_state, j_batch, jax.random.PRNGKey(0), JS.make_loss_ctx(js, COUNTS))
    got_m, got_p, got_mom = plain0
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in got_p.items()})
    mom = {n: torch.from_numpy(got_mom[n]) for n, _ in tm.named_parameters()}
    want = ({k: np.asarray(v) for k, v in j_m.items()},
            {k: np.asarray(v) for k, v in _flat(j_state.params).items()},
            {k: np.asarray(v) for k, v in _flat(j_state.opt_state[1].trace).items()})
    got = (got_m, {k: np.asarray(v) for k, v in _flat(export_flax_params(tm)).items()},
           {k: np.asarray(v) for k, v in _flat(export_flax_params(tm, mom)).items()})
    _assert_step_close(got, want, momentum_atol=1e-4)


def _flat(tree):
    from flax.traverse_util import flatten_dict

    return {"/".join(k): v for k, v in flatten_dict(tree).items()}


def _four_rank_worker(rank, n, state, batch):
    one = _port_step(state, batch, MESH.mesh_sharding(MESH.make_mesh(device="cpu")))
    mesh2 = MESH.make_mesh_2d(2, device="cpu")
    assert mesh2.mesh_dim_names == ("slices", "data") and tuple(mesh2.shape) == (2, 2)
    return one, _port_step(state, batch, MESH.batch_sharding_2d(mesh2))


def test_four_rank_2x2_mesh_step_equals_the_1_level_step():
    state, batch = _initial_state(1), _batch(1)
    out = run_ranks(_four_rank_worker, 4, state, batch, timeout=SPAWN_TIMEOUT)
    one, two = out[0]
    _assert_step_close(two, one)
    _assert_step_close(one, _port_step(state, batch))
    for r in range(1, 4):
        for k in two[1]:
            np.testing.assert_array_equal(out[r][1][1][k], two[1][k])
