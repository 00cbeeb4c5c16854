"""gaitpd_torch.learning.mtl against gaitpd.learning.mtl on the WearGait
model, from one set of flax parameters copied by load_flax_params and one
numpy batch: the flat partition, the per-task gradient rows and the final
CAGrad gradients (both ``private_grads`` modes, sync and async models),
each compared per named leaf after export_flax_params, since the flat
orders differ.

Tolerances: the partition exactly. Per-task rows within rtol 1e-4 and atol
1e-6 of the largest leaf value: f32 on both sides, with the per-task
backward through GELU and LayerNorm summed in another order. Final
gradients within atol 1e-5 of the largest leaf value: the CAGrad weights of
the two solvers agree only to the flatness of the objective near its
optimum (tests/test_torch_minnorm.py).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from gaitpd.learning import mtl as JM  # noqa: E402
from gaitpd.models.multitask import WearGaitThreeModal as FlaxModel  # noqa: E402
from gaitpd.train import step as JS  # noqa: E402
from gaitpd_torch.learning import mtl as TM  # noqa: E402
from gaitpd_torch.models.multitask import WearGaitThreeModal  # noqa: E402
from gaitpd_torch.params import export_flax_params, load_flax_params  # noqa: E402
from gaitpd_torch.train import step as TS  # noqa: E402

COUNTS = [[40, 25], [40, 25], [40, 25]]
# final gradients: the two solvers' CAGrad weights differ by up to 1.6e-4
# on these batches (their Gram matrices agree to 4e-7 relative), which
# moves the shared gradients by up to 2.1e-5 of a largest leaf value of 7.8
GRAD_ATOL = 1e-5


def _setup(sync, seed=0, bsz=6):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(bsz, 64, c)).astype(np.float32) for c in (2, 13, 24)]
    ys = [rng.integers(0, 2, size=bsz).astype(np.int32) for _ in range(3)]
    valid = np.ones(bsz, np.float32)
    valid[-1] = 0.0
    fm = FlaxModel(synchronized=sync)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.normal(size=a.shape) * 0.1).astype(np.float32),
        fm.init(jax.random.PRNGKey(seed), *map(jnp.asarray, xs)),
    )
    tm = load_flax_params(WearGaitThreeModal(synchronized=sync), params)
    kw = dict(n_streams=3, wm="gcl", synchronized=sync, private_grads="sum_plus_own")
    j_settings, t_settings = JS.StepSettings(**kw), TS.StepSettings(**kw)
    train_apply, _ = JS.make_apply_adapters(fm.apply, j_settings)
    j_loss = JS.make_multitask_loss_fn(train_apply, j_settings)
    j_args = (tuple(map(jnp.asarray, xs)), tuple(map(jnp.asarray, ys)), jnp.asarray(valid),
              JS.make_loss_ctx(j_settings, COUNTS), jax.random.PRNGKey(1), jnp.asarray(0))
    t_loss = TS.make_multitask_loss_fn(t_settings)
    t_args = (tuple(map(torch.from_numpy, xs)),
              tuple(torch.from_numpy(y.astype(np.int64)) for y in ys),
              torch.from_numpy(valid), TS.make_loss_ctx(t_settings, COUNTS), None, 0)
    return fm, params, tm, j_loss, j_args, t_loss, t_args


def _leaves(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree).items()}


def _assert_trees_close(got, want, rtol=1e-4, atol=1e-6, what=""):
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w)
    scale = max(max(np.abs(v).max() for v in w.values()), 1.0)
    for key in w:
        np.testing.assert_allclose(g[key], w[key], rtol=rtol, atol=atol * scale,
                                   err_msg=f"{what} {'/'.join(key)}")


def _export_flat(tm, partition, flat):
    return export_flax_params(tm, dict(zip(partition.names, partition.unravel(flat))))


@pytest.mark.parametrize("sync", [True, False])
def test_partition_matches_per_leaf(sync):
    fm, params, tm, *_ = _setup(sync)
    bound = fm.bind(params)
    jp = JM.build_flat_partition(params, bound.shared_modules, bound.task_modules)
    tp = TM.build_flat_partition(tm, tm.shared_modules, tm.task_modules)
    _, unravel = ravel_pytree(params)
    assert tp.n_tasks == jp.n_tasks == 3
    assert int(tp.shared.sum()) == int(jp.shared.sum())
    _assert_trees_close(_export_flat(tm, tp, tp.shared.float()),
                        unravel(jp.shared.astype(jnp.float32)), rtol=0, atol=0)
    _assert_trees_close(_export_flat(tm, tp, tp.task_id.float()),
                        unravel(jp.task_id.astype(jnp.float32)), rtol=0, atol=0)


@pytest.mark.parametrize("sync", [True, False])
def test_per_task_rows_match_per_leaf(sync):
    fm, params, tm, j_loss, j_args, t_loss, t_args = _setup(sync)
    jmat, unravel, j_losses, _ = JM.per_task_grad_matrix(j_loss, params, *j_args)
    tp = TM.build_flat_partition(tm, tm.shared_modules, tm.task_modules)
    tmat, t_losses, _ = TM.per_task_grad_matrix(
        lambda: t_loss(tm, *t_args), [p for _, p in tm.named_parameters()])
    assert tmat.shape == jmat.shape
    np.testing.assert_allclose(t_losses.numpy(), np.asarray(j_losses), rtol=1e-5)
    for k in range(3):
        _assert_trees_close(_export_flat(tm, tp, tmat[k]), unravel(jmat[k]), what=f"row {k}")


@pytest.mark.parametrize("private_grads", ["sum", "sum_plus_own"])
@pytest.mark.parametrize("sync", [True, False])
def test_mtl_grads_match_per_leaf(sync, private_grads):
    fm, params, tm, j_loss, j_args, t_loss, t_args = _setup(sync, seed=2)
    bound = fm.bind(params)
    jp = JM.build_flat_partition(params, bound.shared_modules, bound.task_modules)
    ref, j_losses, *_ = JM.mtl_grads(
        JM.make_method("cagrad", 3, c=0.5), j_loss, params, jp, {},
        jax.random.PRNGKey(0), *j_args, private_grads=private_grads)
    tp = TM.build_flat_partition(tm, tm.shared_modules, tm.task_modules)
    grads, t_losses, *_ = TM.mtl_grads(
        TM.make_method("cagrad", 3, c=0.5), lambda: t_loss(tm, *t_args),
        [p for _, p in tm.named_parameters()], tp, {}, private_grads=private_grads)
    got = export_flax_params(tm, dict(zip(tp.names, grads)))
    _assert_trees_close(got, ref, atol=GRAD_ATOL, what=private_grads)
    np.testing.assert_allclose(t_losses.numpy(), np.asarray(j_losses), rtol=1e-5)


def test_log_cagrad_and_unported_methods():
    fm, params, tm, j_loss, j_args, t_loss, t_args = _setup(True, seed=3)
    bound = fm.bind(params)
    jp = JM.build_flat_partition(params, bound.shared_modules, bound.task_modules)
    ref, *_ = JM.mtl_grads(JM.make_method("log_cagrad", 3, c=0.5), j_loss, params, jp, {},
                           jax.random.PRNGKey(0), *j_args)
    tp = TM.build_flat_partition(tm, tm.shared_modules, tm.task_modules)
    grads, *_ = TM.mtl_grads(TM.make_method("log_cagrad", 3, c=0.5), lambda: t_loss(tm, *t_args),
                             [p for _, p in tm.named_parameters()], tp, {})
    _assert_trees_close(export_flax_params(tm, dict(zip(tp.names, grads))), ref,
                        atol=GRAD_ATOL, what="log")
    assert set(TM.METHODS) == {"cagrad", "log_cagrad"}
    assert set(TM.NOT_PORTED) | set(TM.METHODS) == set(JM.METHODS)
    for name in TM.NOT_PORTED:
        with pytest.raises(NotImplementedError, match="item 10"):
            TM.make_method(name, 3)
    with pytest.raises(ValueError):
        TM.make_method("nope", 3)


def test_clip_flat_matches():
    g = np.random.default_rng(0).normal(size=50).astype(np.float32)
    for max_norm in (0.5, 100.0):
        np.testing.assert_allclose(TM._clip_flat(torch.from_numpy(g), max_norm).numpy(),
                                   np.asarray(JM._clip_flat(jnp.asarray(g), max_norm)),
                                   rtol=1e-6)
