"""The 12 MTL methods that draw nothing, on the flagship, against gaitpd:
the final gradients of one step per flax leaf
(gaitpd.learning.mtl.mtl_grads, with the WearGait driver's
``sum_plus_own``) and the methods' new states; and ``run_cv`` for MGDA,
FairGrad, NashMTL, FAMO and DWA, sync for 2 epochs, with
tests/test_torch_train_driver.py's checks (losses within 1e-4 relative,
the 7-subset table within one eval window's share).

Tolerances: final gradients within test_torch_mtl.py's GRAD_ATOL (1e-5 of
the largest leaf value); the methods' new states within 1e-5 relative and
1e-6 absolute (f32 on both sides, sums in another order).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_torch_mtl import GRAD_ATOL, _assert_trees_close, _setup  # noqa: E402
from test_torch_train_driver import CONFIGS, assert_run_cv_matches_gaitpd  # noqa: E402

from gaitpd.learning import mtl as JM  # noqa: E402
from gaitpd_torch.learning import mtl as TM  # noqa: E402
from gaitpd_torch.params import export_flax_params  # noqa: E402

NON_DRAWING = ("stl", "ls", "uw", "scaleinvls", "dwa", "famo", "mgda", "log_mgda", "imtl",
               "log_imtl", "nashmtl", "fairgrad")


@pytest.mark.parametrize("name", NON_DRAWING)
def test_mtl_grads_match_per_leaf(name):
    fm, params, tm, j_loss, j_args, t_loss, t_args = _setup(True, seed=4)
    bound = fm.bind(params)
    jp = JM.build_flat_partition(params, bound.shared_modules, bound.task_modules)
    jm = JM.make_method(name, 3)
    ref, j_losses, _, j_state, _ = JM.mtl_grads(
        jm, j_loss, params, jp, jm.init_state(), jax.random.PRNGKey(0), *j_args,
        private_grads="sum_plus_own")
    tp = TM.build_flat_partition(tm, tm.shared_modules, tm.task_modules)
    method = TM.make_method(name, 3)
    grads, t_losses, _, t_state, _ = TM.mtl_grads(
        method, lambda: t_loss(tm, *t_args), [p for _, p in tm.named_parameters()], tp,
        method.init_state(torch.device("cpu")), private_grads="sum_plus_own")
    got = export_flax_params(tm, dict(zip(tp.names, grads)))
    _assert_trees_close(got, ref, atol=GRAD_ATOL, what=name)
    np.testing.assert_allclose(t_losses.numpy(), np.asarray(j_losses), rtol=1e-5)
    assert set(t_state) == set(j_state)
    for key, value in j_state.items():
        np.testing.assert_allclose(np.asarray(t_state[key], dtype=np.float64),
                                   np.asarray(value, dtype=np.float64), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name} state {key}")


@pytest.mark.parametrize("name", ["mgda", "fairgrad", "nashmtl", "famo", "dwa"])
def test_run_cv_matches_gaitpd(monkeypatch, name):
    kw = dict(CONFIGS["sync_gcl"], epochs=2, mtl_method=name)
    assert_run_cv_matches_gaitpd(monkeypatch, kw)
