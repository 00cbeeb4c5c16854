"""gaitpd_torch.train.hp_search against gaitpd's own grid runners on the
CPU, from gaitpd's initial parameters (recorded by wrapping gaitpd's
``init_train_state``, which its runners call once a row from one seed, and
copied into the port's model by wrapping the port's
``init_stacked_state``, here only): ``run_weargait_hp_vmapped`` on the sync
flagship under GCL and CAGrad with a 2-row lr x alpha grid (each instance
its own lr and c; 2 folds of test_per_class 3, 2 epochs), and
``run_fbg_fog_hp_vmapped`` on synthetic FoG multimodal under GCL and
CAGrad with 2 rows (2 folds, 2 epochs). Neither run draws: the port's
random streams could not match JAX's PRNG. tests/test_torch_hp_search.py
holds the port's grids against its own stacked runs; its thread fixture is
shared here.

Tolerances: per-epoch train losses of every (instance, task) within 1e-4
relative (another framework sums in other orders); each instance's best
accuracy within one eval window's share (WearGait: of the largest fold's
eval pool; FoG: one eval sample of the fold with the fewest), since an
argmax on a near-tie may flip.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import gaitpd.train.fbg_fog_driver as JF  # noqa: E402
import gaitpd.train.hp_search as JH  # noqa: E402
import gaitpd.train.vmap_cv as JV  # noqa: E402
import gaitpd.train.weargait_driver as JD  # noqa: E402
import gaitpd_torch.train.fbg_fog_driver as TF  # noqa: E402
import gaitpd_torch.train.hp_search as TH  # noqa: E402
import gaitpd_torch.train.vmap_cv as TV  # noqa: E402
import gaitpd_torch.train.weargait_driver as TD  # noqa: E402
from gaitpd_torch.params import load_flax_params  # noqa: E402
from test_torch_hp_search import one_thread  # noqa: E402,F401

LOSS_RTOL = 1e-4
FOG_SHARE = 100.0 / 12 + 1e-4  # a synthetic FoG fold evaluates 12 segments


def _record(monkeypatch):
    """Wrap gaitpd's init_train_state (the first row's initial parameters
    recorded; every row starts from the same seed) and its runner's train
    epochs (the losses recorded), and the port's init_stacked_state (the
    recorded parameters loaded into its model)."""
    rec = {"init": None, "jax": [], "port": []}
    orig_init = JH.init_train_state

    def j_init(*a, **k):
        state, partition = orig_init(*a, **k)
        if rec["init"] is None:
            rec["init"] = jax.device_get(state.params)
        return state, partition

    class Runner(JV.VmapEpochRunner):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            inner = self.train_epoch

            def train_epoch(*args):
                states, metrics = inner(*args)
                rec["jax"].append(JV.aggregate_folds(metrics)["loss"])
                return states, metrics

            self.train_epoch = train_epoch

    orig_t_init = TV.init_stacked_state

    def t_init(model, *a, **k):
        load_flax_params(model, rec["init"])
        return orig_t_init(model, *a, **k)

    monkeypatch.setattr(JH, "init_train_state", j_init)
    monkeypatch.setattr(JH, "VmapEpochRunner", Runner)
    monkeypatch.setattr(TV, "init_stacked_state", t_init)
    return rec


def _assert_grids(rec, got, want, epochs, share):
    assert len(rec["port"]) == len(rec["jax"]) == epochs
    for ep, (p, j) in enumerate(zip(rec["port"], rec["jax"]), 1):
        np.testing.assert_allclose(p, j, rtol=LOSS_RTOL, err_msg=f"epoch {ep}, (instance, task)")
    assert got["grid_size"] == want["grid_size"] and got["n_folds"] == want["n_folds"]
    key = lambda r: tuple(sorted(r["hp"].items()))  # noqa: E731
    want_rows = {key(r): r for r in want["table"]}
    for r in got["table"]:
        np.testing.assert_allclose(r["per_fold"], want_rows[key(r)]["per_fold"], atol=share,
                                   err_msg=str(r["hp"]))


def test_weargait_grid_matches_gaitpd(monkeypatch):
    rec = _record(monkeypatch)
    kw = dict(n_folds=2, test_per_class=3, epochs=2, patience=50, synthetic=True,
              verbose=False, seed=0, wm="gcl", alpha=0.5)
    grid = [{"lr": 1e-3, "alpha": 0.5}, {"lr": 3e-3, "alpha": 2.0}]
    want = JH.run_weargait_hp_vmapped(JD.WearGaitArgs(**kw), grid)
    args = TD.WearGaitArgs(**kw, device="cpu")
    got = TH.run_weargait_hp_vmapped(args, grid,
                                     on_epoch=lambda ep, tr, ev: rec["port"].append(tr["loss"]))
    splits = TV._folds_and_splits(args)
    share = 100.0 / max(len(s.test_sync) for s in splits) + 1e-4
    _assert_grids(rec, got, want, kw["epochs"], share)


def test_fog_grid_matches_gaitpd(monkeypatch):
    rec = _record(monkeypatch)
    kw = dict(dataset="fog", modality="multimodal", wm="gcl", use_norm_and_cos=True,
              synthetic=True, epochs=2, n_folds_cap=2, verbose=False, seed=0)
    grid = [{}, {"lr": 3e-3, "alpha": 0.3}]
    want = JH.run_fbg_fog_hp_vmapped(JF.FbgFogArgs(**kw), grid)
    got = TH.run_fbg_fog_hp_vmapped(TF.FbgFogArgs(**kw, device="cpu"), grid,
                                    on_epoch=lambda ep, tr, ev: rec["port"].append(tr["loss"]))
    _assert_grids(rec, got, want, kw["epochs"], FOG_SHARE)
