"""gaitpd_torch.train.vmap_cv's FBG/FoG half against gaitpd's own stacked
functions on the CPU, from gaitpd's initial parameters (recorded by
wrapping gaitpd's ``init_stacked_state``, one set an instance, and copied
into the port's models by wrapping the port's, here only):
``run_fbg_fog_vmapped`` on synthetic FoG multimodal under GCL and CAGrad
(gaitpd's ``mm_gcl_cagrad`` of tests/test_vmap_cv.py, 2 epochs), and
``run_baseline_seeds_vmapped`` of the cheap-xattn fusion, synced, seeds
[0, 1] with 2 folds a seed (each seed's own init), 2 epochs. Neither run
draws: their random streams could not match JAX's PRNG. The port's draws
are held against its sequential drivers in tests/test_torch_vmap_fbg_fog.py,
whose thread fixture this file shares.

Tolerances: per-epoch train losses of every (fold, head) within 1e-4
relative; the skeleton, sensor and average accuracies within one eval
sample's share of the fold with the fewest (a synthetic FoG fold's eval
holds 3 subjects' 4 segments).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import gaitpd.train.fbg_fog_driver as JD  # noqa: E402
import gaitpd.train.vmap_cv as JV  # noqa: E402
import gaitpd_torch.train.fbg_fog_driver as TD  # noqa: E402
import gaitpd_torch.train.vmap_cv as TV  # noqa: E402
from gaitpd_torch.params import load_flax_params  # noqa: E402
from test_torch_vmap_fbg_fog import LOSS_RTOL, one_thread  # noqa: E402,F401

SHARE = 100.0 / 12 + 1e-4


def _record(monkeypatch):
    """Wrap both packages' init_stacked_state (gaitpd's instances' initial
    parameters recorded, then loaded into the port's models) and record
    each epoch's train losses (F, K) of both."""
    rec = {"init": None, "jax": [], "port": []}
    orig_init = JV.init_stacked_state

    def j_init(*a, **k):
        states, partition = orig_init(*a, **k)
        params = jax.device_get(states.params)
        n = len(jax.tree_util.tree_leaves(params)[0])
        rec["init"] = [jax.tree_util.tree_map(lambda v, i=i: np.asarray(v)[i], params)
                       for i in range(n)]
        return states, partition

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

    def t_init(models, *a, **k):
        for i, m in enumerate([models] if isinstance(models, torch.nn.Module) else models):
            load_flax_params(m, rec["init"][i])
        return orig_t_init(models, *a, **k)

    monkeypatch.setattr(JV, "init_stacked_state", j_init)
    monkeypatch.setattr(JV, "VmapEpochRunner", Runner)
    monkeypatch.setattr(TV, "init_stacked_state", t_init)
    return rec


def _assert_losses(rec, epochs):
    assert len(rec["port"]) == len(rec["jax"]) == epochs
    for ep, (p, j) in enumerate(zip(rec["port"], rec["jax"]), 1):
        np.testing.assert_allclose(p, j, rtol=LOSS_RTOL, err_msg=f"epoch {ep}, (fold, head)")


def test_run_fbg_fog_vmapped_matches_gaitpd(monkeypatch):
    rec = _record(monkeypatch)
    kw = dict(dataset="fog", modality="multimodal", wm="gcl", use_norm_and_cos=True,
              alpha=0.1, epochs=2, synthetic=True, seed=5, verbose=False)
    want = JV.run_fbg_fog_vmapped(JD.FbgFogArgs(**kw))
    got = TV.run_fbg_fog_vmapped(TD.FbgFogArgs(**kw, device="cpu"),
                                 on_epoch=lambda ep, tr, ev: rec["port"].append(tr["loss"]))
    _assert_losses(rec, kw["epochs"])
    assert list(got) == list(want) == ["multimodal"]
    for key in ("skel", "sensor", "avg"):
        assert abs(got["multimodal"][key] - want["multimodal"][key]) <= SHARE, (key, got, want)


def test_run_baseline_seeds_vmapped_matches_gaitpd(monkeypatch):
    rec = _record(monkeypatch)
    kw = dict(synced=True, epochs=2, n_folds_cap=2, synthetic=True)
    want = JV.run_baseline_seeds_vmapped("fog", "fusion", "cheap_xattn", [0, 1], **kw)
    got = TV.run_baseline_seeds_vmapped(
        "fog", "fusion", "cheap_xattn", [0, 1], device="cpu", **kw,
        on_epoch=lambda ep, tr, ev: rec["port"].append(tr["loss"]))
    _assert_losses(rec, kw["epochs"])
    assert len(rec["init"]) == 4
    assert sorted(got) == sorted(want) == [0, 1]
    for seed in (0, 1):
        for key in ("skel", "sensor", "avg"):
            assert abs(got[seed][key] - want[seed][key]) <= SHARE, (seed, key, got, want)
