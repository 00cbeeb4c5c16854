"""gaitpd_torch.train.fbg_fog_driver against gaitpd.train.fbg_fog_driver on
the CPU, from the same initial parameters: gaitpd's init is recorded and
copied into the port's model by wrapping each package's
``init_train_state`` (here only). The synthetic readers, folds, fold pools
and epoch orders come from the same seeds, so both runs see the same
batches. One fold of 2 epochs a case: FoG multimodal async (CAGrad at
K = 2, GCL, LayerNorm + cosine heads), FoG synchronized with the
consistency term, FBG multimodal async, FoG sensor-only with CE and FoG
skeleton-only with LDAM.

Tolerances: per-epoch train losses within 1e-4 relative (f32 on both
sides; the sums and the CAGrad solvers round differently, and SGD carries
that forward); the returned skeleton, sensor and average accuracies within
one eval sample's share, since an argmax on a near-tie may flip. A resumed
CPU run is bitwise equal to an uninterrupted one; the driver imports with
sklearn, pandas and matplotlib blocked.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import gaitpd.train.fbg_fog_driver as JD  # noqa: E402
import gaitpd_torch.train.fbg_fog_driver as TD  # noqa: E402
from gaitpd_torch.params import load_flax_params  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-4
COMMON = dict(synthetic=True, epochs=2, n_folds_cap=1, seed=0, verbose=False)
CASES = {
    "fog_multimodal_async_cagrad_gcl": dict(dataset="fog", modality="multimodal",
                                            wm="gcl", use_norm_and_cos=True),
    "fog_sync_consistency": dict(dataset="fog", modality="multimodal",
                                 synchronized_loading=True, consistency_lambda=1.0),
    "fbg_multimodal_async": dict(dataset="fbg", modality="multimodal", wm="class_wt"),
    "fog_sensor_ce": dict(dataset="fog", modality="sensor", wm="ce"),
    "fog_skeleton_ldam": dict(dataset="fog", modality="skeleton", wm="ldam", ldam_m=0.4,
                              synthetic_pose_per_joint=True),
}


def _fold(args):
    reader = JD.get_reader(args)
    labels = (JD.fbg_label_dict(reader) if args.dataset == "fbg"
              else JD.fog_label_dict(reader))
    return reader, JD.generate_class_stratified_folds(labels, np.random.default_rng(args.seed))[0]


def _run_both(monkeypatch, kw):
    """Both packages' train_one_fold on fold 1 from gaitpd's init: (gaitpd's
    result, the port's, their per-epoch train losses, the eval pool's size)."""
    rec = {"init": None, "jax": [], "port": [], "n_eval": 0}
    orig_init, orig_train, orig_eval = JD.init_train_state, JD.run_train_epoch, JD.run_eval_epoch

    def j_init(*a, **k):
        state, partition = orig_init(*a, **k)
        rec["init"] = jax.device_get(state.params)
        return state, partition

    def j_train(*a, **k):
        state, tr = orig_train(*a, **k)
        rec["jax"].append(np.asarray(tr.loss))
        return state, tr

    def j_eval(runner, state, data, *a, **k):
        rec["n_eval"] = len(data.eval_pool)
        return orig_eval(runner, state, data, *a, **k)

    monkeypatch.setattr(JD, "init_train_state", j_init)
    monkeypatch.setattr(JD, "run_train_epoch", j_train)
    monkeypatch.setattr(JD, "run_eval_epoch", j_eval)
    j_args = JD.FbgFogArgs(**COMMON, **kw)
    reader, (train, evals) = _fold(j_args)
    ref = JD.train_one_fold(1, reader, j_args, train, evals)

    orig_t_init = TD.init_train_state

    def t_init(model, *a, **k):
        load_flax_params(model, rec["init"])
        return orig_t_init(model, *a, **k)

    monkeypatch.setattr(TD, "init_train_state", t_init)
    t_args = TD.FbgFogArgs(**COMMON, **kw, device="cpu")
    got = TD.train_one_fold(1, TD.get_reader(t_args), t_args, train, evals,
                            on_epoch=lambda f, e, s, tr, ev: rec["port"].append(tr.loss))
    return ref, got, rec


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_one_fold_matches_gaitpd(monkeypatch, name):
    ref, got, rec = _run_both(monkeypatch, CASES[name])
    assert len(rec["port"]) == len(rec["jax"]) == COMMON["epochs"]
    for ep, (p, j) in enumerate(zip(rec["port"], rec["jax"]), 1):
        np.testing.assert_allclose(p, j, rtol=LOSS_RTOL, err_msg=f"epoch {ep} train losses")
    share = 100.0 / rec["n_eval"]
    for what, g, r in zip(("skel", "sens", "avg"), got, ref):
        assert abs(g - r) <= share + 1e-4, (what, got, ref)


def test_main_both_gives_gaitpd_summary_keys(monkeypatch):
    kw = dict(COMMON, dataset="fog", modality="both", wm="ce", epochs=1)
    want = JD.main(JD.FbgFogArgs(**kw))
    got = TD.main(TD.FbgFogArgs(**kw, device="cpu"))
    assert list(got) == list(want) == ["skeleton", "sensor"]
    for mod in got:
        assert set(got[mod]) == set(want[mod]) == {"skel", "sensor", "avg"}


def _uninterrupted_and_resumed(tmp_path, kw, epochs, cut):
    """Per-epoch (train loss, eval loss), the final state dict and result
    of an uninterrupted run, and of a run cut after ``cut`` epochs and
    resumed from its checkpoint."""

    def run(epochs_now, ckpt, resume):
        rec = []

        def on_epoch(f, e, state, tr, ev):
            rec.append((e, tr.loss.copy(), ev.loss.copy()))
            rec_state["sd"] = {k: v.clone() for k, v in state.module.state_dict().items()}

        rec_state = {}
        args = TD.FbgFogArgs(**dict(COMMON, **kw), device="cpu")
        args = dataclasses.replace(args, epochs=epochs_now, ckpt_dir=ckpt, resume=resume)
        reader, (train, evals) = _fold(args)
        res = TD.train_one_fold(1, TD.get_reader(args), args, train, evals, on_epoch=on_epoch)
        return rec, rec_state["sd"], res

    full = run(epochs, None, False)
    ckpt = str(tmp_path / "ck")
    run(cut, ckpt, False)
    resumed = run(epochs, ckpt, True)
    return full, resumed


@pytest.mark.parametrize("kw", [
    dict(dataset="fog", modality="multimodal", aug_mirror_p=0.5, aug_rot_deg=10.0,
         aug_noise_std=0.05, aug_axis_p=0.2),
    dict(dataset="fog", modality="multimodal", synchronized_loading=True),
], ids=["async_augmented", "sync"])
def test_resume_is_bitwise_equal(tmp_path, kw):
    (full_rec, full_sd, full_res), (res_rec, res_sd, res_res) = _uninterrupted_and_resumed(
        tmp_path, kw, epochs=3, cut=1)
    assert [e for e, _, _ in res_rec] == [1, 2]
    for (e, tr, ev), (e2, tr2, ev2) in zip(full_rec[1:], res_rec):
        assert e == e2
        np.testing.assert_array_equal(tr2, tr)
        np.testing.assert_array_equal(ev2, ev)
    for k in full_sd:
        assert torch.equal(res_sd[k], full_sd[k]), k
    assert res_res == full_res


def test_skeleton_augmentation_draws_change_the_run():
    """The skeleton stream's augmentation reaches the step: a run with it
    differs from one without, and the async layout keeps training."""
    base = dict(COMMON, dataset="fog", modality="multimodal", epochs=1, device="cpu")
    losses = []
    for aug in (dict(), dict(aug_mirror_p=0.5, aug_rot_deg=15.0)):
        rec = []
        args = TD.FbgFogArgs(**base, **aug)
        reader, (train, evals) = _fold(args)
        TD.train_one_fold(1, TD.get_reader(args), args, train, evals,
                          on_epoch=lambda f, e, s, tr, ev: rec.append(tr.loss))
        losses.append(rec[0])
    assert np.all(np.isfinite(losses[1])) and not np.array_equal(losses[0], losses[1])


@pytest.mark.parametrize("option", [dict(mesh=True), dict(modality="fused")])
def test_unported_options_raise(option):
    """An unknown modality raises ValueError. A mesh, once refused (ROADMAP
    Queue 1, item 14), now runs: main data-parallel over a mesh of this
    process alone gives main's summary without one, exactly."""
    if "mesh" not in option:
        with pytest.raises(ValueError, match="modality"):
            TD.main(TD.FbgFogArgs(**COMMON, device="cpu", **option))
        return
    from test_torch_mesh import one_rank_mesh, one_thread_here

    kw = dict(COMMON, epochs=1, modality="multimodal", device="cpu")
    with one_thread_here(), one_rank_mesh() as mesh:
        got = TD.main(TD.FbgFogArgs(**kw, mesh=mesh))
    with one_thread_here():
        assert got == TD.main(TD.FbgFogArgs(**kw))


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.main(TD.FbgFogArgs(**COMMON))


def test_imports_without_sklearn_pandas_matplotlib():
    code = ("import sys\n"
            "for m in ('sklearn', 'pandas', 'matplotlib', 'openpyxl', 'jax'):\n"
            "    sys.modules[m] = None\n"
            "import gaitpd_torch.train.fbg_fog_driver as D\n"
            "args = D.FbgFogArgs(dataset='fog', modality='sensor', wm='ce', synthetic=True,\n"
            "                    epochs=1, n_folds_cap=1, seed=0, device='cpu')\n"
            "print(sorted(D.main(args)))\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert "Best Sensor Report:" in done.stdout and "['sensor']" in done.stdout
