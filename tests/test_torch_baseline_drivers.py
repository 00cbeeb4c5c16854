"""gaitpd_torch.train.baseline_drivers against gaitpd.train.baseline_drivers
on the CPU, from the same initial parameters: gaitpd's init is recorded and
copied into the port's model by wrapping each package's
``init_train_state`` (here only), as tests/test_torch_fbg_fog_driver.py
does. The synthetic readers, folds, fold pools and epoch orders come from
the same seeds, so both runs see the same batches. One fold of 2 epochs a
case: the cheap cross-attention fusion on FoG async (Adam, the mean of the
two CE losses), the shared latent on FoG sync (two heads in sync), early
fusion on FBG async (batch 32, widths 3/3), FOCAL on FoG async (AdamW with
the clip, the sum of the losses), DeepAV-Lite on FBG async and TACA on FoG
async at dropout 0 on both sides (the dropout masks cannot match JAX's).
FBG has no synchronized mode: its pose and GRF keys share no segment, so
gaitpd's fold builder raises for it, and so does the port's.

Tolerances: per-epoch train losses within 1e-4 relative (f32 on both
sides; the sums round differently, and Adam carries that forward); the
returned accuracies within one eval sample's share, since an argmax on a
near-tie may flip.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import gaitpd.train.baseline_drivers as JD  # noqa: E402
from gaitpd.data import synthetic  # noqa: E402
import gaitpd_torch.train.baseline_drivers as TD  # noqa: E402
from gaitpd_torch.models.baselines import without_dropout  # noqa: E402
from gaitpd_torch.params import load_flax_params  # noqa: E402

LOSS_RTOL = 1e-4
COMMON = dict(synthetic=True, epochs=2, n_folds_cap=1, seed=0, verbose=False)
CASES = {
    "fusion_cheap_xattn_fog_async": dict(kind="fusion", fusion_type="cheap_xattn"),
    "fusion_share_latent_fog_sync": dict(kind="fusion", fusion_type="share_latent",
                                         synced=True),
    "fusion_early_fbg_async": dict(kind="fusion", fusion_type="early", dataset="fbg"),
    "focal_fog_async": dict(kind="focal"),
    "deepav_fbg_async": dict(kind="deepav", dataset="fbg"),
    "taca_fog_async_no_dropout": dict(kind="taca"),
}


def _run_both(monkeypatch, kw):
    """Both packages' train_fold on fold 1 from gaitpd's init: (gaitpd's
    result, the port's, their per-epoch train losses, the eval pool's
    size). TACA runs at dropout 0 on both sides."""
    rec = {"init": None, "jax": [], "port": [], "n_eval": 0}
    orig_init, orig_train, orig_eval = JD.init_train_state, JD.run_train_epoch, JD.run_eval_epoch
    orig_build, orig_t_build = JD._build_model, TD._build_model

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
    if kw["kind"] == "taca":
        monkeypatch.setattr(JD, "_build_model", lambda *a, **k: orig_build(*a, **k).clone(
            drop=0.0))
        monkeypatch.setattr(TD, "_build_model", lambda *a, **k: without_dropout(
            orig_t_build(*a, **k)))
    j_args = JD.BaselineArgs(**COMMON, **kw)
    reader = (synthetic.make_fbg_reader(seed=j_args.seed) if j_args.dataset == "fbg"
              else synthetic.make_fog_reader(seed=j_args.seed))
    labels = (JD.fbg_label_dict(reader, exclude=JD.FOG_EXCLUDED_SUBJECTS)
              if j_args.dataset == "fbg" else JD.fog_label_dict(reader))
    train, evals = JD.generate_class_stratified_folds(
        labels, np.random.default_rng(j_args.seed))[0]
    ref = JD.train_fold(1, reader, j_args, train, evals)

    orig_t_init = TD.init_train_state

    def t_init(model, *a, **k):
        load_flax_params(model, rec["init"])
        return orig_t_init(model, *a, **k)

    monkeypatch.setattr(TD, "init_train_state", t_init)
    t_args = TD.BaselineArgs(**COMMON, **kw, device="cpu")
    got = TD.train_fold(1, TD.get_reader(t_args), t_args, train, evals,
                        on_epoch=lambda f, e, s, tr, ev: rec["port"].append(tr.loss))
    return ref, got, rec


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_fold_matches_gaitpd(monkeypatch, name):
    ref, got, rec = _run_both(monkeypatch, CASES[name])
    assert len(rec["port"]) == len(rec["jax"]) == COMMON["epochs"]
    for ep, (p, j) in enumerate(zip(rec["port"], rec["jax"]), 1):
        assert np.all(np.isfinite(p))
        np.testing.assert_allclose(p, j, rtol=LOSS_RTOL, err_msg=f"epoch {ep} train losses")
    share = 100.0 / rec["n_eval"]
    for what, g, r in zip(("skel", "sens", "avg"), got, ref):
        assert abs(g - r) <= share + 1e-4, (what, got, ref)


def test_main_gives_gaitpd_summary_keys():
    kw = dict(COMMON, kind="fusion", fusion_type="late", dataset="fbg", epochs=1)
    want = JD.main(JD.BaselineArgs(**kw))
    got = TD.main(TD.BaselineArgs(**kw, device="cpu"))
    assert list(got) == list(want) == ["skel", "sensor", "avg"]
    assert all(isinstance(v, float) for v in got.values())


def test_fbg_has_no_synchronized_mode():
    args = TD.BaselineArgs(**COMMON, kind="deepav", dataset="fbg", synced=True, device="cpu")
    with pytest.raises(ValueError, match="no aligned pairs"):
        TD.main(args)


def test_cli_shims_run_the_drivers(monkeypatch):
    """run_fusion and run_baseline build gaitpd's BaselineArgs from a CLI
    namespace; ``device`` rides along."""
    seen = []
    monkeypatch.setattr(TD, "main", lambda args: seen.append(args) or {})
    ns = SimpleNamespace(dataset="fog", synchronized_loading=True, wm="gcl", seed=3, epochs=2,
                         batch_size=None, patience=None, synthetic=True, n_folds_cap=1,
                         quiet=True, fusion_type="late", device="cpu")
    TD.run_fusion(ns)
    TD.run_baseline(ns, "focal")
    fusion, focal = seen
    assert (fusion.kind, fusion.fusion_type, fusion.wm) == ("fusion", "late", "ce")
    assert (focal.kind, focal.wm, focal.synced, focal.verbose) == ("focal", "ce", True, False)
    assert fusion.device == focal.device == "cpu"


def test_hyperparameters_keep_gaitpd_drift():
    for kind in TD.KINDS:
        for dataset in ("fog", "fbg"):
            args = TD.BaselineArgs(kind=kind, epochs=3, batch_size=None, patience=7)
            want = JD._hp(JD.BaselineArgs(kind=kind, epochs=3, patience=7), dataset)
            assert TD._hp(args, dataset) == want
    assert TD._hp(TD.BaselineArgs(kind="fusion"), "fog")["sensor_length"] == 150


def test_taca_epoch_fraction_is_f32():
    args = TD.BaselineArgs(kind="taca", epochs=3)
    train_apply, _ = TD._adapters(args, TD._hp(args, "fog"))
    seen = {}

    def module(*xs, train, epoch_frac, generator):
        seen["frac"] = epoch_frac
        return xs

    train_apply(module, (torch.zeros(2, 5, 3),), None, 1)
    assert seen["frac"] == float(np.float32(1) / np.float32(3)) != 1 / 3


@pytest.mark.parametrize("kind", ["fusion", "taca"])
def test_default_device_is_the_card(kind):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.main(TD.BaselineArgs(kind=kind, **COMMON))
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.run_fusion(SimpleNamespace(
            dataset="fog", synchronized_loading=False, seed=0, epochs=1, batch_size=None,
            patience=None, synthetic=True, n_folds_cap=1, quiet=True, fusion_type="early"))
