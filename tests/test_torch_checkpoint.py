"""gaitpd_torch.train.checkpoint, resume in run_cv and
WearGaitEngine.from_checkpoint, on the CPU.

A resumed run must be the uninterrupted run: run_cv for E epochs against
run_cv for E - 1 epochs with ``ckpt_dir`` and then resumed to E. The last
epoch's train and eval losses, the final parameters and buffers and the
7-subset table are compared bitwise, with augmentation and modality
dropout on (their draws come from the restored generator), for the
flagship (CAGrad, sync and async), one stateful MTL method (FAMO) and a
baseline that trains with dropout (DeepAV-Lite; TACA's gamma schedule reads
``epoch / epochs``, so a shorter first run would train another schedule).
"""

import json

import numpy as np
import pytest
import torch

from gaitpd_torch.learning.mtl import build_flat_partition, make_method
from gaitpd_torch.models.multitask import CHANNELS, MODALITIES, WearGaitThreeModal
from gaitpd_torch.serve import WearGaitEngine
from gaitpd_torch.train import checkpoint as CK
from gaitpd_torch.train import weargait_driver as TD
from gaitpd_torch.train.optim import sgd_torch
from gaitpd_torch.train.step import StepSettings, TrainState, make_loss_ctx, make_train_step

RECIPE = dict(n_folds=2, test_per_class=3, n_folds_cap=1, seed=0, device="cpu", verbose=False,
              patience=50, synthetic=True, aug_noise_std=0.05, aug_axis_p=0.2,
              modality_dropout=0.3)
RESUME_CASES = {
    "cagrad_sync": (dict(), 3),
    "cagrad_async": (dict(async_loading=True), 2),
    "famo_sync": (dict(mtl_method="famo"), 2),
    "deepav_lite_sync": (dict(baseline="deepav_lite"), 2),
}


def _recorder(out):
    def on_epoch(fold, ep, state, tr, ev):
        out.append({"epoch": ep, "train": tr.loss.copy(), "eval": ev.loss.copy(),
                    "ens": ev.ens_acc,
                    "state": {k: v.clone() for k, v in state.module.state_dict().items()}})
    return on_epoch


@pytest.mark.parametrize("name", sorted(RESUME_CASES))
def test_resumed_run_is_the_uninterrupted_run(tmp_path, capsys, name):
    extra, epochs = RESUME_CASES[name]
    kw = dict(RECIPE, **extra)
    full, resumed = [], []
    want = TD.run_cv(TD.WearGaitArgs(epochs=epochs, **kw), on_epoch=_recorder(full))
    TD.run_cv(TD.WearGaitArgs(epochs=epochs - 1, ckpt_dir=str(tmp_path), **kw))
    assert json.loads((tmp_path / "fold1" / "latest.json").read_text())["epoch"] == epochs - 2
    got = TD.run_cv(TD.WearGaitArgs(epochs=epochs, ckpt_dir=str(tmp_path), resume=True, **kw),
                    on_epoch=_recorder(resumed))
    assert f"[Fold 1] resumed from epoch {epochs}" in capsys.readouterr().out
    assert [r["epoch"] for r in resumed] == [epochs]
    last = full[-1]
    for key in ("train", "eval"):
        np.testing.assert_array_equal(resumed[0][key], last[key], err_msg=key)
    assert resumed[0]["ens"] == last["ens"]
    assert resumed[0]["state"].keys() == last["state"].keys()
    for k, v in last["state"].items():
        assert torch.equal(resumed[0]["state"][k], v), k
    assert got["masks"] == want["masks"]
    assert got["macro"] == want["macro"]


def _famo_state(seed):
    model = WearGaitThreeModal(synchronized=True, generator=torch.Generator().manual_seed(seed))
    mtl = make_method("famo", 3)
    return TrainState(module=model, optimizer=sgd_torch(model.parameters(), 1e-3),
                      mtl_state=mtl.init_state()), mtl


def test_round_trip(tmp_path):
    """Module, momentum, MTL state, epoch, numpy and torch generators come
    back as they were saved; the json holds the early-stopping counters."""
    state, mtl = _famo_state(0)
    settings = StepSettings(n_streams=3, synchronized=True, private_grads="sum_plus_own")
    step = make_train_step(settings, mtl, build_flat_partition(
        state.module, state.module.shared_modules, state.module.task_modules))
    g = torch.Generator().manual_seed(1)
    batch = {"xs": tuple(torch.randn((4, 64, CHANNELS[m]), generator=g) for m in MODALITIES),
             "ys": tuple(torch.randint(0, 2, (4,), generator=g) for _ in MODALITIES),
             "valid": torch.ones(4), "n_valid": 4}
    for _ in range(2):  # FAMO's state moves from the second step on
        step(state, batch, g, make_loss_ctx(settings, [[3, 2]] * 3))
    state.epoch = 4
    rng = np.random.default_rng(7)
    rng.permutation(10)
    CK.save_fold_checkpoint(tmp_path, 2, state, best_metric=61.5, no_improve=3, rng=rng,
                            generator=g)
    CK.save_fold_checkpoint(tmp_path, 2, state, best_metric=61.5, latest=False, rng=rng,
                            generator=g)
    fresh, _ = _famo_state(1)
    fresh_rng, fresh_g = np.random.default_rng(0), torch.Generator().manual_seed(0)
    meta = CK.restore_fold_checkpoint(tmp_path, 2, fresh, rng=fresh_rng, generator=fresh_g)
    assert meta == {"epoch": 4, "best_metric": 61.5, "no_improve": 3}
    assert json.loads((tmp_path / "fold2" / "best.json").read_text())["no_improve"] == 0
    assert fresh.epoch == 4
    for (n, p), q in zip(state.module.named_parameters(), fresh.module.parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(state.optimizer.state[p]["momentum_buffer"],
                           fresh.optimizer.state[q]["momentum_buffer"]), n
    assert state.mtl_state.keys() == fresh.mtl_state.keys()
    for k, v in state.mtl_state.items():
        assert torch.equal(v, fresh.mtl_state[k]), k
    assert torch.any(state.mtl_state["w"] != 0)
    np.testing.assert_array_equal(fresh_rng.permutation(10), rng.permutation(10))
    assert torch.equal(torch.rand(5, generator=fresh_g), torch.rand(5, generator=g))
    assert CK.restore_fold_checkpoint(tmp_path, 3, fresh, rng=fresh_rng, generator=fresh_g) is None


def test_resume_on_another_device_kind_raises(tmp_path):
    state, _ = _famo_state(0)
    path = CK.save_fold_checkpoint(tmp_path, 1, state, best_metric=0.0,
                                   rng=np.random.default_rng(0), generator=torch.Generator())
    payload = torch.load(path, weights_only=True)
    payload.update(generator_device="cuda", generator=torch.zeros(16, dtype=torch.uint8))
    torch.save(payload, path)  # as a run on the card writes it
    with pytest.raises(ValueError, match="'cuda'.*'cpu'"):
        CK.restore_fold_checkpoint(tmp_path, 1, state, rng=np.random.default_rng(0),
                                   generator=torch.Generator())


def test_from_checkpoint_serves_the_best_module(tmp_path):
    """The engine on the best snapshot predicts what an engine on the best
    epoch's module predicts (the driver's sync rule: the ensemble accuracy
    improves strictly), bitwise; the latest snapshot is the final module;
    stats.json beside the folds is read."""
    seen = []
    args = TD.WearGaitArgs(epochs=3, ckpt_dir=str(tmp_path), **dict(RECIPE, mtl_method="famo"))
    TD.run_cv(args, on_epoch=_recorder(seen))
    best = 0.0
    for r in seen:
        if r["ens"] > best:
            best, best_state = r["ens"], r["state"]
    module = WearGaitThreeModal(synchronized=True)
    module.load_state_dict(best_state)
    rng = np.random.default_rng(3)
    windows = {m: rng.normal(size=(32, 64, c)).astype(np.float32) for m, c in CHANNELS.items()}
    want = WearGaitEngine(module, device="cpu").predict_windows(windows)
    got = WearGaitEngine.from_checkpoint(tmp_path, fold=1, device="cpu").predict_windows(windows)
    np.testing.assert_array_equal(got, want)
    module.load_state_dict(seen[-1]["state"])
    last = WearGaitEngine.from_checkpoint(tmp_path, fold=1, which="latest", device="cpu")
    np.testing.assert_array_equal(last.predict_windows(windows),
                                  WearGaitEngine(module, device="cpu").predict_windows(windows))
    stats = {m: [[0.5] * c, [2.0] * c] for m, c in CHANNELS.items()}
    (tmp_path / "stats.json").write_text(json.dumps(stats))
    engine = WearGaitEngine.from_checkpoint(tmp_path, device="cpu")
    np.testing.assert_array_equal(engine.stats["imu"][1], np.full(24, 2.0, np.float32))
    with pytest.raises(FileNotFoundError):
        WearGaitEngine.from_checkpoint(tmp_path, fold=2, device="cpu")


def test_single_mod_fold_writes_no_checkpoint(tmp_path):
    """As in gaitpd, the single-modality sub-driver ignores ckpt_dir."""
    args = TD.WearGaitArgs(epochs=1, ckpt_dir=str(tmp_path / "ck"), single_mod="imu", **RECIPE)
    TD.run_cv(args)
    assert not (tmp_path / "ck").exists()
