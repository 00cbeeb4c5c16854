"""gaitpd_torch.cli against gaitpd.cli on the CPU: the same argv parses to
the same flags (the port's one more, ``--device``), each mode builds the
same Args for its driver (the drivers are stood in for on both sides, and
``device`` is left out of the comparison), ``--vmap_hp`` reaches the HP
grid runners with gaitpd's Args and grid (and the ``--hp_*`` flags without
it the plain driver, as in gaitpd), ``--data_parallel`` reaches each
driver with a mesh (of the test process alone) and gaitpd's other Args,
the five config dataclasses have gaitpd's fields and defaults, and
``python -m gaitpd_torch.data.cache`` refuses an empty WearGait directory as
gaitpd's does. Two runs end to end, WearGait and FBG/FoG, one fold of one
epoch, from gaitpd's initial parameters (copied into the port's model by
wrapping each package's ``init_train_state``, here only): per-epoch train
losses within 1e-4 relative and the accuracies within one eval window's
share, the tolerances of tests/test_torch_train_driver.py and
tests/test_torch_fbg_fog_driver.py. The other modes' drivers are held by
those files. gaitpd's ``main`` sets JAX's default matmul precision: it is
set back after each call here. The end-to-end runs take one intra-op
thread (restored after): their steps are many small ops, which the
parallel test workers' threads would otherwise oversubscribe.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import gaitpd.cli as JC  # noqa: E402
import gaitpd.config as JCFG  # noqa: E402
import gaitpd.data.cache as JCACHE  # noqa: E402
import gaitpd.train.baseline_drivers as JB  # noqa: E402
import gaitpd.train.fbg_fog_driver as JF  # noqa: E402
import gaitpd.train.hp_search as JH  # noqa: E402
import gaitpd.train.vmap_cv as JV  # noqa: E402
import gaitpd.train.weargait_driver as JD  # noqa: E402
import gaitpd_torch.cli as TC  # noqa: E402
import gaitpd_torch.config as TCFG  # noqa: E402
import gaitpd_torch.data.cache as TCACHE  # noqa: E402
import gaitpd_torch.train.baseline_drivers as TB  # noqa: E402
import gaitpd_torch.train.fbg_fog_driver as TF  # noqa: E402
import gaitpd_torch.train.hp_search as TH  # noqa: E402
import gaitpd_torch.train.vmap_cv as TV  # noqa: E402
import gaitpd_torch.train.weargait_driver as TD  # noqa: E402
from gaitpd_torch.params import load_flax_params  # noqa: E402

LOSS_RTOL = 1e-4

# each mode with flags off their defaults, including ones its driver ignores
ARGVS = {
    "fbg_fog": ["--mode", "fbg_fog", "--dataset", "fbg", "--modality", "both", "--wm", "ldam",
                "--alpha", "0.3", "--ldam_m", "0.4", "--noise_mul", "0.5", "--epochs", "2",
                "--batch_size", "32", "--use_norm_and_cos", "--synchronized_loading",
                "--aug_mirror_p", "0.5", "--aug_rot_deg", "10", "--ckpt_dir", "ck"],
    "trip": ["--mode", "trip", "--modality", "skeleton", "--seed", "7", "--wm", "ce",
             "--mtl_method", "famo", "--n_folds_cap", "2", "--quiet"],
    "single": ["--mode", "single", "--modality", "sensor", "--consistency_lambda", "0.5",
               "--drw_warmup", "3", "--synthetic_pose_per_joint", "--resume"],
    "single_mod": ["--mode", "single", "--single_mod", "imu", "--wm", "class_wt",
                   "--epochs", "4", "--patience", "2", "--lr", "0.01", "--async_loading"],
    "weargait": ["--mode", "weargait", "--wm", "ldam", "--n_folds", "4", "--test_per_class",
                 "5", "--win_len", "32", "--hop_len", "16", "--enc_out_ch", "96",
                 "--backbone_dim", "4", "--shared_out_ch", "8", "--use_norm", "--use_cosine",
                 "--gcl_m", "0.3", "--gcl_s", "20", "--num_classes", "3", "--data_dir", "d",
                 "--matmul_precision", "high"],
    "fusion": ["--mode", "fusion", "--fusion_type", "cheap_xattn", "--dataset", "fog",
               "--synchronized_loading", "--epochs", "3", "--patience", "4"],
    "deepav": ["--mode", "deepav", "--wm", "class_wt", "--batch_size", "16",
               "--baseline_torch_init"],
    "focal": ["--mode", "focal", "--wm", "gcl", "--seed", "1"],
    "taca": ["--mode", "taca", "--dataset", "fbg", "--n_folds_cap", "1", "--quiet"],
}
# the modes whose driver reads --vmap_folds, or ignores it as gaitpd's does
VMAP_MODES = ("fbg_fog", "trip", "single", "single_mod", "weargait", "fusion", "deepav",
              "focal", "taca")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_precision():
    """gaitpd.cli.main sets JAX's default matmul precision; set it back."""
    saved = jax.config.jax_default_matmul_precision
    yield
    jax.config.update("jax_default_matmul_precision", saved)


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_both_parsers_give_the_same_flags(name):
    argv = ARGVS[name] + ["--vmap_folds", "--hp_lrs", "1e-3", "3e-3"]
    want = vars(JC.build_parser().parse_args(argv))
    got = vars(TC.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert got.pop("device") == "cpu"
    assert got == want
    defaults = vars(TC.build_parser().parse_args([]))
    assert defaults.pop("device") is None
    assert defaults == vars(JC.build_parser().parse_args([]))
    assert TC.MODES == JC.MODES


def _capture(monkeypatch):
    """Stand in for every driver of both packages: each records the Args it
    was called with."""
    got = {}

    def record(side):
        def driver(args, *rest, **kw):
            got[side] = args
            return {}
        return driver

    def record_grid(side):
        def runner(args, grid, *rest, **kw):
            got[side] = args
            got[side + "_grid"] = grid
            return {}
        return runner

    for side, mods in (("jax", (JD, JV, JF, JB, JH)), ("port", (TD, TV, TF, TB, TH))):
        wear, vmapped, fbg, base, hp = mods
        monkeypatch.setattr(wear, "run_cv", record(side))
        monkeypatch.setattr(vmapped, "run_cv_vmapped", record(side + "_vmap"))
        monkeypatch.setattr(vmapped, "run_fbg_fog_vmapped", record(side + "_vmap"))
        monkeypatch.setattr(fbg, "main", record(side))
        monkeypatch.setattr(base, "main", record(side))
        monkeypatch.setattr(hp, "run_weargait_hp_vmapped", record_grid(side + "_hp"))
        monkeypatch.setattr(hp, "run_fbg_fog_hp_vmapped", record_grid(side + "_hp"))
    return got


def _precision_flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())


# every mode without --vmap_folds, and with it where the port takes it (the
# others raise: test_unported_flags_raise_naming_their_item)
ARGS_CASES = [(name, False) for name in sorted(ARGVS)] + [(name, True) for name in VMAP_MODES]


@pytest.mark.parametrize("name,vmap", ARGS_CASES,
                         ids=[f"{n}-{'vmap_folds' if v else 'sequential'}" for n, v in ARGS_CASES])
def test_each_mode_builds_gaitpd_args(monkeypatch, jax_precision, name, vmap):
    got = _capture(monkeypatch)
    argv = ARGVS[name] + (["--vmap_folds"] if vmap else [])
    JC.main(argv)
    flags = _precision_flags()
    TC.main(argv + ["--device", "cpu"])
    assert _precision_flags() == flags  # as they were, after --matmul_precision high too
    vmapped = vmap and name in ("fbg_fog", "trip", "single", "single_mod", "weargait")
    want, mine = (got["jax_vmap"], got["port_vmap"]) if vmapped else (got["jax"], got["port"])
    assert type(mine).__name__ == type(want).__name__
    fields = dataclasses.asdict(mine)
    assert fields.pop("device") == "cpu"
    assert fields == dataclasses.asdict(want)


# --data_parallel, once refused (item 14): with a mode (and --vmap_folds or
# --vmap_hp) it reaches that driver with a mesh, the rest of the Args as
# gaitpd's CLI gives its own
MESH_PORTED = {
    "data_parallel": (["--mode", "weargait", "--data_parallel"], ""),
    "data_parallel_vmap_folds": (["--mode", "weargait", "--data_parallel", "--vmap_folds"],
                                 "_vmap"),
    "data_parallel_vmap_hp": (["--mode", "weargait", "--data_parallel", "--vmap_hp"], "_hp"),
    "data_parallel_fbg_fog": (["--mode", "fbg_fog", "--data_parallel"], ""),
}
# flags once refused (items 19 and 15) and now taken: with --vmap_hp (before
# --vmap_folds) each reaches an HP grid runner ("hp") with the Args and the
# grid gaitpd's CLI gives its own; the --hp_* flags without it, and the
# baseline modes, reach the plain driver ("plain"), as in gaitpd
HP_PORTED = {
    "vmap_hp": (["--mode", "weargait", "--vmap_hp"], "hp"),
    "hp_lrs": (["--mode", "fbg_fog", "--hp_lrs", "1e-3"], "plain"),
    "hp_alphas": (["--mode", "single", "--single_mod", "imu", "--vmap_hp", "--hp_alphas", "0.5"],
                  "hp"),
    "vmap_hp_fbg_fog": (["--mode", "fbg_fog", "--vmap_hp", "--vmap_folds", "--hp_lrs", "1e-3",
                         "3e-3", "--hp_gcl_ss", "20", "--hp_alphas", "0.1", "0.3"], "hp"),
    "vmap_hp_trip": (["--mode", "trip", "--modality", "both", "--vmap_hp"], "hp"),
    "vmap_hp_baseline": (["--mode", "weargait", "--baseline", "taca", "--vmap_hp", "--hp_lrs",
                          "1e-3", "3e-3", "--hp_gcl_ms", "0.1", "0.3", "--vmap_folds"], "hp"),
    "vmap_hp_fusion_mode": (["--mode", "fusion", "--vmap_hp", "--hp_lrs", "1e-3"], "plain"),
    # --fused (item 15), once refused: the plain driver, and with --vmap_hp
    # the grid runner (with --vmap_folds: VMAP_PORTED)
    "fused": (["--mode", "weargait", "--fused"], "plain"),
    "fused_vmap_hp": (["--mode", "weargait", "--fused", "--vmap_hp", "--hp_lrs", "1e-3"], "hp"),
}
# flags and modes --vmap_folds once refused (items 35, 18 and 15) and now takes:
# each reaches run_cv_vmapped or run_fbg_fog_vmapped with the Args gaitpd's
# CLI gives its own
VMAP_PORTED = {
    "vmap_baseline": ["--mode", "weargait", "--vmap_folds", "--baseline", "focal"],
    "vmap_modality_dropout": ["--mode", "weargait", "--vmap_folds", "--modality_dropout", "0.3"],
    "vmap_aug_noise": ["--mode", "weargait", "--vmap_folds", "--aug_noise_std", "0.05"],
    "vmap_aug_axis": ["--mode", "single", "--single_mod", "imu", "--vmap_folds",
                      "--aug_axis_p", "0.2"],
    "vmap_mtl_method": ["--mode", "weargait", "--vmap_folds", "--mtl_method", "famo"],
    "vmap_fbg_fog": ["--mode", "fbg_fog", "--vmap_folds"],
    "vmap_trip": ["--mode", "trip", "--vmap_folds"],
    "vmap_single": ["--mode", "single", "--vmap_folds"],
    "vmap_fused": ["--mode", "weargait", "--vmap_folds", "--fused"],
}


@pytest.mark.parametrize("name", sorted(MESH_PORTED))
def test_unported_flags_raise_naming_their_item(monkeypatch, capsys, jax_precision, name):
    """--data_parallel, once refused: the port's mesh over its process
    group (one rank here), gaitpd's over its 8 virtual devices; the other
    fields equal."""
    got = _capture(monkeypatch)
    argv, side = MESH_PORTED[name]
    JC.main(argv + ["--synthetic"])
    try:
        TC.main(argv + ["--synthetic", "--device", "cpu"])
    finally:
        torch.distributed.destroy_process_group()
    assert "Data-parallel mesh over 1 device(s)" in capsys.readouterr().out
    want, mine = got["jax" + side], got["port" + side]
    assert type(mine).__name__ == type(want).__name__
    assert mine.mesh.size() == 1 and want.mesh is not None
    fields = {f.name: getattr(mine, f.name) for f in dataclasses.fields(mine)}
    assert fields.pop("device") == "cpu"
    fields.pop("mesh")
    assert fields == {f.name: getattr(want, f.name) for f in dataclasses.fields(want)
                      if f.name != "mesh"}


@pytest.mark.parametrize("name", sorted(HP_PORTED))
def test_vmap_hp_reaches_the_grid_runners(monkeypatch, jax_precision, name):
    got = _capture(monkeypatch)
    argv, where = HP_PORTED[name]
    argv = argv + ["--synthetic"]
    JC.main(argv)
    TC.main(argv + ["--device", "cpu"])
    side = "_hp" if where == "hp" else ""
    assert ("port_hp" in got) == ("jax_hp" in got) == (where == "hp")
    want, mine = got["jax" + side], got["port" + side]
    assert type(mine).__name__ == type(want).__name__
    fields = dataclasses.asdict(mine)
    assert fields.pop("device") == "cpu"
    assert fields == dataclasses.asdict(want)
    if where == "hp":
        assert got["port_hp_grid"] == got["jax_hp_grid"]


@pytest.mark.parametrize("name", sorted(VMAP_PORTED))
def test_vmap_folds_takes_flags_it_once_refused(monkeypatch, jax_precision, name):
    got = _capture(monkeypatch)
    argv = VMAP_PORTED[name] + ["--synthetic"]
    JC.main(argv)
    TC.main(argv + ["--device", "cpu"])
    fields = dataclasses.asdict(got["port_vmap"])
    assert fields.pop("device") == "cpu"
    assert fields == dataclasses.asdict(got["jax_vmap"])


@pytest.mark.parametrize("name", ["WearGaitConfig", "LossConfig", "MTLConfig", "MeshConfig",
                                  "ExperimentConfig"])
def test_config_dataclasses_match_gaitpd(name):
    mine, want = getattr(TCFG, name), getattr(JCFG, name)
    assert [f.name for f in dataclasses.fields(mine)] == [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(mine()) == dataclasses.asdict(want())
    if name == "WearGaitConfig":
        assert mine().modal_dims == want().modal_dims


def test_cache_main_refuses_an_empty_weargait_directory(monkeypatch, tmp_path):
    monkeypatch.setenv("GAITPD_DATA_ROOT", str(tmp_path))
    monkeypatch.setattr(sys, "argv", ["cache", "--datasets", "weargait"])
    with pytest.raises(FileNotFoundError, match="No WearGait .pkl files found") as want:
        JCACHE.main()
    with pytest.raises(FileNotFoundError, match="No WearGait .pkl files found") as got:
        TCACHE.main(["--datasets", "weargait"])
    assert str(got.value).replace("gaitpd_torch", "gaitpd") == str(want.value)


def _record_runs(monkeypatch, j_mod, t_mod, rec):
    """Wrap both drivers' init (gaitpd's recorded, the port's model loaded
    from it), train epochs (their losses recorded) and eval epochs (the
    eval pool's size)."""
    orig_init, orig_train, orig_eval = (j_mod.init_train_state, j_mod.run_train_epoch,
                                        j_mod.run_eval_epoch)

    def j_init(*a, **k):
        state, partition = orig_init(*a, **k)
        rec["init"] = jax.device_get(state.params)
        return state, partition

    def j_train(*a, **k):
        state, tr = orig_train(*a, **k)
        rec["jax"].append(np.asarray(tr.loss))
        return state, tr

    def j_eval(runner, state, data, *a, **k):
        rec["n_eval"] = max(rec["n_eval"], len(data.eval_pool))
        return orig_eval(runner, state, data, *a, **k)

    orig_t_init, orig_t_train = t_mod.init_train_state, t_mod.run_train_epoch

    def t_init(model, *a, **k):
        load_flax_params(model, rec["init"])
        return orig_t_init(model, *a, **k)

    def t_train(*a, **k):
        state, tr = orig_t_train(*a, **k)
        rec["port"].append(np.asarray(tr.loss))
        return state, tr

    for mod, attr, fn in ((j_mod, "init_train_state", j_init), (j_mod, "run_train_epoch", j_train),
                          (j_mod, "run_eval_epoch", j_eval), (t_mod, "init_train_state", t_init),
                          (t_mod, "run_train_epoch", t_train)):
        monkeypatch.setattr(mod, attr, fn)


E2E = {
    "weargait": (["--mode", "weargait", "--n_folds", "2", "--test_per_class", "3"], JD, TD),
    "fbg_fog": (["--mode", "fbg_fog", "--dataset", "fog", "--modality", "multimodal"], JF, TF),
}


@pytest.mark.parametrize("name", sorted(E2E))
def test_main_end_to_end_matches_gaitpd(monkeypatch, jax_precision, one_thread, name):
    argv, j_mod, t_mod = E2E[name]
    argv = argv + ["--synthetic", "--epochs", "1", "--n_folds_cap", "1", "--seed", "0",
                   "--quiet"]
    rec = {"init": None, "jax": [], "port": [], "n_eval": 0}
    _record_runs(monkeypatch, j_mod, t_mod, rec)
    want = JC.main(argv)
    got = TC.main(argv + ["--device", "cpu"])
    assert len(rec["port"]) == len(rec["jax"]) == 1
    np.testing.assert_allclose(rec["port"][0], rec["jax"][0], rtol=LOSS_RTOL)
    share = 100.0 / rec["n_eval"] + 1e-4
    if name == "weargait":
        assert set(got["masks"]) == set(want["masks"]) == set(TD.MASK_COMBOS)
        for mk in TD.MASK_COMBOS:
            assert abs(got["masks"][mk] - want["masks"][mk]) <= share, mk
        assert abs(got["macro"][0] - want["macro"][0]) <= share
    else:
        assert list(got) == list(want) == ["multimodal"]
        for key in ("skel", "sensor", "avg"):
            assert abs(got["multimodal"][key] - want["multimodal"][key]) <= share, key
