"""The port's FBG/FoG data path against gaitpd's on the CPU, exactly: the
synthetic readers, the folds and label dicts, the sampling functions, the
fold assembly, build_fusion_fold (every dataset, modality and loading mode), the pose helpers,
the raw readers on the fixture trees of tests/test_reader_oracle.py (label
tables as CSV), and the port's reader cache, which refuses a pickle that
names a class outside builtins, numpy and gaitpd_torch.

Arrays, labels, keys and pools must be equal: both packages make them with
numpy, by the same calls in the same order.
"""

import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pd = pytest.importorskip("pandas")

from test_reader_oracle import _fog_fixture_tree  # noqa: E402

from gaitpd import config as JCFG  # noqa: E402
from gaitpd.data import cache as JC  # noqa: E402
from gaitpd.data import fbg_fog as JF  # noqa: E402
from gaitpd.data import paths as JP  # noqa: E402
from gaitpd.data import pipeline as JPL  # noqa: E402
from gaitpd.data import readers as JR  # noqa: E402
from gaitpd.data import sampler as JS  # noqa: E402
from gaitpd.data import synthetic as JSYN  # noqa: E402
from gaitpd.train import cv as JCV  # noqa: E402
from gaitpd_torch import config as TCFG  # noqa: E402
from gaitpd_torch.data import cache as TC  # noqa: E402
from gaitpd_torch.data import fbg_fog as TF  # noqa: E402
from gaitpd_torch.data import paths as TP  # noqa: E402
from gaitpd_torch.data import pipeline as TPL  # noqa: E402
from gaitpd_torch.data import readers as TR  # noqa: E402
from gaitpd_torch.data import sampler as TS  # noqa: E402
from gaitpd_torch.data import synthetic as TSYN  # noqa: E402
from gaitpd_torch.train import cv as TCV  # noqa: E402

READERS = {"fbg": "make_fbg_reader", "fog": "make_fog_reader"}
READER_KW = [dict(), dict(seed=3, strength=0.5, pose_per_joint=True),
             dict(n_subjects=6, class_skew=False, seed=1)]


def _assert_dicts_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("kw", READER_KW, ids=["default", "per_joint", "balanced"])
@pytest.mark.parametrize("dataset", sorted(READERS))
def test_synthetic_readers_bitwise(dataset, kw):
    j, t = getattr(JSYN, READERS[dataset])(**kw), getattr(TSYN, READERS[dataset])(**kw)
    _assert_dicts_equal(t.pose_dict, j.pose_dict)
    _assert_dicts_equal(t.sensor_dict, j.sensor_dict)
    if dataset == "fog":
        assert t.labels_dict == j.labels_dict and t.sensor_length == j.sensor_length
    else:
        assert t.pose_label_dict == j.pose_label_dict
        assert t.sensor_label_dict == j.sensor_label_dict
        _assert_dicts_equal(t.metadata_dict, j.metadata_dict)


def _label_dict(mod, dataset, reader):
    return mod.fbg_label_dict(reader) if dataset == "fbg" else mod.fog_label_dict(reader)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("dataset", sorted(READERS))
def test_folds_and_label_dicts(dataset, seed):
    reader = getattr(JSYN, READERS[dataset])(n_subjects=12, seed=seed)
    assert _label_dict(TCV, dataset, reader) == _label_dict(JCV, dataset, reader)
    labels = _label_dict(JCV, dataset, reader)
    want = JCV.generate_class_stratified_folds(labels, np.random.default_rng(seed))
    got = TCV.generate_class_stratified_folds(labels, np.random.default_rng(seed))
    # 12 subjects, 4 a class; FoG leaves out SUB10, of class 1
    assert got == want and len(got) == (4 if dataset == "fbg" else 3)
    assert TCV.FOG_EXCLUDED_SUBJECTS == JCV.FOG_EXCLUDED_SUBJECTS
    excluded = {"SUB10": [1], "SUB11": [2, 0], "SUB22": [0]}
    r = type("R", (), {"labels_dict": excluded})()
    assert TCV.fog_label_dict(r) == JCV.fog_label_dict(r) == {"SUB11": 2}


def test_sampler_functions():
    rng_keys = np.random.default_rng(0)
    pose = [f"SUB{s:02d}_{i}_{j}" for s in range(4) for i in range(3) for j in range(2)]
    sens = [f"SUB{s:02d}_{i}_{j}" for s in range(4) for i in range(3) for j in range(3)
            if rng_keys.uniform() < 0.8]
    assert TS.group_by_subject(pose) == JS.group_by_subject(pose)
    assert TS.group_by_subject(pose, 2) == JS.group_by_subject(pose, 2)
    pairs = TS.build_synced_pairs(TS.group_by_subject(pose), TS.group_by_subject(sens))
    assert pairs == JS.build_synced_pairs(JS.group_by_subject(pose), JS.group_by_subject(sens))
    label = lambda k: int(k[3:5]) % 3  # noqa: E731
    subj = lambda k: k.split("_")[0]  # noqa: E731
    for seed in range(3):
        def both(name, *args):
            want = getattr(JS, name)(*args, np.random.default_rng(seed))
            got = getattr(TS, name)(*args, np.random.default_rng(seed))
            return got, want

        for got, want in (both("oversample_equally", pairs, label),
                          both("oversample_keys_balanced", pose, label),
                          both("equalize_lengths", pose[:7], sens),
                          both("equalize_lengths", sens, pose[:7]),
                          both("subject_balanced_async_eval", pose, sens,
                               ["SUB01", "SUB03"], subj)):
            assert got == want
        for shuffle in (True, False):
            got = TS.async_epoch_order(7, 11, np.random.default_rng(seed), shuffle)
            want = JS.async_epoch_order(7, 11, np.random.default_rng(seed), shuffle)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
                assert g.dtype == w.dtype
    assert TS.group_by_subject_fn(sens, subj) == JS.group_by_subject_fn(sens, subj)
    with pytest.raises(ValueError, match="lacks data"):
        TS.subject_balanced_async_eval(pose, sens, ["SUB09"], subj, np.random.default_rng(0))


def _assert_arrays_equal(got, want):
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.y, want.y)
    assert got.x.dtype == want.x.dtype and got.y.dtype == want.y.dtype
    assert got.keys == want.keys and got.key_index == want.key_index


FOLD_CASES = [(d, m, s) for d in ("fbg", "fog") for m in ("skeleton", "sensor", "multimodal")
              for s in (False, True)]


@pytest.mark.parametrize("dataset, modality, sync", FOLD_CASES,
                         ids=[f"{d}-{m}-{'sync' if s else 'async'}" for d, m, s in FOLD_CASES])
def test_build_fusion_fold_equal(dataset, modality, sync):
    j_reader = getattr(JSYN, READERS[dataset])(seed=2)
    t_reader = getattr(TSYN, READERS[dataset])(seed=2)
    dims = JCFG.FBG_FOG_DIMS[dataset]
    train, evals = JCV.generate_class_stratified_folds(
        _label_dict(JCV, dataset, j_reader), np.random.default_rng(0))[1]
    kw = dict(synchronized=sync, seed=11, pad_skel=dims.pose_length,
              pad_sens=dims.sensor_length, modality=modality)
    if dataset == "fbg" and sync and modality == "multimodal":
        for mod, reader in ((JF, j_reader), (TF, t_reader)):
            with pytest.raises(ValueError, match="no aligned pairs"):
                mod.build_fusion_fold(dataset, reader, train, evals, **kw)
        return
    want = JF.build_fusion_fold(dataset, j_reader, train, evals, **kw)
    got = TF.build_fusion_fold(dataset, t_reader, train, evals, **kw)
    for name in ("train_pose", "train_sens", "eval_pose", "eval_sens"):
        _assert_arrays_equal(getattr(got, name), getattr(want, name))
    for name in ("train_pool", "eval_pool"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
        assert getattr(got, name).dtype == getattr(want, name).dtype
    assert (got.synchronized, got.modality) == (want.synchronized, want.modality)


def test_pose_helpers():
    rng = np.random.default_rng(0)
    seq = rng.normal(size=(30, 17, 3)).astype(np.float32)
    np.testing.assert_array_equal(TF.center_pose(seq), JF.center_pose(seq))
    np.testing.assert_array_equal(TF.minmax_pose(seq), JF.minmax_pose(seq))
    poses = {"a": seq, "b": seq[:12] * 2.0}
    _assert_dicts_equal(TF.preprocess_pose_dict(poses), JF.preprocess_pose_dict(poses))
    grf = {"SUB01_on": rng.normal(size=(101, 4, 3)), "SUB02_off": rng.normal(size=(40, 3))}
    lab = {"SUB01_on": 1, "SUB02_off": 2}
    got, want = TF.split_grf_trials(grf, lab, 65), JF.split_grf_trials(grf, lab, 65)
    _assert_dicts_equal(got[0], want[0])
    assert got[1] == want[1]
    stack = rng.normal(size=(5, 30, 7, 3)).astype(np.float32)
    x = torch.from_numpy(stack)
    np.testing.assert_array_equal(TPL.center_poses(x).numpy(),
                                  np.asarray(JPL.center_poses(stack)))
    np.testing.assert_allclose(TPL.minmax_poses(x).numpy(),
                               np.asarray(JPL.minmax_poses(stack)), rtol=0, atol=1e-7)
    mean, std = stack.mean((0, 1)), stack.std((0, 1))
    std[0, 0] = 1e-5  # below the floor: taken as 1
    np.testing.assert_allclose(TPL.zscore_poses(x, mean, std).numpy(),
                               np.asarray(JPL.zscore_poses(stack, mean, std)), rtol=1e-7)


def test_config_copy():
    assert TCFG.FBG_FOG_DIMS == {k: TCFG.ModelDims(**vars(v))
                                 for k, v in JCFG.FBG_FOG_DIMS.items()}
    assert vars(TCFG.FBG_FOG_TRAIN["fog"]) == vars(JCFG.FBG_FOG_TRAIN["fog"])
    for name in ("walk", "turn", "FoG", "weargait"):
        assert TCFG.normalize_dataset_name(name) == JCFG.normalize_dataset_name(name)
        assert TCFG.raw_reader_dataset_name(name) == JCFG.raw_reader_dataset_name(name)
    with pytest.raises(ValueError):
        TCFG.normalize_dataset_name("nope")


def _read_csv_as_excel(monkeypatch):
    monkeypatch.setattr(pd, "read_excel", lambda path, **k: pd.read_csv(path))


def test_fog_reader_equals_gaitpd(tmp_path, monkeypatch):
    _read_csv_as_excel(monkeypatch)
    pose_dir, imu, labels, lifted = _fog_fixture_tree(tmp_path)
    want = JR.FoGReader(pose_dir, imu, labels, lifted)
    got = TR.FoGReader(pose_dir, imu, labels, lifted)
    _assert_dicts_equal(got.pose_dict, want.pose_dict)
    _assert_dicts_equal(got.sensor_dict, want.sensor_dict)
    assert got.sensor_length == want.sensor_length
    assert got.labels_dict == want.labels_dict
    assert "SUB21_1_1" not in got.pose_dict and got.labels_dict["SUB19"] == [2]
    assert TR.FOG_BAD_POSE_SEGMENTS == JR.FOG_BAD_POSE_SEGMENTS
    for n in (1, 5, 36, 40):
        seq = np.arange(37 * 2).reshape(37, 2)
        for g, w in zip(TR.segment_equal(seq, n), JR.segment_equal(seq, n)):
            np.testing.assert_array_equal(g, w)
        assert len(TR.segment_equal(seq, n)) == len(JR.segment_equal(seq, n))


def _fbg_tree(root):
    joints, grf = root / "FBG", root / "GRF"
    joints.mkdir()
    grf.mkdir()
    rng = np.random.default_rng(0)
    for name in ("SUB01_on_walk_1_0", "SUB01_off_walk_2_1", "SUB02_on_walk_1_0"):
        np.save(joints / f"{name}.npy", rng.normal(size=(30, 51)) * 1000)
    np.save(grf / "SUB01_on_left.npy", rng.normal(size=(40, 3)))
    np.save(grf / "SUB01_off_right.npy", rng.normal(size=(35, 3)))
    np.save(grf / "SUB02_on_left.npy", np.zeros((10, 0)))  # excluded: no columns
    np.save(grf / "SUB02_on_right.npy", rng.normal(size=(20, 3)))
    pd.DataFrame({
        "ID": ["SUB01", "SUB02"],
        "ON - UPDRS-III - walking": [2, 3],
        "OFF - UPDRS-III - walking": [4, 2],
        "Gender": ["M", "F"],
        "Age": [61, 70],
        "Height (cm)": [170, 182],
        "Weight (kg)": [70.5, 88.0],
        "BMI (kg/m2)": [24.4, 26.6],
    }).to_csv(root / "PDGinfo.csv", index=False)
    return joints, grf, root / "PDGinfo.csv"


def test_fbg_reader_equals_gaitpd(tmp_path, monkeypatch):
    _read_csv_as_excel(monkeypatch)
    args = _fbg_tree(tmp_path)
    want, got = JR.FBGReader(*args), TR.FBGReader(*args)
    _assert_dicts_equal(got.pose_dict, want.pose_dict)
    _assert_dicts_equal(got.sensor_dict, want.sensor_dict)
    assert "SUB02_on_left" not in got.sensor_dict
    assert got.sensor_label_dict == want.sensor_label_dict
    assert got.pose_label_dict == want.pose_label_dict
    assert got.video_names == want.video_names
    assert list(got.metadata_dict) == list(want.metadata_dict)
    for k in want.metadata_dict:
        np.testing.assert_array_equal(np.asarray(got.metadata_dict[k], float),
                                      np.asarray(want.metadata_dict[k], float), err_msg=k)
    # the label tables are not kept: the reader pickles without pandas
    assert not hasattr(got, "label_list") and not hasattr(got, "metadata_table")


def test_pd_paths(tmp_path, monkeypatch):
    monkeypatch.setenv("GAITPD_DATA_ROOT", str(tmp_path))
    (tmp_path / "FoG" / "IMU").mkdir(parents=True)
    assert TP.get_pd_paths() == JP.get_pd_paths()
    assert TP.get_pd_paths()["turn"]["sensor_path"] == tmp_path / "FoG" / "IMU"


def test_reader_cache_round_trip(tmp_path, monkeypatch, capsys):
    fog = TSYN.make_fog_reader(n_subjects=3, segments=1)
    monkeypatch.setattr(TC, "build_reader", lambda dataset: fog)
    built = TC.load_reader("turn", root=tmp_path)
    assert built is fog
    path = TC.reader_cache_path("fog", tmp_path)
    assert path.name == "fog_reader.gaitpd_torch.pkl" and path.exists()
    assert path.name != JC.reader_cache_path("fog", tmp_path).name
    monkeypatch.setattr(TC, "build_reader", None)  # the cache, never a build
    loaded = TC.load_reader("fog", root=tmp_path)
    assert "Loading fog reader" in capsys.readouterr().out
    _assert_dicts_equal(loaded.pose_dict, fog.pose_dict)
    assert loaded.labels_dict == fog.labels_dict
    assert TC.summarize_reader("fog", loaded) == JC.summarize_reader("fog", fog)
    path.rename(TC.legacy_reader_cache_path("fog", tmp_path))
    assert TC.load_reader("fog", root=tmp_path).labels_dict == fog.labels_dict


def test_reader_cache_refuses_gaitpd_classes(tmp_path):
    with TC.reader_cache_path("fog", tmp_path).open("wb") as f:
        pickle.dump(JSYN.make_fog_reader(n_subjects=3, segments=1), f)
    with pytest.raises(pickle.UnpicklingError, match="gaitpd.data.synthetic.SyntheticFoGReader"):
        TC.load_reader("fog", root=tmp_path)
    with TC.reader_cache_path("fbg", tmp_path).open("wb") as f:
        pickle.dump(pd.DataFrame({"a": [1]}), f)
    with pytest.raises(pickle.UnpicklingError, match="pandas"):
        TC.load_reader("fbg", root=tmp_path)
