"""Real WearGait data in the port against gaitpd on the CPU: the pickle
readers, load_pkl_streams, the raw CSV preprocessor, the path registry and
run_cv on the preprocessed pickles.

The fixtures are per-subject CSVs written as tests/test_data.py writes them
(60 Hz, standing rows, forces, CoP, insole and 8-site IMU accelerations),
here from seeded generators, long enough for three 64-frame windows at
30 Hz, with a PD offset so the model learns; one subject lacks the right
insole's accelerations and one has an all-NaN CoP column. Arrays and
frames must be exactly equal. run_cv goes through test_torch_train_driver's
harness (gaitpd's initial parameters copied into the port's model): losses
within LOSS_RTOL, the 7-subset table equal.
"""

import numpy as np
import pytest

pd = pytest.importorskip("pandas")
jax = pytest.importorskip("jax")

from test_torch_train_driver import LOSS_RTOL, _run_both  # noqa: E402

from gaitpd.data import cache as JC  # noqa: E402
from gaitpd.data import paths as JP  # noqa: E402
from gaitpd.data import preprocess_weargait as JPW  # noqa: E402
from gaitpd.data import readers as JR  # noqa: E402
from gaitpd.data import weargait as JW  # noqa: E402
from gaitpd_torch.data import cache as TC  # noqa: E402
from gaitpd_torch.data import paths as TP  # noqa: E402
from gaitpd_torch.data import preprocess_weargait as TPW  # noqa: E402
from gaitpd_torch.data import readers as TR  # noqa: E402
from gaitpd_torch.data import weargait as TW  # noqa: E402
from gaitpd_torch.train import weargait_driver as TD  # noqa: E402

N_PER_CLASS = 8  # 2 folds x 3 test subjects a class, and 2 to train on
ROWS = 480  # 60 Hz rows -> about 235 30 Hz rows -> 3 windows of 64


def _subject_csv(root, sid, seed, label):
    rng = np.random.default_rng(seed)
    t = ROWS
    df = pd.DataFrame({"Time": [f"{x:.4f} sec" for x in np.arange(t) / 60]})
    df["GeneralEvent"] = ["walking"] * (t - 10) + ["Standing"] * 10
    for c in ("L Foot Pressure", "R Foot Pressure", "LTotalForce", "RTotalForce"):
        df[c] = rng.uniform(0, 700, t) + 150 * label
    for c in ("LCoP_X", "LCoP_Y", "RCoP_X", "RCoP_Y"):
        df[c] = rng.normal(size=t) + label
    if seed % 5 == 1:
        df["RCoP_Y"] = np.nan
    for side in ("Linsole", "Rinsole"):
        if side == "Rinsole" and seed % 7 == 3:
            continue
        for ax in "XYZ":
            df[f"{side}:Acc_{ax}"] = rng.normal(size=t) + 0.5 * label
    for s in JPW.IMU_SITES:
        for ax in "ENU":
            df[f"{s}_FreeAcc_{ax}"] = rng.normal(size=t) * (1 + label)
    df.to_csv(root / f"{sid}_SelfPace_matTURN.csv", index=False)


def _demo(path, sids):
    rows = [["junk"] * 3, ["Subject ID", "Weight (kg)", "Other"]]
    rows += [[sid, f"{60 + i}.5", "x"] for i, sid in enumerate(sids)]
    pd.DataFrame(rows).to_csv(path, index=False, header=False)
    return path


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """The raw CSV roots and demographics: 8 PD and 8 HC subjects."""
    root = tmp_path_factory.mktemp("weargait_raw")
    dirs = {"PD": root / "PD", "HC": root / "HC"}
    for label, (group, d) in enumerate((("HC", dirs["HC"]), ("PD", dirs["PD"]))):
        d.mkdir()
        sids = [f"{group}{i:03d}" for i in range(N_PER_CLASS)]
        for i, sid in enumerate(sids):
            _subject_csv(d, sid, 100 * label + i, label)
        _demo(root / f"{group.lower()}_demo.csv", sids)
    return root


def _preprocess(module, raw, out):
    return module.run_end_to_end(raw / "HC", raw / "PD", raw / "hc_demo.csv",
                                 raw / "pd_demo.csv", out)


@pytest.fixture(scope="module")
def pickles(raw, tmp_path_factory):
    out = tmp_path_factory.mktemp("weargait_pkl")
    assert _preprocess(TPW, raw, out) == 2 * N_PER_CLASS
    return out


def test_preprocessor_matches_gaitpd(raw, pickles, tmp_path):
    assert _preprocess(JPW, raw, tmp_path) == 2 * N_PER_CLASS
    names = sorted(p.name for p in pickles.glob("*.pkl"))
    assert names == sorted(p.name for p in tmp_path.glob("*.pkl"))
    assert len(names) == 3 * 2 * N_PER_CLASS
    for name in names:
        pd.testing.assert_frame_equal(pd.read_pickle(pickles / name),
                                      pd.read_pickle(tmp_path / name), check_exact=True)


def test_load_pkl_streams_matches_gaitpd(pickles):
    ids = TR.discover_weargait_subjects(pickles)
    assert ids == JR.discover_weargait_subjects(pickles)
    subjects = ids[0] + ids[1] + ["absent001"]  # a subject without pickles: empty streams
    got = TW.load_pkl_streams(pickles, subjects)
    want = JW.load_pkl_streams(pickles, subjects)
    assert got.keys() == want.keys()
    for sid in subjects:
        for m in TW.MODALITIES:
            assert got[sid][m].dtype == want[sid][m].dtype
            np.testing.assert_array_equal(got[sid][m], want[sid][m], err_msg=f"{sid} {m}")
    assert got["absent001"]["imu"].shape == (0, 24)
    # hc003 has no right-insole accelerations: zeros in their three channels
    assert got["hc003"]["insole"].shape[1] == 13 and not got["hc003"]["insole"][:, 10:].any()


def _frames(seed):
    rng = np.random.default_rng(seed)
    t = 9
    vec = lambda: [tuple(r) for r in rng.normal(size=(t, 3))]  # noqa: E731
    walkway = pd.DataFrame({"Time": np.arange(t) / 30, "L Foot Pressure_BW": rng.normal(size=t),
                            "R Foot Pressure_BW": np.full(t, np.nan)})
    insole = pd.DataFrame({"LTotalForce_BW": rng.normal(size=t), "LCoP_X": ["1.5"] * t,
                           "Linsole_Acc": vec(), "Rinsole_Acc": vec()})
    insole.loc[2, "LTotalForce_BW"] = np.nan
    imu = pd.DataFrame({f"{s}_FreeAcc": vec() for s in TR.IMU_SITES[::2]})
    return {"walkway": walkway, "insole": insole, "imu": imu}


@pytest.mark.parametrize("seed", [0, 1])
def test_readers_match_gaitpd(seed):
    frames = _frames(seed)
    for name, tr, jr in (("walkway", TR.walkway_df_to_array, JR.walkway_df_to_array),
                         ("insole", TR.expand_insole_df, JR.expand_insole_df),
                         ("imu", TR.expand_imu_df, JR.expand_imu_df)):
        df = frames[name]
        cols = list(df.columns)
        got, want = tr(df), jr(df)
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(tr(pd.DataFrame()), jr(pd.DataFrame()))
        assert list(df.columns) == cols  # the caller's frame keeps its tuple columns
    assert TR.IMU_FIXED == JR.IMU_FIXED and TR.INSOLE_FIXED == JR.INSOLE_FIXED
    assert TR.WALKWAY_FIXED == JR.WALKWAY_FIXED


def test_subjects_from_the_raw_roots_match_gaitpd(raw, pickles):
    args = (pickles, raw / "PD", raw / "HC")
    assert TR.discover_weargait_subjects(*args) == JR.discover_weargait_subjects(*args)
    assert TR.discover_weargait_subjects(*args)[0][0] == "PD000"


def test_paths_and_pickle_count_match_gaitpd(monkeypatch, pickles, tmp_path):
    assert TP.data_root() == JP.data_root()
    monkeypatch.setenv("GAITPD_DATA_ROOT", str(tmp_path))
    assert TP.weargait_paths() == JP.weargait_paths()
    assert TP.cache_dir() == JP.cache_dir() == tmp_path / "cache"
    assert TC.count_weargait_pickles() == JC.count_weargait_pickles() == 0
    assert TC.count_weargait_pickles(pickles) == JC.count_weargait_pickles(pickles) == 48
    with pytest.raises(FileNotFoundError, match="no WearGait pickles"):
        TD.run_cv(TD.WearGaitArgs(epochs=1, device="cpu", verbose=False))


def test_run_cv_on_real_data_matches_gaitpd(monkeypatch, pickles):
    kw = dict(n_folds=2, test_per_class=3, epochs=2, patience=50, synthetic=False,
              data_dir=str(pickles), verbose=False, seed=0, n_folds_cap=1, wm="gcl", alpha=0.5)
    ref, got, rec = _run_both(monkeypatch, kw)
    assert len(rec["port"]) == len(rec["jax"]) == kw["epochs"]
    for ep, (p, j) in enumerate(zip(rec["port"], rec["jax"]), 1):
        np.testing.assert_allclose(p, j, rtol=LOSS_RTOL, err_msg=f"epoch {ep} train losses")
    assert got["masks"] == ref["masks"]
    assert got["macro"] == pytest.approx(ref["macro"])
