"""gaitpd_torch.serve against gaitpd.serve on the same flax parameters, stats
and numpy inputs: batched windows for all 7 modality subsets, raw streams,
and the streaming sessions over the native ring buffer. The port's engine
runs with device="cpu". Tolerance: see test_torch_pipeline.
"""

import itertools
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaitpd import serve as jserve  # noqa: E402
from gaitpd.models.multitask import WearGaitThreeModal as FlaxModel  # noqa: E402
from gaitpd_torch import serve as tserve  # noqa: E402
from gaitpd_torch.models.multitask import WearGaitThreeModal  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
SUBSETS = [s for r in (1, 2, 3) for s in itertools.combinations(tserve.MODALITIES, r)]


def _variables(seed, **kw):
    rng = np.random.default_rng(seed)
    xs = [jnp.ones((2, 64, c)) for c in (2, 13, 24)]
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.normal(size=a.shape) * 0.1).astype(np.float32),
        FlaxModel(**kw).init(jax.random.PRNGKey(seed), *xs),
    )


def _stats(seed):
    rng = np.random.default_rng(seed)
    return {m: ((rng.normal(size=c) * 0.5).astype(np.float32),
                (np.abs(rng.normal(size=c)) + 0.5).astype(np.float32))
            for m, c in tserve.CHANNELS.items()}


def _engines(seed=0, win=64, hop=64, **kw):
    v, st = _variables(seed, **kw), _stats(seed)
    model = dict(model=FlaxModel(**kw)) if kw else {}
    port_model = dict(model=WearGaitThreeModal(**kw)) if kw else {}
    return (jserve.WearGaitEngine(v, st, win=win, hop=hop, **model),
            tserve.WearGaitEngine(v, st, win=win, hop=hop, device="cpu", **port_model))


@pytest.fixture(scope="module")
def engines():
    return _engines()


def test_channels_match():
    assert tserve.CHANNELS == jserve.CHANNELS
    assert tserve.MODALITIES == jserve.MODALITIES


@pytest.mark.parametrize("subset", SUBSETS, ids="+".join)
def test_predict_windows_subsets_match(engines, subset):
    ref_engine, engine = engines
    rng = np.random.default_rng(len(subset))
    wins = {m: rng.normal(size=(7, 64, tserve.CHANNELS[m])).astype(np.float32)
            for m in subset}
    got = engine.predict_windows(wins)
    assert got.shape == (7, 2)
    np.testing.assert_allclose(got, ref_engine.predict_windows(wins), **TOL)
    np.testing.assert_allclose(got.sum(1), 1.0, **TOL)


@pytest.mark.parametrize("use_norm,use_cosine,synchronized",
                         [(True, True, True), (False, False, False)])
def test_predict_windows_other_heads_match(use_norm, use_cosine, synchronized):
    ref_engine, engine = _engines(1, use_norm=use_norm, use_cosine=use_cosine,
                                  synchronized=synchronized)
    rng = np.random.default_rng(9)
    wins = {m: rng.normal(size=(4, 64, c)).astype(np.float32)
            for m, c in tserve.CHANNELS.items()}
    for subset in SUBSETS:
        part = {m: wins[m] for m in subset}
        np.testing.assert_allclose(engine.predict_windows(part),
                                   ref_engine.predict_windows(part), **TOL)


@pytest.mark.parametrize("win,hop", [(64, 64), (64, 32), (64, 24)])
def test_predict_streams_match(win, hop):
    ref_engine, engine = _engines(2, win=win, hop=hop)
    rng = np.random.default_rng(hop)
    streams = {
        "walkway": rng.normal(size=(300, 2)).astype(np.float32),
        "insole": rng.normal(size=(270, 13)).astype(np.float32),
        "imu": rng.normal(size=(333, 24)).astype(np.float32),
    }
    streams["imu"][5, 3] = np.nan  # z-score guards on the serving path
    streams["insole"][40, 0] = np.inf
    for subset in SUBSETS:
        part = {m: streams[m] for m in subset}
        got, ref = engine.predict_streams(part), ref_engine.predict_streams(part)
        np.testing.assert_allclose(got["window_probs"], ref["window_probs"], **TOL)
        np.testing.assert_allclose(got["subject_probs"], ref["subject_probs"], **TOL)
        assert got["pred"] == ref["pred"]


def test_predict_streams_errors(engines):
    _, engine = engines
    with pytest.raises(ValueError):
        engine.predict_streams({"imu": np.zeros((10, 24), np.float32)})
    with pytest.raises(ValueError):
        engine.predict_streams({"gps": np.zeros((100, 2), np.float32)})
    with pytest.raises(ValueError):
        engine.predict_windows({})


def test_engine_from_module_equals_engine_from_params():
    v = _variables(3)
    ref = tserve.WearGaitEngine(v, device="cpu")
    module = ref.model
    engine = tserve.WearGaitEngine(module, device="cpu")
    assert engine.model is not module  # copied
    rng = np.random.default_rng(3)
    wins = {"imu": rng.normal(size=(3, 64, 24)).astype(np.float32)}
    np.testing.assert_array_equal(engine.predict_windows(wins), ref.predict_windows(wins))


def test_no_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.WearGaitEngine(WearGaitThreeModal())
    with pytest.raises(RuntimeError):
        tserve.WearGaitEngine(WearGaitThreeModal(), device="cuda")


def test_load_stats_matches(tmp_path):
    assert tserve.WearGaitEngine._load_stats(tmp_path) is None
    (tmp_path / "stats.json").write_text(json.dumps(
        {"imu": [[0.5] * 24, [2.0] * 24], "walkway": [[1.0, 2.0], [3.0, 4.0]]}))
    got = tserve.WearGaitEngine._load_stats(tmp_path)
    ref = jserve.WearGaitEngine._load_stats(tmp_path)
    assert got.keys() == ref.keys()
    for m in got:
        for g, r in zip(got[m], ref[m]):
            np.testing.assert_array_equal(g, r)
            assert g.dtype == np.float32


def _push_all(pairs, pushes):
    """Replay the same drips into (port, reference) session pairs."""
    for (ts, js), drips in zip(pairs, pushes):
        for m, x in drips:
            ts.push(m, x)
            js.push(m, x)


def test_streaming_session_matches(engines):
    ref_engine, engine = engines
    ts = tserve.StreamingSession(engine, modalities=("insole", "imu"))
    js = jserve.StreamingSession(ref_engine, modalities=("insole", "imu"))
    rng = np.random.default_rng(3)
    assert ts.poll() is None
    drips = []
    for _ in range(10):
        drips.append(("insole", rng.normal(size=(16, 13))))
        drips.append(("imu", rng.normal(size=(13, 24))))
    drips.append(("imu", np.full((3, 24), np.nan)))
    _push_all([(ts, js)], [drips])
    got, ref = ts.poll(), js.poll()
    assert got["window_probs"].shape == (2, 2)  # imu: 133 frames -> 2 windows
    np.testing.assert_allclose(got["window_probs"], ref["window_probs"], **TOL)
    np.testing.assert_array_equal(got["pred"], ref["pred"])
    assert ts.poll() is None


def test_poll_sessions_match(engines):
    ref_engine, engine = engines
    subsets = [("insole", "imu"), ("imu",), ("insole", "imu"),
               ("walkway", "insole", "imu"), ("imu",), ("walkway",)]
    frames = [200, 64, 130, 70, 0, 129]
    rng = np.random.default_rng(4)
    pairs, pushes = [], []
    for mods, n in zip(subsets, frames):
        pairs.append((tserve.StreamingSession(engine, mods),
                      jserve.StreamingSession(ref_engine, mods)))
        pushes.append([(m, rng.normal(size=(n, tserve.CHANNELS[m]))) for m in mods if n])
    _push_all(pairs, pushes)
    got = tserve.poll_sessions([p[0] for p in pairs])
    ref = jserve.poll_sessions([p[1] for p in pairs])
    for i, (g, r) in enumerate(zip(got, ref)):
        if r is None:
            assert g is None, f"session {i}"
            continue
        np.testing.assert_allclose(g["window_probs"], r["window_probs"], **TOL,
                                   err_msg=f"session {i}")
        np.testing.assert_array_equal(g["pred"], r["pred"])


def test_poll_sessions_groups_by_engine():
    """Sessions of one modality subset behind different engines are scored by
    their own parameters, as in the reference."""
    (j1, t1), (j2, t2) = _engines(0), _engines(7)
    x = np.random.default_rng(6).normal(size=(64, 24))
    sessions = [tserve.StreamingSession(e, ("imu",)) for e in (t1, t2)]
    ref_sessions = [jserve.StreamingSession(e, ("imu",)) for e in (j1, j2)]
    for s in sessions + ref_sessions:
        s.push("imu", x)
    got = tserve.poll_sessions(sessions)
    ref = jserve.poll_sessions(ref_sessions)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g["window_probs"], r["window_probs"], **TOL)
    assert not np.allclose(got[0]["window_probs"], got[1]["window_probs"])
