"""gaitpd_torch.sweep on the CPU: skip-if-done on the sequential path and
under ``--vmap_seeds``, with one file schema for both (a rerun through
either path skips the other's results; gaitpd's tests/test_aux.py and
tests/test_vmap_cv.py cases, here with ``--device cpu``); a failing job
(or stacked run) recorded as failed while the sweep goes on; and, with both
packages' drivers stood in for by ``monkeypatch`` (nothing trains), the
file names and payloads (keys, args, status, mode, result) equal to those
gaitpd's ``sweep.main`` writes for the same argv in every mode, the port's
drivers given ``device``. The runs take one intra-op thread (restored
after): their steps are many small ops.
"""

import json

import pytest
import torch

jax = pytest.importorskip("jax")

import gaitpd.sweep as JS  # noqa: E402
import gaitpd.train.baseline_drivers as JB  # noqa: E402
import gaitpd.train.fbg_fog_driver as JF  # noqa: E402
import gaitpd.train.vmap_cv as JV  # noqa: E402
import gaitpd.train.weargait_driver as JD  # noqa: E402
import gaitpd_torch.sweep as TS  # noqa: E402
import gaitpd_torch.train.baseline_drivers as TB  # noqa: E402
import gaitpd_torch.train.fbg_fog_driver as TF  # noqa: E402
import gaitpd_torch.train.vmap_cv as TV  # noqa: E402
import gaitpd_torch.train.weargait_driver as TD  # noqa: E402

FUSION = ["--mode", "fusion", "--dataset", "fog", "--synthetic", "--epochs", "1",
          "--n_folds_cap", "1"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sweep_runner_skip_if_done(tmp_path):
    out = tmp_path / "sweep"
    argv = FUSION + ["--fusion_types", "early", "--seeds", "0", "--out", str(out),
                     "--device", "cpu"]
    assert TS.main(argv) == {"done": 1, "skipped": 0, "failed": 0}
    payload = json.loads((out / "fusion_fog_early_seed0.json").read_text())
    assert payload["status"] == "ok"
    assert set(payload["result"]) >= {"skel", "sensor", "avg"}
    assert TS.main(argv) == {"done": 0, "skipped": 1, "failed": 0}


def test_vmap_sweep_skip_if_done(tmp_path):
    """The stacked sweep writes the sequential sweep's schema, so either
    path skips the other's results."""
    argv = FUSION + ["--synchronized_loading", "--fusion_types", "early", "--seeds", "0", "1",
                     "--out", str(tmp_path), "--device", "cpu", "--vmap_seeds"]
    assert TS.main(argv) == {"done": 2, "skipped": 0, "failed": 0}
    payload = json.loads((tmp_path / "fusion_fog_early_seed1.json").read_text())
    assert payload["status"] == "ok" and payload["args"]["vmap_seeds"] is True
    assert payload["runtime_s_batch"] >= payload["runtime_s"]
    assert TS.main(argv) == {"done": 0, "skipped": 2, "failed": 0}
    assert TS.main(argv[:-1]) == {"done": 0, "skipped": 2, "failed": 0}


def test_failed_job_is_recorded_and_the_sweep_goes_on(monkeypatch, tmp_path):
    ran = []

    def driver(args):
        ran.append(args.seed)
        if args.seed == 1:
            raise RuntimeError("a job that fails")
        return {"skel": 0.0, "sensor": 0.0, "avg": 0.0}

    monkeypatch.setattr(TB, "main", driver)
    argv = FUSION + ["--fusion_types", "early", "--seeds", "0", "1", "2", "--out",
                     str(tmp_path), "--device", "cpu"]
    assert TS.main(argv) == {"done": 2, "skipped": 0, "failed": 1}
    assert ran == [0, 1, 2]
    failed = json.loads((tmp_path / "fusion_fog_early_seed1.json").read_text())
    assert failed["status"] == "failed" and "a job that fails" in failed["result"]["traceback"]

    def stacked(*a, **k):
        raise RuntimeError("a stacked run that fails")

    monkeypatch.setattr(TV, "run_baseline_seeds_vmapped", stacked)
    argv = FUSION + ["--fusion_types", "late", "cheap_xattn", "--seeds", "0", "1", "--out",
                     str(tmp_path), "--device", "cpu", "--vmap_seeds"]
    assert TS.main(argv) == {"done": 0, "skipped": 0, "failed": 4}


# every mode, each flag off its default where the mode reads it
SCHEMA_ARGVS = {
    "fusion": ["--mode", "fusion", "--dataset", "fbg", "--fusion_types", "early", "cheap_xattn",
               "--seeds", "0", "3", "--synchronized_loading", "--epochs", "2"],
    "fusion_vmap": ["--mode", "fusion", "--dataset", "fog", "--fusion_types", "late",
                    "--seeds", "1", "2", "--n_folds_cap", "1", "--vmap_seeds"],
    "deepav": ["--mode", "deepav", "--seeds", "5", "--wm", "class_wt", "--synthetic"],
    "focal_vmap": ["--mode", "focal", "--dataset", "fog", "--seeds", "0", "1", "--wm", "gcl",
                   "--vmap_seeds"],
    "taca": ["--mode", "taca", "--seeds", "2", "--n_folds_cap", "2"],
    "weargait": ["--mode", "weargait", "--seeds", "0", "1", "--wm", "gcl", "--synthetic"],
    "fbg_fog": ["--mode", "fbg_fog", "--dataset", "fog", "--seeds", "4", "--epochs", "3",
                "--synchronized_loading", "--vmap_seeds"],
}


def _stub_drivers(monkeypatch, calls):
    """Both packages' drivers stood in for: each returns a result of its
    call's seed and records the Args (or the stacked call's keywords)."""
    def driver(side):
        def run(args, *a, **k):
            calls.setdefault(side, []).append(args)
            return {"avg": float(args.seed)}
        return run

    def stacked(side):
        def run(dataset, kind, variant, seeds, **kw):
            calls.setdefault(side, []).append(kw)
            return {s: {"avg": float(s)} for s in seeds}
        return run

    for side, (base, fbg, wear, vm) in (("jax", (JB, JF, JD, JV)), ("port", (TB, TF, TD, TV))):
        monkeypatch.setattr(base, "main", driver(side))
        monkeypatch.setattr(fbg, "main", driver(side))
        monkeypatch.setattr(wear, "run_cv", driver(side))
        monkeypatch.setattr(vm, "run_baseline_seeds_vmapped", stacked(side))


@pytest.mark.parametrize("name", sorted(SCHEMA_ARGVS))
def test_result_files_match_gaitpds(monkeypatch, tmp_path, name):
    calls = {}
    _stub_drivers(monkeypatch, calls)
    argv = SCHEMA_ARGVS[name]
    want = JS.main(argv + ["--out", str(tmp_path / "jax")])
    got = TS.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    assert got == want and want["done"] > 0
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for fname in names:
        w = json.loads((tmp_path / "jax" / fname).read_text())
        g = json.loads((tmp_path / "port" / fname).read_text())
        assert list(g) == list(w), fname
        for key in ("status", "mode", "args", "result"):
            assert g[key] == w[key], (fname, key)
    # the port's drivers run where --device says
    for call in calls["port"]:
        device = call["device"] if isinstance(call, dict) else call.device
        assert device == "cpu"
