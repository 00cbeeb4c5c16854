"""gaitpd_torch.runtime.profiling on the CPU: ``StepTimer`` as gaitpd's
(tests/test_aux.py) and with gaitpd's ``summary()`` keys; ``trace`` writes a
Chrome trace of the region; ``enable_nan_debug`` switches autograd's anomaly
mode, which then raises on a NaN gradient; ``log_compile_times`` logs a
kernel build that runs in the region (nvcc stood in for by a stub that
writes the library) and nothing where none runs."""

import json
import logging
import subprocess

import pytest
import torch

from gaitpd_torch.ops import _build
from gaitpd_torch.runtime import profiling as P


def test_step_timer():
    t = P.StepTimer()
    t.add(100, 2)
    s = t.summary()
    assert s["windows"] == 100 and s["steps"] == 2
    assert s["windows_per_sec"] > 0


def test_step_timer_has_gaitpd_keys():
    jp = pytest.importorskip("gaitpd.runtime.profiling")
    mine, theirs = P.StepTimer(), jp.StepTimer()
    for t in (mine, theirs):
        t.add(64)
    assert set(mine.summary()) == set(theirs.summary())
    mine.reset()
    assert (mine.windows, mine.steps) == (0, 0)


def test_trace_writes_a_chrome_trace(tmp_path):
    with P.trace(str(tmp_path)) as prof:
        torch.relu(torch.randn(16, 16)).sum()
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("relu" in str(e.get("name", "")) for e in events)
    assert any("relu" in e.key for e in prof.key_averages())
    with P.trace(str(tmp_path)):
        pass
    assert len(list(tmp_path.glob("trace_*.json"))) == 2


def test_enable_nan_debug_toggles_anomaly_mode():
    before = torch.is_anomaly_enabled()
    try:
        P.enable_nan_debug(True)
        assert torch.is_anomaly_enabled()
        x = torch.zeros(3, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1.0).sum().backward()
        P.enable_nan_debug(False)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(before)


def test_log_compile_times_logs_nothing_without_a_build(caplog):
    with caplog.at_level(logging.DEBUG), P.log_compile_times():
        torch.ones(4).sum()
    assert caplog.records == []
    assert _build.BUILD_LISTENERS == []


def test_log_compile_times_logs_a_build(monkeypatch, tmp_path, caplog):
    """A build in the region is logged with its seconds; one already on disk
    is not, nor one after the region."""
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "probe.cu").write_text("// probe\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")

    def nvcc(cmd, **kw):
        open(cmd[cmd.index("-o") + 1], "w").close()
        return subprocess.CompletedProcess(cmd, 0, "ptxas info: probe\n", "")

    monkeypatch.setattr(_build.subprocess, "run", nvcc)
    with caplog.at_level(logging.WARNING, logger=P.logger.name), P.log_compile_times():
        first = _build.build("probe")
        again = _build.build("probe")
    assert first.seconds > 0.0 and again.seconds == 0.0
    built = [r.getMessage() for r in caplog.records]
    assert len(built) == 1 and built[0].startswith("built probe in ")
    (tmp_path / "csrc" / "probe.cu").write_text("// changed\n")
    _build.build("probe")
    assert len(caplog.records) == 1
