"""Tracing, profiling and debugging hooks. Port of gaitpd/runtime/profiling.py.

* ``trace``: a context manager around ``torch.profiler.profile`` (CPU, and
  CUDA where a card is present) that writes a Chrome trace into a directory;
* ``StepTimer``: wall-clock and windows/s counters, with gaitpd's
  ``summary()`` keys;
* ``enable_nan_debug``: autograd's anomaly mode, which raises where a
  backward returns a non-finite value;
* ``log_compile_times``: logs each nvcc build of gaitpd_torch/csrc that runs
  in the region (the port's only compilation; its eager forward compiles
  nothing).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator, Optional

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: str = "gaitpd_torch_trace") -> Iterator["torch.profiler.profile"]:
    """``torch.profiler`` around a region: CPU activity, and CUDA activity
    where a card is present. On exit it writes ``trace_<pid>_<n>.json``, a
    Chrome trace (chrome://tracing or Perfetto; no tensorboard needed), into
    ``log_dir``. Yields the profiler, whose ``key_averages()`` the caller may
    read after the region."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
        path = os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json")
        prof.export_chrome_trace(path)
        logger.info("trace written to %s", path)


def enable_nan_debug(enable: bool = True) -> None:
    """Fail fast on non-finite values: ``torch.autograd.set_detect_anomaly``.
    gaitpd's ``jax_debug_nans`` checks every jitted operation's output,
    forward and backward; anomaly mode checks the outputs of each backward
    function (and records the forward's stack to name the operation that
    made them), so a NaN that a forward makes and no gradient carries
    passes unseen."""
    torch.autograd.set_detect_anomaly(enable)


class StepTimer:
    """Wall-clock + windows/sec accounting for epochs/steps. On the card
    the caller synchronises before reading it, or the time is the host's
    alone."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self.windows = 0
        self.steps = 0

    def add(self, windows: int, steps: int = 1):
        self.windows += int(windows)
        self.steps += int(steps)

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def windows_per_sec(self) -> float:
        dt = self.elapsed
        return self.windows / dt if dt > 0 else 0.0

    def summary(self) -> dict:
        return {
            "elapsed_s": round(self.elapsed, 3),
            "steps": self.steps,
            "windows": self.windows,
            "windows_per_sec": round(self.windows_per_sec, 1),
        }


@contextlib.contextmanager
def log_compile_times(log: Optional[logging.Logger] = None) -> Iterator[None]:
    """Log every build of a kernel source in the region, with nvcc's seconds
    (gaitpd_torch/ops/_build.py's ``BuildResult.seconds``). gaitpd logs each
    XLA compilation; the port's forward and backward run eagerly and compile
    nothing, and its kernels are built once a source and flag set, at first
    use: a second build in one process is the recompilation to look for. A
    library already on disk is not a build and is not logged."""
    from gaitpd_torch.ops import _build

    log = log or logger

    def on_build(result):
        log.warning("built %s in %.2f s (%s)", result.name, result.seconds, result.path)

    _build.BUILD_LISTENERS.append(on_build)
    try:
        yield
    finally:
        _build.BUILD_LISTENERS.remove(on_build)
