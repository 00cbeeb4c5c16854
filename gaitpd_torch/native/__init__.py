"""Native (C++) runtime components, consumed through ctypes: the port's own
copy of gaitpd/native.

``StreamWindowBuffer`` is the streaming sliding-window ring buffer of the
serving path. It is built on first use with g++ into a cached shared object
next to the source (``_ringbuffer_<hash>.so``, ignored by git) and rebuilt
when the source changes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent


def _build_lib(name: str) -> Path:
    src = _HERE / f"{name}.cpp"
    tag = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    out = _HERE / f"_{name}_{tag}.so"
    if not out.exists():
        for stale in _HERE.glob(f"_{name}_*.so"):
            stale.unlink(missing_ok=True)
        # build under a private name and rename, so that a concurrent loader
        # never maps a half-written library
        tmp = _HERE / f"._{name}_{tag}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(src), "-o", str(tmp)],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, out)
    return out


_lib: Optional[ctypes.CDLL] = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build_lib("ringbuffer")))
        lib.rb_create.restype = ctypes.c_void_p
        lib.rb_create.argtypes = [ctypes.c_int64] * 4
        lib.rb_destroy.argtypes = [ctypes.c_void_p]
        lib.rb_push.restype = ctypes.c_int64
        lib.rb_push.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                ctypes.c_int64]
        lib.rb_ready.restype = ctypes.c_int64
        lib.rb_ready.argtypes = [ctypes.c_void_p]
        lib.rb_pop.restype = ctypes.c_int64
        lib.rb_pop.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                               ctypes.c_int64]
        lib.rb_dropped.restype = ctypes.c_int64
        lib.rb_dropped.argtypes = [ctypes.c_void_p]
        lib.rb_total.restype = ctypes.c_int64
        lib.rb_total.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class StreamWindowBuffer:
    """Real-time (win, hop) windowing over a pushed sensor stream.

    Window boundaries match the offline pipeline exactly
    (gaitpd_torch.data.pipeline.window_indices): window i covers absolute
    frames [i*hop, i*hop + win). If the ring overflows before a window is
    popped, the schedule re-aligns to the hop grid and `dropped_frames`
    records the loss.
    """

    def __init__(self, channels: int, win: int, hop: int, capacity: Optional[int] = None):
        self._lib = _load()
        self.channels, self.win, self.hop = channels, win, hop
        cap = capacity or max(4 * win, 1024)
        self._ptr = self._lib.rb_create(channels, win, hop, cap)
        if not self._ptr:
            raise ValueError("invalid ring buffer parameters")

    def push(self, frames: np.ndarray) -> int:
        frames = np.ascontiguousarray(frames, dtype=np.float32)
        if frames.ndim != 2 or frames.shape[1] != self.channels:
            raise ValueError(f"expected (n, {self.channels}) frames")
        ptr = frames.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        return int(self._lib.rb_push(self._ptr, ptr, frames.shape[0]))

    @property
    def ready(self) -> int:
        return int(self._lib.rb_ready(self._ptr))

    @property
    def dropped_frames(self) -> int:
        return int(self._lib.rb_dropped(self._ptr))

    @property
    def total_frames(self) -> int:
        return int(self._lib.rb_total(self._ptr))

    def pop(self, max_windows: Optional[int] = None) -> np.ndarray:
        n = self.ready if max_windows is None else min(max_windows, self.ready)
        out = np.empty((n, self.win, self.channels), np.float32)
        if n:
            ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            got = int(self._lib.rb_pop(self._ptr, ptr, n))
            out = out[:got]
        return out

    def __del__(self):
        try:
            if getattr(self, "_ptr", None):
                self._lib.rb_destroy(self._ptr)
                self._ptr = None
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
