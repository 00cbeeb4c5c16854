"""clock64() readings of the Newton solvers' dependent chains, on one NVIDIA card.

    python -m gaitpd_torch.tools.mtl_solver_clock [--reps 1024]

Builds gaitpd_torch/tools/mtl_solver_clock.cu (which includes
gaitpd_torch/csrc/mtl_solvers.cu) with nvcc into gaitpd_torch/_build/tools/
(gitignored) and reads, in SM cycles from clock64() stamps in lane 0 of one
warp:

  - one operation of a dependent chain of ``--reps`` of them: an add; one
    ``powf`` at FairGrad's exponents for alpha 0.5, 1 and 2 (-1/alpha and
    -1/alpha - 1) on a base of 1/3, less its carrier (x * zero + base, which
    ties each call to the last); one ``__fdiv_rn``; one ``__shfl_sync``;
  - one independent pair (and triple) of divisions, pair of ``powf`` calls,
    in one thread: how far such calls overlap; one ``__frcp_rn``;
  - one whole solve at K = 3 and 8 of each design of csrc/mtl_solvers.cu
    (MGDA's thread design; FairGrad's at alpha 1 and NashMTL's, thread and
    warp) and of two layouts considered beside them (gather: every
    multiplier in one lane; rows: a lane a row of J, its pivot rows
    shuffled out), on a seeded Gram matrix, per step (100 FairGrad, 50
    NashMTL, 250 MGDA steps), each held bitwise against the thread design;
  - the SM clock: one thread spinning for 2 * 10^7 cycles, under CUDA
    events, so that cycles convert to microseconds.

Each reading is the least of 5 launches. The card's name and power limit
are printed beside them; the last line is one JSON object of every reading.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gaitpd_torch.ops import _build

SOURCE = Path(__file__).resolve().with_suffix(".cu")
ALPHAS = (0.5, 1.0, 2.0)
STEPS = {"min_norm_solver": 250, "fairgrad_solver": 100, "nashmtl_solver": 50}
METHODS = {"min_norm_solver": 0, "fairgrad_solver": 1, "nashmtl_solver": 2}
PROBES = {"carrier": 0, "powf": 1, "div": 2, "shfl": 3, "add": 4, "div x2": 5, "div x3": 6,
          "powf x2": 7, "rcp": 8}
DESIGNS = ("thread", "warp", "gather", "rows")
TASKS = (3, 8)
BASE = 1.0 / 3.0  # FairGrad's first w at K = 3
SPIN_CYCLES = 20_000_000


def build() -> ctypes.CDLL:
    out_dir = _build.BUILD_DIR / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libmtl_solver_clock.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
    c = ctypes.CDLL(str(lib))
    c.probe_op.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                           ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    c.probe_solve.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    c.probe_spin.argtypes = [ctypes.c_longlong, ctypes.c_void_p]
    for fn in (c.probe_op, c.probe_solve, c.probe_spin):
        fn.restype = ctypes.c_int
    return c


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: cudaError_t {err}")


def op_cycles(lib, probe: str, reps: int, e: float) -> float:
    """Cycles a link of a dependent chain of `reps` operations, the least of 5."""
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.zeros(32, device="cuda")
    best = None
    for _ in range(5):
        _check(lib.probe_op(PROBES[probe], reps, BASE, e, 0.0, cycles.data_ptr(),
                            sink.data_ptr()), probe)
        torch.cuda.synchronize()
        c = cycles.item() / reps
        best = c if best is None else min(best, c)
    if not torch.isfinite(sink).all():
        raise RuntimeError(f"{probe}: the chain left non-finite values")
    return best


def solve_cycles(lib, name: str, variant: int, gram: torch.Tensor, alpha: float):
    """(cycles a step, w) of one solve at K = gram's size, the least of 5."""
    k = gram.shape[-1]
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    out = torch.zeros(k, device="cuda")
    best = None
    for _ in range(5):
        _check(lib.probe_solve(METHODS[name], variant, k, gram.data_ptr(), alpha, out.data_ptr(),
                               cycles.data_ptr()), name)
        torch.cuda.synchronize()
        c = cycles.item() / STEPS[name]
        best = c if best is None else min(best, c)
    return best, out.clone()


def sm_mhz(lib) -> float:
    done = torch.zeros(1, dtype=torch.int64, device="cuda")
    best = None
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _check(lib.probe_spin(SPIN_CYCLES, done.data_ptr()), "spin")
        end.record()
        torch.cuda.synchronize()
        mhz = done.item() / (start.elapsed_time(end) * 1e3)
        best = mhz if best is None else max(best, mhz)
    return best


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=1024)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("mtl_solver_clock: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    lib = build()
    print(f"[clock] {card}: built {SOURCE.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    readings = {"card": card, "sm_mhz": sm_mhz(lib)}
    readings["add"] = op_cycles(lib, "add", args.reps, 1e-3)
    carrier = op_cycles(lib, "carrier", args.reps, 0.0)
    readings["carrier"] = carrier
    for alpha in ALPHAS:
        for which, e in (("e1", -1.0 / alpha), ("e2", -1.0 / alpha - 1.0)):
            readings[f"powf alpha={alpha} {which}={e:g}"] = (
                op_cycles(lib, "powf", args.reps, e) - carrier)
    readings["div"] = op_cycles(lib, "div", args.reps, 1.5)
    # independent calls in one thread: how far they overlap
    readings["div x2 (two independent chains)"] = op_cycles(lib, "div x2", args.reps, 1.5)
    readings["div x3 (three independent chains)"] = op_cycles(lib, "div x3", args.reps, 1.5)
    readings["powf x2 (two independent chains)"] = (
        op_cycles(lib, "powf x2", args.reps, -1.0) - carrier)
    readings["rcp (__frcp_rn)"] = op_cycles(lib, "rcp", args.reps, 0.0)
    readings["shfl"] = op_cycles(lib, "shfl", args.reps, 0.0)

    rng = np.random.default_rng(args.seed)
    for k in TASKS:
        a = rng.normal(size=(k, 6))
        gram = torch.from_numpy((a @ a.T + 1e-4 * np.eye(k)).astype(np.float32)).cuda()
        gram_nash = gram / torch.linalg.matrix_norm(gram)
        steps = {}
        runs = [("min_norm_solver", "thread")] + [
            (name, design) for name in ("fairgrad_solver", "nashmtl_solver")
            for design in DESIGNS]
        for name, design in runs:
            gm = gram_nash if name == "nashmtl_solver" else gram
            cyc, w = solve_cycles(lib, name, DESIGNS.index(design), gm, 1.0)
            steps[f"{name} {design}"] = w
            readings[f"K={k} {name} {design} step"] = cyc
        for name in ("fairgrad_solver", "nashmtl_solver"):
            if not all(torch.equal(steps[f"{name} thread"], steps[f"{name} {d}"])
                       for d in DESIGNS):
                raise RuntimeError(f"K={k} {name}: the designs disagree")
            readings[f"K={k} {name} designs bitwise equal"] = True
    mhz = readings["sm_mhz"]
    for key, value in readings.items():
        if isinstance(value, float) and key != "sm_mhz":
            print(f"[clock] {card}: {key}: {value:.1f} cycles ({value / mhz * 1e3:.1f} ns at "
                  f"{mhz:.0f} MHz)", flush=True)
        else:
            print(f"[clock] {card}: {key}: {value}", flush=True)
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
