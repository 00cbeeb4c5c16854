"""clock64() readings of the solvers' dependent chains, on one NVIDIA card.

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
  - MGDA's layouts of a Frank-Wolfe step (thread, 250 steps; thread_stop,
    vertices and rows, each stopping at its bitwise fixed point with the
    compare after every 1, 2, 4 or 8 steps) at K = 2..8 on MIN_NORM_N
    seeded Gram matrices of chip_smoke.py::mtl_solver_grams' law: cycles a
    step on the first of them that runs all 250 steps, and the step at
    which each stopped, w held bitwise against the 250-step plain version
    and the stop step against min_norm_element_stop's;
  - MGDA's production kernels at K = 2..8 on that 250-step matrix (at
    K = 3 also chip_smoke.py's worst case and one that stops near step 60),
    the default and thread designs by their entries beside the thread and
    rows kernels with the stop's compare after every 2, 4, 8 or 16 steps,
    its verdict read at once or one block later: device ms from CUDA
    graphs, two rounds in turns;
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

from gaitpd_torch.learning.minnorm import min_norm_element, min_norm_element_stop
from gaitpd_torch.ops import _build

SOURCE = Path(__file__).resolve().with_suffix(".cu")
ALPHAS = (0.5, 1.0, 2.0)
STEPS = {"min_norm_solver": 250, "fairgrad_solver": 100, "nashmtl_solver": 50}
METHODS = {"min_norm_solver": 0, "fairgrad_solver": 1, "nashmtl_solver": 2}
PROBES = {"carrier": 0, "powf": 1, "div": 2, "shfl": 3, "add": 4, "div x2": 5, "div x3": 6,
          "powf x2": 7, "rcp": 8}
DESIGNS = ("thread", "warp", "gather", "rows")
TASKS = (3, 8)
MIN_NORM_LAYOUTS = ("thread", "thread_stop", "vertices", "rows")
MIN_NORM_EVERY = (1, 2, 4, 8)
MIN_NORM_TASKS = range(2, 9)
MIN_NORM_N = 32
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
    c.probe_min_norm.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
    c.probe_min_norm_cadence.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int,
                                                              ctypes.c_void_p, ctypes.c_void_p]
    c.probe_spin.argtypes = [ctypes.c_longlong, ctypes.c_void_p]
    for fn in (c.probe_op, c.probe_solve, c.probe_min_norm, c.probe_min_norm_cadence,
               c.probe_spin):
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


def min_norm_cycles(lib, layout: str, every: int, gram: torch.Tensor):
    """(cycles, w, stop step) of one MGDA solve in `layout`, the least
    cycles of 5 launches."""
    k = gram.shape[-1]
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    stop = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = torch.zeros(k, device="cuda")
    best = None
    for _ in range(5):
        _check(lib.probe_min_norm(MIN_NORM_LAYOUTS.index(layout), every, k, gram.data_ptr(),
                                  out.data_ptr(), cycles.data_ptr(), stop.data_ptr()),
               f"min_norm {layout}")
        torch.cuda.synchronize()
        best = cycles.item() if best is None else min(best, cycles.item())
    return best, out.clone(), int(stop.item())


def min_norm_grams(rng, n, k) -> torch.Tensor:
    """chip_smoke.py::mtl_solver_grams' seeded law, without its degenerate
    matrices."""
    a = rng.normal(size=(n, k, 6)) * 10.0 ** rng.uniform(-2, 2, size=(n, 1, 1))
    return torch.from_numpy((a @ a.transpose(0, 2, 1) + 1e-4 * np.eye(k)).astype(np.float32))


def min_norm_readings(lib, seed: int) -> dict:
    """MGDA's layouts at each K: cycles a step on the first seeded matrix
    that runs all 250 steps (else the one that runs longest), with and
    without the compare, and each matrix's stop step."""
    out = {}
    for k in MIN_NORM_TASKS:
        grams = min_norm_grams(np.random.default_rng([seed, 20, k]), MIN_NORM_N, k).cuda()
        want = min_norm_element(grams)
        stops = {m: min_norm_element_stop(grams, m)[1].tolist() for m in MIN_NORM_EVERY}
        worst = max(range(len(grams)), key=lambda i: (stops[1][i], -i))
        out[f"K={k} min_norm stop steps every=1 (plain)"] = stops[1]
        out[f"K={k} min_norm worst case"] = f"matrix {worst}, stop {stops[1][worst]}"
        for layout in MIN_NORM_LAYOUTS:
            for m in (MIN_NORM_EVERY if layout != "thread" else (1,)):
                got = [min_norm_cycles(lib, layout, m, g) for g in grams]
                ran = [250 if layout == "thread" else s for _, _, s in got]
                if not all(torch.equal(w.view(torch.int32), r.view(torch.int32))
                           for (_, w, _), r in zip(got, want)):
                    raise RuntimeError(f"K={k} min_norm {layout}: w not bitwise equal to the "
                                       f"250-step plain version")
                if layout != "thread" and ran != stops[m]:
                    raise RuntimeError(f"K={k} min_norm {layout} every={m}: stop steps {ran}, "
                                       f"the plain stop {stops[m]}")
                tag = f"K={k} min_norm {layout}" + (f" every={m}" if layout != "thread" else "")
                out[f"{tag} step"] = got[worst][0] / ran[worst]
                out[f"{tag} cycles over the {len(grams)} matrices"] = sum(c for c, _, _ in got)
        out[f"K={k} min_norm stop steps (min, median, max) by every"] = {
            m: [int(np.min(stops[m])), float(np.median(stops[m])), int(np.max(stops[m]))]
            for m in MIN_NORM_EVERY}
    return out


def graph_ms(fn, reps: int = 50) -> float:
    """Device ms a call of `fn`: `reps` calls captured in a CUDA graph and
    replayed once under CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(5):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cadence_readings(lib, seed: int) -> dict:
    """MGDA's production kernels (csrc/mtl_solvers.cu's thread kernel and
    rows kernel) at each cadence of the stop's compare, at once or lagged
    one block, beside the default and thread designs by their entries, at
    K = 2..8 on min_norm_readings' matrix that runs all 250 steps (at K = 3
    also chip_smoke.py's worst case and a matrix that stops near step 60):
    device ms from CUDA graphs, two rounds in turns; w held bitwise against
    the plain version."""
    from gaitpd_torch.ops import mtl_solvers as ms

    out = {}
    for k in MIN_NORM_TASKS:
        grams = min_norm_grams(np.random.default_rng([seed, 20, k]), MIN_NORM_N, k).cuda()
        stops = min_norm_element_stop(grams, 1)[1].tolist()
        cases = {"250 steps": grams[stops.index(250)]}
        if k == 3:
            cases["chip_smoke's worst case"] = min_norm_grams(
                np.random.default_rng([seed, 23]), 12, 3)[0].cuda()
            near = min(range(len(stops)), key=lambda i: abs(stops[i] - 60))
            cases[f"stops at step {stops[near]}"] = grams[near]
        for case, gram in cases.items():
            want = min_norm_element(gram)
            runs = {"default": lambda g=gram: ms.min_norm_solve(g),
                    "thread": lambda g=gram: ms._solve_kernel("min_norm_solver", g,
                                                              variant="thread")}
            for layout, name in enumerate(("thread", "rows")):
                for every in (0, 2, 4, 8, 16):
                    for lagged in (0, 1):
                        if every == 0 and (layout or lagged):
                            continue

                        def run(g=gram, layout=layout, every=every, lagged=lagged):
                            o = torch.empty(k, device="cuda")
                            _check(lib.probe_min_norm_cadence(
                                k, layout, every, lagged, g.data_ptr(), 1, o.data_ptr(),
                                torch.cuda.current_stream().cuda_stream), "cadence")
                            return o
                        runs[f"{name} every={every}" + (" lagged" if lagged else "")] = run
            for name, fn in runs.items():
                if not torch.equal(fn().view(torch.int32), want.view(torch.int32)):
                    raise RuntimeError(f"K={k} min_norm {name}: w not bitwise equal")
            rounds = [{name: graph_ms(fn) for name, fn in runs.items()} for _ in range(2)]
            for name in runs:
                out[f"K={k} min_norm {case}, device ms, {name}"] = [r[name] for r in rounds]
    return out


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
        cyc, _, _ = min_norm_cycles(lib, "thread", 1, gram)
        readings[f"K={k} min_norm_solver thread step"] = cyc / STEPS["min_norm_solver"]
        runs = [(name, design) for name in ("fairgrad_solver", "nashmtl_solver")
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
    readings.update(min_norm_readings(lib, args.seed))
    readings.update(cadence_readings(lib, args.seed))
    mhz = readings["sm_mhz"]
    for key, value in readings.items():
        if isinstance(value, float) and key != "sm_mhz" and "over the" not in key:
            print(f"[clock] {card}: {key}: {value:.1f} cycles ({value / mhz * 1e3:.1f} ns at "
                  f"{mhz:.0f} MHz)", flush=True)
        else:
            print(f"[clock] {card}: {key}: {value}", flush=True)
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
