#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gaitpd_torch) once on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases (each raises on failure, so the script exits non-zero):
  1. device: the card's name, count and power limit; build every kernel in
     gaitpd_torch/csrc with nvcc, one process each, and print nvcc's -Xptxas -v
     lines;
  2. kernels: each kernel against its plain PyTorch version on the card,
     max abs error <= 1e-5 in f32 with TF32 off;
  3. serving, the main path: WearGaitEngine.predict_streams over all 7 sensor
     subsets, predict_windows at batch 1024 and poll_sessions over 32
     streaming sessions, for a plain-head and a LayerNorm+cosine-head model
     made from --seed; every output against the same engine on the CPU (the
     plain versions), and every kernel launched at least once on this path;
  4. timings: each kernel, its plain version and a PyTorch library call at
     the main path's shape (CUDA events), the kernel's bound, serving
     windows/s and latency (host clock around synchronised calls), and the
     device time by kernel of batch-1024 predict_windows (torch.profiler).

The second-to-last line is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}. Without a CUDA device it exits 1
before printing any result.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from gaitpd_torch.models.multitask import CHANNELS, MODALITIES, WearGaitThreeModal
from gaitpd_torch.ops import _build
from gaitpd_torch.ops import stream_block as sb
from gaitpd_torch.runtime.device import resolve_device
from gaitpd_torch.serve import StreamingSession, WearGaitEngine, poll_sessions

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

KERNEL_TOL = 1e-5  # kernel vs plain version, f32, TF32 off
SERVE_TOL = 1e-5  # card vs CPU probabilities: f32, summation order only

N_WINDOWS = 1024  # serving batch; the backbone sees 3 * N_WINDOWS windows
LATENCY_SAMPLES = 100  # p90 then has ten samples beyond it
WIN = HOP = 64
SUBSETS = [s for r in (1, 2, 3) for s in itertools.combinations(MODALITIES, r)]


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# 1. device and build
# ---------------------------------------------------------------------------


def phase_device() -> str:
    log(f"[device] {torch.cuda.get_device_name(0)}, count={torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    card = card_line()
    log(f"[device] nvidia-smi: {card}")
    t0 = time.perf_counter()
    results = _build.build_all()
    log(f"[build] {len(results)} kernel(s) in {time.perf_counter() - t0:.2f} s wall")
    for r in results:
        log(f"[build] {r.name}: nvcc {r.seconds:.2f} s -> {r.path.name}")
        for line in r.log.splitlines():  # registers, shared memory, spills
            if line.strip():
                log(f"[build]   {line.strip()}")
    return card


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------


def stream_block_inputs(rng, bsz, t, cin, k, cout, dev):
    x = rng.normal(size=(bsz, t, cin)).astype(np.float32)
    w = (rng.normal(size=(k, cin, cout)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (x, w, b)]


def phase_kernels(rng, dev) -> dict:
    # (B, T, C_in, K, C_out, t_out, act)
    cases = {
        "main": (3 * N_WINDOWS, 64, 12, 3, 16, 8, "relu"),
        "k5_gelu_cin13": (64, 64, 13, 5, 16, 8, "gelu"),
        "t101_overlapping_bins": (64, 101, 12, 3, 16, 8, "relu"),
        "ragged_batch": (3 * 333 + 1, 64, 12, 3, 16, 8, "relu"),
        "k1": (37, 64, 12, 1, 16, 8, "relu"),
    }
    errors = {}
    for name, (bsz, t, cin, k, cout, t_out, act) in cases.items():
        x, w, b = stream_block_inputs(rng, bsz, t, cin, k, cout, dev)
        before = sb.launches
        got = sb.stream_block(x, w, b, t_out, act)
        torch.cuda.synchronize()
        if sb.launches != before + 1:
            raise RuntimeError(f"stream_block[{name}]: launch count did not go up")
        want = sb.stream_block_reference(x, w, b, t_out, act)
        err = (got - want).abs().max().item()
        log(f"[kernel] stream_block {name} x{tuple(x.shape)} k{k} {act} -> "
            f"{tuple(got.shape)}: max abs err {err:.3e} (tol {KERNEL_TOL})")
        if not np.isfinite(err) or err > KERNEL_TOL:
            raise RuntimeError(f"stream_block[{name}] disagrees with its plain version: {err}")
        errors[name] = err
    return errors


# ---------------------------------------------------------------------------
# 3. serving, the main path
# ---------------------------------------------------------------------------


def make_stats(rng):
    return {m: ((rng.normal(size=c) * 0.5).astype(np.float32),
                (np.abs(rng.normal(size=c)) + 0.5).astype(np.float32))
            for m, c in CHANNELS.items()}


def make_subjects(rng, n):
    """Raw 30 Hz streams of unequal lengths, with a few non-finite frames."""
    subjects = []
    for _ in range(n):
        streams = {}
        for m, c in CHANNELS.items():
            x = rng.normal(size=(int(rng.integers(600, 1400)), c)).astype(np.float32)
            x[rng.integers(0, x.shape[0], 3), rng.integers(0, c, 3)] = np.nan
            streams[m] = x
        subjects.append(streams)
    return subjects


def check_close(name, got, want, tol=SERVE_TOL):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise RuntimeError(f"{name}: shape {got.shape} != {want.shape}")
    if not np.isfinite(got).all():
        raise RuntimeError(f"{name}: non-finite output")
    err = float(np.abs(got - want).max()) if got.size else 0.0
    if err > tol:
        raise RuntimeError(f"{name}: card vs CPU max abs diff {err:.3e} > {tol}")
    return err


def drive_sessions(engine, subsets, drips):
    sessions = [StreamingSession(engine, mods) for mods in subsets]
    for s, pushes in zip(sessions, drips):
        for m, x in pushes:
            s.push(m, x)
    return poll_sessions(sessions)


def serve_main_path(pairs, rng) -> dict:
    """Runs the serving entry points on each (card, CPU) engine pair and holds
    the card's outputs against the CPU's. Returns the largest differences."""
    worst = {"predict_streams": 0.0, "predict_windows": 0.0, "poll_sessions": 0.0}
    subjects = make_subjects(rng, 3)
    batch = {m: rng.normal(size=(N_WINDOWS, WIN, c)).astype(np.float32)
             for m, c in CHANNELS.items()}
    n_sessions = 32
    session_subsets = [SUBSETS[i % len(SUBSETS)] for i in range(n_sessions)]
    drips = []
    for mods in session_subsets:
        n = int(rng.integers(0, 640))
        drips.append([(m, rng.normal(size=(k, CHANNELS[m])))
                      for m in mods for k in (n // 2, n - n // 2)])
    for label, (card, cpu) in pairs.items():
        for i, streams in enumerate(subjects):
            for subset in SUBSETS:
                part = {m: streams[m] for m in subset}
                got, want = card.predict_streams(part), cpu.predict_streams(part)
                worst["predict_streams"] = max(worst["predict_streams"], check_close(
                    f"{label} subject {i} {'+'.join(subset)}",
                    got["window_probs"], want["window_probs"]))
                check_close(f"{label} subject {i} subject_probs",
                            got["subject_probs"], want["subject_probs"])
        got = card.predict_windows(batch)
        if got.shape != (N_WINDOWS, 2) or np.abs(got.sum(1) - 1).max() > 1e-5:
            raise RuntimeError(f"{label} predict_windows: bad probabilities {got.shape}")
        worst["predict_windows"] = max(worst["predict_windows"], check_close(
            f"{label} predict_windows", got, cpu.predict_windows(batch)))
        got = drive_sessions(card, session_subsets, drips)
        want = drive_sessions(cpu, session_subsets, drips)
        served = 0
        for j, (g, w) in enumerate(zip(got, want)):
            if (g is None) != (w is None):
                raise RuntimeError(f"{label} session {j}: ready on one side only")
            if g is not None:
                served += g["window_probs"].shape[0]
                worst["poll_sessions"] = max(worst["poll_sessions"], check_close(
                    f"{label} session {j}", g["window_probs"], w["window_probs"]))
        log(f"[serve] {label}: {len(subjects)} subjects x {len(SUBSETS)} subsets, "
            f"batch {N_WINDOWS}, {n_sessions} sessions ({served} windows) match the CPU")
    return worst


def phase_serving(seed, rng):
    stats = make_stats(rng)
    models = {
        "plain_head": WearGaitThreeModal(generator=torch.Generator().manual_seed(seed)),
        "norm_cosine_head": WearGaitThreeModal(
            use_norm=True, use_cosine=True,
            generator=torch.Generator().manual_seed(seed + 1)),
    }
    pairs = {label: (WearGaitEngine(m, stats, win=WIN, hop=HOP),
                     WearGaitEngine(m, stats, win=WIN, hop=HOP, device="cpu"))
             for label, m in models.items()}
    if pairs["plain_head"][0].device.type != "cuda":
        raise RuntimeError("the default engine is not on the card")
    sb.launches = 0
    worst = serve_main_path(pairs, rng)
    torch.cuda.synchronize()
    launches = {"stream_block": sb.launches}
    log(f"[serve] launches on the main path: {launches}; "
        f"max card-vs-CPU diffs {worst}")
    for name, n in launches.items():
        if n == 0:
            raise RuntimeError(f"kernel {name} was not launched on the main path")
    return pairs["plain_head"][0], launches


# ---------------------------------------------------------------------------
# 4. timings
# ---------------------------------------------------------------------------


def time_cuda(fn, warmup=20, reps=200) -> float:
    """Milliseconds per call, from CUDA events around `reps` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def stream_block_bound(bsz, t, cin, k, cout, t_out):
    moved = 4 * (bsz * t * cin + k * cin * cout + cout + bsz * t_out * cout)
    flop = 2 * bsz * t * cin * cout * k
    by_bytes, by_ops = moved / HBM_BYTES_PER_S, flop / F32_FLOP_PER_S
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def phase_timings(rng, dev, engine, card) -> dict:
    bsz, t, cin, k, cout, t_out = 3 * N_WINDOWS, 64, 12, 3, 16, 8
    x, w, b = stream_block_inputs(rng, bsz, t, cin, k, cout, dev)
    w_torch = w.permute(2, 1, 0).contiguous()  # (C_out, C_in, K) for F.conv1d

    def library():
        y = torch.relu(F.conv1d(x.transpose(1, 2), w_torch, b, padding=k // 2))
        return F.adaptive_avg_pool1d(y, t_out).transpose(1, 2)

    lib_err = (library() - sb.stream_block_reference(x, w, b, t_out)).abs().max().item()
    if lib_err > KERNEL_TOL:
        raise RuntimeError(f"library yardstick computes another function: {lib_err}")
    with torch.inference_mode():
        plain_ms = time_cuda(lambda: sb.stream_block_reference(x, w, b, t_out))
        kernel_ms = time_cuda(lambda: sb.stream_block(x, w, b, t_out))
        kernel_ms_2 = time_cuda(lambda: sb.stream_block(x, w, b, t_out))
        plain_ms_2 = time_cuda(lambda: sb.stream_block_reference(x, w, b, t_out))
        library_ms = time_cuda(library)
    bound_ms, bound_by = stream_block_bound(bsz, t, cin, k, cout, t_out)
    log(f"[time] {card}: stream_block x({bsz},{t},{cin}) k{k} -> ({bsz},{t_out},{cout}): "
        f"kernel {kernel_ms:.4f}/{kernel_ms_2:.4f} ms, plain {plain_ms:.4f}/{plain_ms_2:.4f} ms, "
        f"library conv1d+relu+adaptive_avg_pool1d {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")

    batch = {m: rng.normal(size=(N_WINDOWS, WIN, c)).astype(np.float32)
             for m, c in CHANNELS.items()}
    one = {m: v[:1] for m, v in batch.items()}
    serving = {}
    for label, req in (("batch1024", batch), ("batch1", one)):
        for _ in range(5):
            engine.predict_windows(req)
        lat = []
        t_all = time.perf_counter()
        for _ in range(LATENCY_SAMPLES):
            t0 = time.perf_counter()
            engine.predict_windows(req)  # returns numpy: synchronised
            lat.append(time.perf_counter() - t0)
        total = time.perf_counter() - t_all
        n = next(iter(req.values())).shape[0]
        serving[label] = {
            "windows_per_s": LATENCY_SAMPLES * n / total,
            "latency_ms_p50": 1e3 * float(np.percentile(lat, 50)),
            "latency_ms_p90": 1e3 * float(np.percentile(lat, 90)),
        }
        log(f"[time] {card}: predict_windows {label} (numpy in, numpy out): "
            f"{serving[label]['windows_per_s']:.1f} windows/s, latency p50 "
            f"{serving[label]['latency_ms_p50']:.4f} ms, p90 {serving[label]['latency_ms_p90']:.4f} ms")
    return {
        "stream_block": {"ms": min(kernel_ms, kernel_ms_2), "plain_ms": min(plain_ms, plain_ms_2),
                         "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by},
        "serving": serving,
    }


def phase_profile(engine, card) -> None:
    """Device time by kernel over a few batch-1024 predict_windows calls."""
    from torch.profiler import ProfilerActivity, profile

    batch = {m: np.random.default_rng(0).normal(size=(N_WINDOWS, WIN, c)).astype(np.float32)
             for m, c in CHANNELS.items()}
    engine.predict_windows(batch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            engine.predict_windows(batch)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    log(f"[profile] {card}: 10 x predict_windows batch {N_WINDOWS}, "
        f"{wall_ms:.3f} ms wall under the profiler")
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    rng = np.random.default_rng(args.seed)
    card = phase_device()
    errors = phase_kernels(rng, dev)
    engine, launches = phase_serving(args.seed, rng)
    times = phase_timings(rng, dev, engine, card)
    phase_profile(engine, card)
    st = times["stream_block"]
    kernels = [{
        "name": "stream_block",
        "route": "cuda",
        "source": "gaitpd_torch/csrc/stream_block.cu",
        "replaces": "gaitpd/ops/pallas_blocks.py:72",
        "launches": launches["stream_block"],
        "max_abs_err": errors["main"],
        "ms": st["ms"],
        "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"],
        "bound_by": st["bound_by"],
        "library_ms": st["library_ms"],
    }]
    log(f"[done] {time.perf_counter() - t_start:.1f} s; serving {json.dumps(times['serving'])}")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
