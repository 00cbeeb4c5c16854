#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gaitpd_torch) once on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases (each raises on failure, so the script exits non-zero):
  1. device: the card's name, count and power limit; build every kernel in
     gaitpd_torch/csrc with nvcc, one process each, all at once, and print
     each kernel's registers, spills and shared memory from nvcc's -Xptxas -v
     lines;
  2. kernels: each kernel against its plain PyTorch version on the card
     (f32, TF32 off): the stream block's forward (max abs <= 1e-5, two
     launches give the same bits, each line naming its variant) and
     backward (gx max abs <= 1e-5; gw, gb <= 1e-5 of the largest reference
     value; two launches give the same bits), and the CAGrad solver on 104
     Gram matrices, the degenerate ones included (w within 1e-4, objective
     within 1e-6 relative, w on the simplex, w bitwise equal);
  3. serving: WearGaitEngine.predict_streams over all 7 sensor subsets,
     predict_windows at batch 1024 and poll_sessions over 32 streaming
     sessions, for a plain-head and a LayerNorm+cosine-head model made from
     --seed; every output against the same engine on the CPU;
  4. training, this slice's main path: run_cv (WearGait, CAGrad, GCL, the
     flagship widths) on the card and on the CPU from the same seed, sync
     for 3 epochs then async for 1 (TRAIN_CV: a short run, since training
     amplifies rounding); per-epoch losses within 1e-4 relative,
     parameters after the first epoch within 1e-4 of the largest, the
     7-subset table within one eval window's share; the backward kernel
     launched 3 times and the solver once per train step; before it, one
     train step from equal parameters and batch on both, parameters within
     1e-6 and momentum within 1e-4 of the largest;
  5. the fusion slice, this slice's main path: the stream block at the
     fusion baselines' backbone widths (36 and 16 input channels) and the
     cheap cross-attention kernels against their plain versions (forward within 1e-5 up to 64
     keys, else 2e-5 + 2e-4 relative; dA, dB within 1e-5 + 1e-4 relative;
     two backward launches bitwise equal) at the training path's shape (six
     directed pairs of 1024 window tuples), the long and edge cases and the
     symmetric 2-mod shape; one train step card vs CPU for each of the four
     fusion baselines; run_cv of the cheap-xattn baseline on the card and
     the CPU (sync 3 epochs, async 1; the same checks as phase 4, and
     exactly one cheap_xattn backward, one stream-block backward and no
     solver launch per train step); run_cv with single_mod="imu" for 1 epoch;
  5b. this slice's checks, from a random stream of their own: the
     stream-block backward on cotangents with zero rows (the CAGrad task
     passes' layouts at the main shape, zero rows that start and end inside
     a block's tile, an all-zero g, a NaN in x of a zero-cotangent window),
     against its plain version (NaN at the same entries, gx of the
     zero-cotangent windows exactly 0, two launches bitwise equal); the
     cheap cross-attention at d = 65, 96 and 200 (rows in device memory),
     forward and backward, timed at d = 96 beside scaled_dot_product_attention
     and its autograd (a yardstick);
  5c. this slice's checks, from a random stream of their own: the cheap
     cross-attention at each kernel variant's edges (Tk 64/65, Tq 64/65,
     masked scores, d = 12 against 8, 16, 36, 64, N odd and N above one round
     of the persistent grid), as in phase 5; the launch of every variant
     (threads, shared memory, blocks an SM, grid);
  5d. this slice's checks, from a random stream of their own: the stream
     block's forward at each variant's edges (warp_tile's compiled-in sizes
     with GELU and a ragged last block; one size off each, generic), as in
     phase 2; the forward's launch (variant, threads, shared memory, blocks
     an SM, blocks, waves) at the main shape, the fusion widths and each edge;
     the CAGrad solver at K = 1..8 on seeded and degenerate Gram matrices, in
     one launch and one matrix a launch, w bitwise equal to the plain
     version's (phase 2 holds that too);
  5e. the SOTA baselines (DeepAV-Lite, FOCAL, TACA), from a random stream
     of their own: the stream block's wide variants at FOCAL's backbone (320
     input channels; batch 64 and 1024 sync, 3 x 64 async; ReLU and GELU)
     and at 1024 channels (wider than the generic kernels take), forward and
     backward against their plain versions as in phase 2, with each launch
     (variant, threads, shared memory, blocks an SM, blocks, windows a
     block; the backward's g_z kernel too); dropout on the card (the keep rate of a million
     entries within 5 sigma, kept entries exactly x / 0.9); one train step
     card vs CPU for each baseline (DeepAV-Lite and TACA at dropout 0) as in
     phase 4; run_cv of FOCAL on the card and the CPU (sync 3 epochs, async
     1; the checks of phase 5, and exactly one stream-block forward and one
     backward launch a train step, beside one forward an eval batch, no
     cross-attention or solver launch); run_cv of DeepAV-Lite and TACA on the
     card at their dropout (sync 1 epoch, async 1: finite losses, the
     7-subset table, no kernel launch);
  6. timings: each kernel, its plain version and a PyTorch library call at
     the main path's shape (CUDA events around back-to-back eager calls;
     the stream block's forward and its library call also as 200 calls
     replayed from a CUDA graph, the device's time without the host's)
     beside its bound, and the
     stream-block backward also in a CAGrad task pass's layout (two thirds
     of g zero) with its own bound and its launch (tile, shared memory,
     blocks an SM); serving
     windows/s and latency; one CAGrad and one cheap-xattn train step at
     batch 64 and 1024 (host clock around synchronised steps); the stream
     block's wide forward and backward at FOCAL's shape (batch 1024, GELU)
     beside their plain versions, library calls, bounds, launches and the
     generic variants that took these sizes before, then at batch 64 and
     3 x 64 (device time under the profiler, beside the library's) and,
     both variants, at C_in 32, 48 and 64 (the wrapper's threshold), and one
     train step of each SOTA baseline at batch 64 and 1024; device time
     by kernel of batch-1024 predict_windows and of 10 batch-1024 train
     steps of each (torch.profiler), the SOTA baselines' too.

Every number is printed beside the card's name and power limit. The
second-to-last line is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}. Without a CUDA device it exits 1
before printing any result.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from gaitpd_torch.data.sampler import batch_index_matrix
from gaitpd_torch.data.weargait import prepare_split
from gaitpd_torch.learning.mtl import build_flat_partition, make_method
from gaitpd_torch.models import baselines as BL
from gaitpd_torch.models.blocks import dropout
from gaitpd_torch.models.multitask import CHANNELS, MODALITIES, WearGaitThreeModal
from gaitpd_torch.ops import _build
from gaitpd_torch.ops import cagrad_solver as cs
from gaitpd_torch.ops import cheap_xattn as cx
from gaitpd_torch.ops import stream_block as sb
from gaitpd_torch.runtime.device import resolve_device
from gaitpd_torch.serve import StreamingSession, WearGaitEngine, poll_sessions
from gaitpd_torch.train import weargait_driver as wg
from gaitpd_torch.train.cv import build_subj2label, make_fixed_balanced_folds_no_overlap
from gaitpd_torch.train.optim import sgd_torch
from gaitpd_torch.train.step import StepSettings, TrainState, make_loss_ctx, make_train_step

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

KERNEL_TOL = 1e-5  # kernel vs plain version, f32, TF32 off
SERVE_TOL = 1e-5  # card vs CPU probabilities: f32, summation order only
SOLVER_W_TOL = 1e-4  # CAGrad solver kernel vs plain version: w
SOLVER_F_RTOL = 1e-6  # ... and its objective, relative
TRAIN_LOSS_RTOL = 1e-4  # card vs CPU per-epoch losses
# card vs CPU after one CAGrad step from equal parameters and batch, of the
# largest value: the momentum is the gradient, whose shared part moves with
# the CAGrad weights, and those move by up to 4e-4 where the dual objective
# is flat to f32 rounding (tests/test_torch_minnorm.py); the parameters, which
# SGD at lr 1e-3 moves by a thousandth of that
STEP_MOMENTUM_TOL = 1e-4
STEP_PARAM_TOL = 1e-6
# card vs CPU parameters after one epoch, of the largest: training amplifies
# rounding (scaling the initial parameters by 1 + 1e-7 N(0, 1) moves them
# 1.2e-4 apart after 14 steps of a larger fold on the CPU alone,
# scripts/torch_train_sensitivity.py), so the runs compared here are short
TRAIN_PARAM_TOL = 1e-4
# the compared runs: a 2-fold split of 40 subjects, fold 1 trains on 24 (3
# steps of 64 window tuples an epoch, and one empty tail batch) and
# evaluates on 16
TRAIN_CV = dict(n_folds=2, test_per_class=8, n_folds_cap=1)

N_WINDOWS = 1024  # serving batch; the backbone sees 3 * N_WINDOWS windows
LATENCY_SAMPLES = 100  # p90 then has ten samples beyond it
WIN = HOP = 64
SUBSETS = [s for r in (1, 2, 3) for s in itertools.combinations(MODALITIES, r)]
# (B, T, C_in, K, C_out, t_out, act) of the backbone on the two paths
MAIN_SHAPE = (3 * N_WINDOWS, 64, 12, 3, 16, 8, "relu")
TRAIN_BATCHES = (64, 1024)  # window tuples per train step, timed

# (N, Tq, Tk, d) of the cheap cross-attention: the training path's six
# directed pairs of 1024 and of 64 window tuples, tests/test_pallas.py:56-70's
# shapes, the symmetric 2-mod model's two directions at T = 101, then one
# query row, one key row and an odd batch
XATTN_CASES = {
    "main": (6 * N_WINDOWS, 64, 64, 12),
    "train_batch64": (6 * 64, 64, 64, 12),
    "pallas_101x426": (2, 101, 426, 12),
    "pallas_200x100": (2, 200, 100, 12),
    "pallas_grad_32x48_d8": (2, 32, 48, 8),
    "sym_t101": (2 * 64, 101, 101, 12),
    "tq1": (6 * 7, 1, 64, 12),
    "tk1": (6 * 7, 64, 1, 12),
    "odd_batch": (6 * 333 + 1, 64, 64, 12),
}
XATTN_LONG_ATOL, XATTN_LONG_RTOL = 2e-5, 2e-4  # over > 64 keys: tests/test_pallas.py:62
XATTN_GRAD_ATOL, XATTN_GRAD_RTOL = 1e-5, 1e-4  # dA, dB: tests/test_pallas.py:70

# every launch counter of the port: (module, attribute)
COUNTERS = {
    "stream_block": (sb, "launches"),
    "stream_block_backward": (sb, "backward_launches"),
    "stream_block_wide": (sb, "wide_launches"),
    "stream_block_backward_wide": (sb, "wide_backward_launches"),
    "cagrad_solver": (cs, "launches"),
    "cheap_xattn": (cx, "launches"),
    "cheap_xattn_backward": (cx, "backward_launches"),
}


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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


def time_cuda_graph(fn, warmup=20, reps=200) -> float:
    """Milliseconds per call of the device work alone: `reps` calls captured
    in one CUDA graph and replayed, CUDA events around the replay. A kernel
    shorter than its wrapper's host cost is timed so, since back-to-back
    eager calls then measure the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
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


def reset_launches() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def read_launches() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


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
        for kernel, regs, spills, rest in kernel_resources(r.log):
            log(f"[build]   {kernel}: {regs} registers, spill stores/loads {spills[0]}/"
                f"{spills[1]} bytes; {rest}")
        for line in r.log.splitlines():  # anything but ptxas's resource report
            if line.strip() and not re.match(r"\s*(ptxas info|\d+ bytes stack frame)", line):
                log(f"[build]   {line.strip()}")
    return card


def kernel_resources(log: str) -> list:
    """(kernel, registers, (spill store, spill load bytes), the rest of
    ptxas's "Used" line) of each entry function in nvcc's -Xptxas -v output,
    demangled where c++filt exists."""
    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers,?\s*(.*)", line)
        if m and name:
            rows.append([name, int(m.group(1)), spills, m.group(2).strip()])
            name = None
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60).stdout.splitlines()
        if len(out) == len(rows):
            for r, plain in zip(rows, out):  # drop the namespace and the argument list
                plain = plain.replace("(anonymous namespace)::", "").removeprefix("void ")
                r[0] = plain[:plain.find("(")] if "(" in plain else plain
    return [tuple(r) for r in rows]


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------


def stream_block_inputs(rng, bsz, t, cin, k, cout, dev, t_out=8):
    x = rng.normal(size=(bsz, t, cin)).astype(np.float32)
    w = (rng.normal(size=(k, cin, cout)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(bsz, t_out, cout)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (x, w, b, g)]


STREAM_BLOCK_CASES = {
    "main": MAIN_SHAPE,
    "train_batch64": (3 * 64, 64, 12, 3, 16, 8, "relu"),
    # the fusion baselines' backbones: early fusion's 36 concatenated
    # channels, the shared latent's 16
    "early_fusion_cin36": (3 * 64, 64, 36, 3, 16, 8, "relu"),
    "shared_latent_cin16": (3 * 64 + 1, 64, 16, 3, 16, 8, "relu"),
    "k5_gelu_cin13": (64, 64, 13, 5, 16, 8, "gelu"),
    "t101_overlapping_bins": (64, 101, 12, 3, 16, 8, "relu"),
    "ragged_batch": (3 * 333 + 1, 64, 12, 3, 16, 8, "relu"),
    "k1": (37, 64, 12, 1, 16, 8, "relu"),
}
# checked in the fusion slice's phase, from its own random stream: drawn
# here they would shift every later phase's inputs (and they did put a ReLU
# pre-activation of the library yardstick's inputs on its kink)
FUSION_WIDTH_CASES = ("early_fusion_cin36", "shared_latent_cin16")


def hold_backward(tag, x, w, b, g, t_out, act) -> tuple:
    """Two launches of the backward kernel against its plain version: gx
    within KERNEL_TOL, gw and gb within KERNEL_TOL of their largest value,
    NaN at the same entries, and the same bits twice. Returns the largest
    error and the two launches' (gx, gw, gb)."""
    before = sb.backward_launches
    grads = sb.stream_block_backward(x, w, b, g, t_out, act)
    again = sb.stream_block_backward(x, w, b, g, t_out, act)
    torch.cuda.synchronize()
    if sb.backward_launches != before + 2:
        raise RuntimeError(f"stream_block backward[{tag}]: launch count did not go up")
    want = sb.stream_block_backward_reference(x, w, b, g, t_out, act)
    errs, tols = [], []
    for i, (gk, wk) in enumerate(zip(grads, want)):
        if not torch.equal(torch.isnan(gk), torch.isnan(wk)):
            raise RuntimeError(f"stream_block backward[{tag}]: NaN where the plain version "
                               f"has none, or the reverse ({'x w b'.split()[i]})")
        ok = ~torch.isnan(wk)
        errs.append((gk[ok] - wk[ok]).abs().max().item() if ok.any() else 0.0)
        scale = wk[ok].abs().max().item() if ok.any() and i > 0 else 1.0
        tols.append(KERNEL_TOL * max(1.0, scale))
    # bit patterns: NaN == NaN there
    same = all(torch.equal(a.view(torch.int32), c.view(torch.int32)) for a, c in zip(grads, again))
    nans = [int(torch.isnan(gk).sum()) for gk in grads]
    variant = sb.BACKWARD_VARIANT_NAMES[sb._backward_variant(x.shape[1], x.shape[2], w.shape[2],
                                                             w.shape[0], t_out)]
    log(f"[kernel] stream_block_backward {tag} x{tuple(x.shape)} w{tuple(w.shape)} {act} "
        f"(variant {variant}): "
        f"gx/gw/gb max abs err {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (tol {tols[0]:.1e}/"
        f"{tols[1]:.2e}/{tols[2]:.2e}), NaN counts {nans} as the plain version's; two "
        f"launches bitwise equal: {same}")
    if not all(np.isfinite(e) and e <= tol for e, tol in zip(errs, tols)):
        raise RuntimeError(f"stream_block backward[{tag}] disagrees: {errs} vs {tols}")
    if not same:
        raise RuntimeError(f"stream_block backward[{tag}] is not deterministic")
    return max(errs), grads


def check_stream_block(rng, dev, names) -> dict:
    errors = {}
    for name in names:
        bsz, t, cin, k, cout, t_out, act = STREAM_BLOCK_CASES[name]
        x, w, b, g = stream_block_inputs(rng, bsz, t, cin, k, cout, dev, t_out)
        err = hold_forward(name, x, w, b, t_out, act)
        errors[name] = (err, hold_backward(name, x, w, b, g, t_out, act)[0])
    return errors


def hold_forward(tag, x, w, b, t_out, act) -> float:
    """Two launches of the forward kernel against its plain version: within
    KERNEL_TOL, and the same bits twice. Returns the largest error."""
    before = sb.launches
    got = sb.stream_block(x, w, b, t_out, act)
    again = sb.stream_block(x, w, b, t_out, act)
    torch.cuda.synchronize()
    if sb.launches != before + 2:
        raise RuntimeError(f"stream_block[{tag}]: launch count did not go up")
    err = (got - sb.stream_block_reference(x, w, b, t_out, act)).abs().max().item()
    same = torch.equal(got, again)
    _, t, cin = x.shape
    k, _, cout = w.shape
    variant = sb.VARIANT_NAMES[sb._variant(t, cin, cout, k, t_out)]
    log(f"[kernel] stream_block {tag} x{tuple(x.shape)} k{k} {act} (variant {variant}): "
        f"forward max abs err {err:.3e} (tol {KERNEL_TOL}); two launches bitwise equal: {same}")
    if not np.isfinite(err) or err > KERNEL_TOL:
        raise RuntimeError(f"stream_block[{tag}] disagrees with its plain version: {err}")
    if not same:
        raise RuntimeError(f"stream_block[{tag}] is not deterministic")
    return err


# the forward's variant edges: the warp_tile variant's compiled-in sizes (T
# 64, C_out 16, K 3, t_out 8, C_in 12/16/36) with GELU and a ragged last
# block, against one size off each (the generic variant)
FORWARD_EDGE_CASES = {
    "tile_cin12_gelu": (4 * 5 + 3, 64, 12, 3, 16, 8, "gelu"),
    "tile_cin16_gelu": (4 * 5 + 1, 64, 16, 3, 16, 8, "gelu"),
    "tile_cin36_gelu": (4 * 5 + 2, 64, 36, 3, 16, 8, "gelu"),
    "tile_one_window": (1, 64, 12, 3, 16, 8, "relu"),
    "cin13": (9, 64, 13, 3, 16, 8, "relu"), "cin24": (9, 64, 24, 3, 16, 8, "gelu"),
    "t63": (9, 63, 12, 3, 16, 8, "relu"), "k5": (9, 64, 12, 5, 16, 8, "relu"),
    "t_out7": (9, 64, 12, 3, 16, 7, "relu"), "cout8": (9, 64, 12, 3, 8, 8, "gelu"),
}


def check_forward_edges(rng, dev, card) -> None:
    """The forward at each variant's edges, then the launch of the main
    shape and of each edge: variant, threads, shared memory, blocks an SM,
    blocks and waves."""
    for name, (bsz, t, cin, k, cout, t_out, act) in FORWARD_EDGE_CASES.items():
        x, w, b, _ = stream_block_inputs(rng, bsz, t, cin, k, cout, dev, t_out)
        hold_forward(name, x, w, b, t_out, act)
    for name, (bsz, t, cin, k, cout, t_out, act) in {
            "main": MAIN_SHAPE, **{n: STREAM_BLOCK_CASES[n] for n in FUSION_WIDTH_CASES},
            **FORWARD_EDGE_CASES}.items():
        config = sb.forward_config(bsz, t, cin, cout, k, t_out, act)
        if config["variant"] != sb.VARIANT_NAMES[sb._variant(t, cin, cout, k, t_out)]:
            raise RuntimeError(f"stream_block[{name}]: launch of another variant {config}")
        log(f"[config] {card}: stream_block {name} (B {bsz}, T {t}, C_in {cin}, K {k}, C_out "
            f"{cout}, t_out {t_out}, {act}): {config}")


# (case of STREAM_BLOCK_CASES, rows of g set to zero, a NaN put into x at
# (window, frame, channel) or None): the CAGrad task passes at the main shape
# (each task's pass gives cotangents to its own third of the rows), zero
# rows that start and end inside a block's 8 windows, an all-zero g, and a
# NaN in x of a zero-cotangent window (the kernel must not skip it: 0 * NaN
# makes gw NaN in the plain version)
ZERO_ROW_CASES = {
    "cagrad_walkway_task": ("main", np.r_[N_WINDOWS:3 * N_WINDOWS], None),
    "cagrad_insole_task": ("main", np.r_[0:N_WINDOWS, 2 * N_WINDOWS:3 * N_WINDOWS], None),
    "unaligned_zero_rows": ("ragged_batch", np.r_[5:611], None),
    "unaligned_t101": ("t101_overlapping_bins", np.r_[3:45], None),
    "unaligned_gelu_k5": ("k5_gelu_cin13", np.r_[10:50], None),
    "all_zero": ("train_batch64", np.r_[0:3 * 64], None),
    "nan_in_zero_window": ("main", np.r_[N_WINDOWS:3 * N_WINDOWS], (1500, 20, 5)),
}


def check_zero_rows(rng, dev) -> None:
    """The backward kernel on cotangents with zero rows: the plain version's
    result (NaN at the same entries), gx of every zero-cotangent window
    without a NaN exactly 0, the same bits twice."""
    for tag, (case, zero, nan_at) in ZERO_ROW_CASES.items():
        bsz, t, cin, k, cout, t_out, act = STREAM_BLOCK_CASES[case]
        x, w, b, g = stream_block_inputs(rng, bsz, t, cin, k, cout, dev, t_out)
        g[torch.from_numpy(zero).to(dev)] = 0.0
        if nan_at is not None:
            x[nan_at] = float("nan")
        _, grads = hold_backward(tag, x, w, b, g, t_out, act)
        quiet = np.setdiff1d(zero, [] if nan_at is None else [nan_at[0]])
        if grads[0][torch.from_numpy(quiet).to(dev)].any():
            raise RuntimeError(f"stream_block backward[{tag}]: gx of a zero-cotangent "
                               f"window is not 0")
        if nan_at is not None and not torch.isnan(grads[1]).any():
            raise RuntimeError(f"stream_block backward[{tag}]: the NaN did not reach gw")


def solver_grams(rng, n, k):
    """n seeded PSD Gram matrices over four decades of scale, then the
    degenerate ones: zero, rank-1, identical tasks, one zero task."""
    a = rng.normal(size=(n, k, 6)) * 10.0 ** rng.uniform(-2, 2, size=(n, 1, 1))
    grams = a @ a.transpose(0, 2, 1) + 1e-4 * np.eye(k)
    v = rng.normal(size=k)
    zero_task = grams[0].copy()
    zero_task[0, :] = zero_task[:, 0] = 0.0
    degenerate = [np.zeros((k, k)), np.outer(v, v), np.full((k, k), 2.0), zero_task]
    return np.concatenate([grams, np.stack(degenerate)]).astype(np.float32)


def solver_objective(w, gram, c):
    """f64 CAGrad objective of w (N, K) for gram (N, K, K)."""
    k = gram.shape[-1]
    c_coef = c * np.sqrt(gram.mean((-2, -1)) + 1e-8) + 1e-8
    gb = gram @ (np.ones(k) / k)
    return (w * gb).sum(-1) + c_coef * np.sqrt(np.einsum("ni,nij,nj->n", w, gram, w) + 1e-8)


def check_solver(rng, dev) -> float:
    worst = 0.0
    for k, n in ((3, 100), (2, 20), (8, 20)):
        grams = torch.from_numpy(solver_grams(rng, n, k)).to(dev)
        before = cs.launches
        got = cs.cagrad_solve(grams, 0.5)
        torch.cuda.synchronize()
        if cs.launches != before + 1:
            raise RuntimeError("cagrad_solver: launch count did not go up")
        want = cs.cagrad_solve_reference(grams, 0.5)
        gn, wn = got.double().cpu().numpy(), want.double().cpu().numpy()
        g64 = grams.double().cpu().numpy()
        w_err = float(np.abs(gn - wn).max())
        f_got, f_want = solver_objective(gn, g64, 0.5), solver_objective(wn, g64, 0.5)
        f_err = float((np.abs(f_got - f_want) / np.maximum(np.abs(f_want), 1e-12)).max())
        bitwise = int((gn == wn).all(-1).sum())
        on_simplex = bool(np.all(gn >= 0) and np.abs(gn.sum(-1) - 1).max() <= 1e-5)
        log(f"[kernel] cagrad_solver K={k}, {len(gn)} Gram matrices: w max abs err "
            f"{w_err:.3e} (tol {SOLVER_W_TOL}), objective max rel err {f_err:.3e} "
            f"(tol {SOLVER_F_RTOL}), bitwise equal {bitwise}/{len(gn)}, on the simplex "
            f"{on_simplex}")
        if not (w_err <= SOLVER_W_TOL and f_err <= SOLVER_F_RTOL and on_simplex):
            raise RuntimeError(f"cagrad_solver K={k} disagrees with its plain version")
        if bitwise != len(gn):
            raise RuntimeError(f"cagrad_solver K={k}: w not bitwise equal on "
                               f"{len(gn) - bitwise} of {len(gn)} matrices")
        if k == 3:
            worst = w_err
    return worst


def check_solver_each_k(rng, dev) -> None:
    """The solver at every K it takes (1..8), seeded and degenerate Gram
    matrices: a batch in one launch, then each matrix alone (the main
    path's launch), w bitwise equal to the plain version's on every one."""
    for k in range(1, cs.MAX_TASKS + 1):
        grams = torch.from_numpy(solver_grams(rng, 12, k)).to(dev)
        want = cs.cagrad_solve_reference(grams, 0.5)
        batch = int((cs.cagrad_solve(grams, 0.5) == want).all(-1).sum())
        alone = sum(bool(torch.equal(cs.cagrad_solve(g, 0.5), want[i]))
                    for i, g in enumerate(grams))
        log(f"[kernel] cagrad_solver K={k}, {len(grams)} Gram matrices (4 degenerate): "
            f"bitwise equal {batch}/{len(grams)} in one launch, {alone}/{len(grams)} one "
            f"matrix a launch")
        if batch != len(grams) or alone != len(grams):
            raise RuntimeError(f"cagrad_solver K={k}: w not bitwise equal to the plain version")


def xattn_inputs(rng, n, tq, tk, d, dev):
    """A, B and a cotangent of N problems, unit normal like the LayerNorm'd
    encoder outputs the model feeds the kernel."""
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
            for s in ((n, tq, d), (n, tk, d), (n, tq, d))]


def check_cheap_xattn(rng, dev, card, cases) -> dict:
    errors = {}
    for name, (n, tq, tk, d) in cases.items():
        a, b, g = xattn_inputs(rng, n, tq, tk, d, dev)
        before = (cx.launches, cx.backward_launches)
        got = cx.cheap_xattn(a, b)
        grads = cx.cheap_xattn_backward(a, b, g)
        again = cx.cheap_xattn_backward(a, b, g)
        torch.cuda.synchronize()
        if (cx.launches, cx.backward_launches) != (before[0] + 1, before[1] + 2):
            raise RuntimeError(f"cheap_xattn[{name}]: launch counts did not go up")
        want = cx.cheap_xattn_reference(a, b)
        atol, rtol = (KERNEL_TOL, 0.0) if tk <= 64 else (XATTN_LONG_ATOL, XATTN_LONG_RTOL)
        err = (got - want).abs().max().item()
        ok = bool(((got - want).abs() <= atol + rtol * want.abs()).all())
        want_g = cx.cheap_xattn_backward_reference(a, b, g)
        errs = [(gk - wk).abs().max().item() for gk, wk in zip(grads, want_g)]
        ok_g = all(bool(((gk - wk).abs() <= XATTN_GRAD_ATOL + XATTN_GRAD_RTOL * wk.abs()).all())
                   for gk, wk in zip(grads, want_g))
        same = all(torch.equal(x, y) for x, y in zip(grads, again))
        variants = "/".join(cx.VARIANT_NAMES[cx._variant(tq, tk, d, bw)] for bw in (False, True))
        log(f"[kernel] {card}: cheap_xattn {name} (N {n}, Tq {tq}, Tk {tk}, d {d}; variants "
            f"{variants}): forward max "
            f"abs err {err:.3e} (tol {atol:.0e} + {rtol:.0e} rel); backward dA/dB max abs err "
            f"{errs[0]:.3e}/{errs[1]:.3e} (tol {XATTN_GRAD_ATOL:.0e} + {XATTN_GRAD_RTOL:.0e} "
            f"rel); two launches bitwise equal: {same}")
        if not (np.isfinite(err) and ok):
            raise RuntimeError(f"cheap_xattn[{name}] disagrees with its plain version: {err}")
        if not (all(np.isfinite(errs)) and ok_g):
            raise RuntimeError(f"cheap_xattn backward[{name}] disagrees: {errs}")
        if not same:
            raise RuntimeError(f"cheap_xattn backward[{name}] is not deterministic")
        errors[name] = (err, max(errs))
    return errors


# d beyond the kernels' register rows (64): rows in device memory. Checked
# against the plain version forward and backward; timed at the first shape.
WIDE_XATTN_CASES = {"d96_train_batch64": (6 * 64, 64, 64, 96), "d65": (2 * 7, 33, 47, 65),
                    "d200": (6, 64, 130, 200)}


def check_wide_xattn(rng, dev, card) -> None:
    for name, (n, tq, tk, d) in WIDE_XATTN_CASES.items():
        a, b, g = xattn_inputs(rng, n, tq, tk, d, dev)
        got = cx.cheap_xattn(a, b)
        grads = cx.cheap_xattn_backward(a, b, g)
        again = cx.cheap_xattn_backward(a, b, g)
        want = cx.cheap_xattn_reference(a, b)
        atol, rtol = (KERNEL_TOL, 0.0) if tk <= 64 else (XATTN_LONG_ATOL, XATTN_LONG_RTOL)
        ok = bool(((got - want).abs() <= atol + rtol * want.abs()).all())
        want_g = cx.cheap_xattn_backward_reference(a, b, g)
        ok_g = all(bool(((gk - wk).abs() <= XATTN_GRAD_ATOL + XATTN_GRAD_RTOL * wk.abs()).all())
                   for gk, wk in zip(grads, want_g))
        same = all(torch.equal(x, y) for x, y in zip(grads, again))
        errs = [(got - want).abs().max().item()] + [
            (gk - wk).abs().max().item() for gk, wk in zip(grads, want_g)]
        log(f"[kernel] {card}: cheap_xattn {name} (N {n}, Tq {tq}, Tk {tk}, d {d}, rows in "
            f"device memory): forward/dA/dB max abs err {errs[0]:.3e}/{errs[1]:.3e}/"
            f"{errs[2]:.3e}; two launches bitwise equal: {same}")
        if not (ok and ok_g and same and all(np.isfinite(errs))):
            raise RuntimeError(f"cheap_xattn[{name}] at d > 64 disagrees: {errs}, {same}")
    n, tq, tk, d = WIDE_XATTN_CASES["d96_train_batch64"]
    a, b, g = xattn_inputs(rng, n, tq, tk, d, dev)
    leaves = [t.detach().clone().requires_grad_() for t in (a, b)]

    def library():  # a yardstick: the port never calls it
        return F.scaled_dot_product_attention(a, b, b)

    def library_backward():
        out = F.scaled_dot_product_attention(leaves[0], leaves[1], leaves[1])
        return torch.autograd.grad(out, leaves, g)

    lib_errs = [(library() - cx.cheap_xattn_reference(a, b)).abs().max().item()] + [
        (p - q).abs().max().item()
        for p, q in zip(library_backward(), cx.cheap_xattn_backward_reference(a, b, g))]
    if not max(lib_errs) <= 1e-4:
        raise RuntimeError(f"library yardstick at d {d} computes another function: {lib_errs}")
    with torch.inference_mode():
        fwd_ms = time_cuda(lambda: cx.cheap_xattn(a, b), warmup=3, reps=20)
        fwd_plain = time_cuda(lambda: cx.cheap_xattn_reference(a, b), warmup=3, reps=20)
        fwd_lib = time_cuda(library, warmup=3, reps=20)
    bwd_ms = time_cuda(lambda: cx.cheap_xattn_backward(a, b, g), warmup=3, reps=20)
    bwd_plain = time_cuda(lambda: cx.cheap_xattn_backward_reference(a, b, g), warmup=3, reps=20)
    bwd_lib = time_cuda(library_backward, warmup=3, reps=20)
    log(f"[time] {card}: cheap_xattn at d {d} (N {n}, Tq {tq}, Tk {tk}, rows in device "
        f"memory): forward kernel {fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, library "
        f"scaled_dot_product_attention {fwd_lib:.4f} ms, bound "
        f"{cheap_xattn_bound(n, tq, tk, d)[0]:.5f} ms; backward kernel {bwd_ms:.4f} ms, plain "
        f"{bwd_plain:.4f} ms, library (autograd of scaled_dot_product_attention, forward "
        f"included) {bwd_lib:.4f} ms, bound {cheap_xattn_backward_bound(n, tq, tk, d)[0]:.5f} "
        f"ms; library max abs diffs forward/dA/dB {lib_errs[0]:.2e}/{lib_errs[1]:.2e}/"
        f"{lib_errs[2]:.2e}")


# each kernel variant's edges: the sweep kernels at Tk = 64 against 65 (two
# passes), Tq = 64 against 65 (the backward's two passes; the forward's second
# 64-row unit), masked scores (Tk 63), d = 12 (the compile-time width) against
# 8, 16, 36 and 64 (the general widths), N odd (a block's second unit idle in
# the last round) and N above one round of the persistent grid
XATTN_EDGE_CASES = {
    "tk64_n7": (7, 64, 64, 12), "tk65": (7, 64, 65, 12), "tq65": (7, 65, 64, 12),
    "tq65_tk65": (7, 65, 65, 12), "tk63_masked": (5, 64, 63, 12), "d8": (5, 64, 64, 8),
    "d16": (5, 64, 64, 16), "d36": (5, 64, 64, 36), "d36_ragged": (3, 33, 47, 36),
    "d64": (5, 64, 64, 64), "tq130_three_units": (3, 130, 20, 12),
    "main_plus_one": (6 * N_WINDOWS + 1, 64, 64, 12),
}
# one shape a variant for the launch table: the main shape (sweep_d12), then
# the main shape's N at d = 36 (sweep), at Tk = 65 (two_pass), at d = 96
CONFIG_SHAPES = {"main": (6 * N_WINDOWS, 64, 64, 12), "d36": (6 * N_WINDOWS, 64, 64, 36),
                 "tk65": (6 * N_WINDOWS, 64, 65, 12), "d96": (6 * N_WINDOWS, 64, 64, 96)}


def xattn_launch(n, tq, tk, d, backward) -> dict:
    """cx.launch_config plus the waves: blocks over the blocks the card holds
    at once (the sweep forward's persistent grid is one wave)."""
    config = cx.launch_config(n, tq, tk, d, backward)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    config["waves"] = config["blocks"] / (config["blocks_per_sm"] * sms)
    return config


def print_xattn_configs(card) -> None:
    for name, (n, tq, tk, d) in CONFIG_SHAPES.items():
        for backward in (False, True):
            log(f"[config] {card}: cheap_xattn{'_backward' if backward else ''} {name} "
                f"(N {n}, Tq {tq}, Tk {tk}, d {d}): {xattn_launch(n, tq, tk, d, backward)}")


# ---------------------------------------------------------------------------
# 3. serving
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
    log(f"[serve] launches on the serving path: {launches}; "
        f"max card-vs-CPU diffs {worst}")
    if launches["stream_block"] == 0:
        raise RuntimeError("kernel stream_block was not launched on the serving path")
    return pairs["plain_head"][0], launches


# ---------------------------------------------------------------------------
# 4. training, the main path
# ---------------------------------------------------------------------------


class EpochRecorder:
    """on_epoch hook of run_cv: per-epoch losses, non-empty train steps, the
    parameters after the first epoch, and the eval windows' count."""

    def __init__(self):
        self.train_loss, self.eval_loss, self.steps = [], [], 0
        self.first_epoch_params = None

    def __call__(self, fold, epoch, state, tr, ev):
        self.train_loss.append(np.asarray(tr.loss))
        self.eval_loss.append(np.asarray(ev.loss))
        self.steps += tr.steps
        if epoch == 1:
            self.first_epoch_params = {n: p.detach().cpu().clone()
                                       for n, p in state.module.named_parameters()}


def run_training(args) -> tuple:
    rec = EpochRecorder()
    t0 = time.perf_counter()
    res = wg.run_cv(args, on_epoch=rec)
    return res, rec, time.perf_counter() - t0


def first_split(args):
    """The split of run_cv's first (and, at n_folds_cap 1, only) fold."""
    streams, pd_ids, hc_ids = wg.get_streams(args)
    folds = make_fixed_balanced_folds_no_overlap(
        pd_ids, hc_ids, n_folds=args.n_folds, per_class=args.test_per_class, seed=args.seed)
    return prepare_split(streams, folds[0][0], folds[0][1], build_subj2label(pd_ids, hc_ids),
                         win=args.win_len, hop=args.hop_len)


def mask_share(args) -> float:
    """One eval window's share of a 7-subset accuracy, in points: the sync
    table pools all eval windows; the async table averages per-batch
    accuracies, where one window weighs most in the smallest batch."""
    split = first_split(args)
    n = len(split.test_sync) if not args.async_loading else min(
        len(split.test[m].keys) for m in MODALITIES)
    batches = [min(args.batch_size, n - i) for i in range(0, n, args.batch_size)]
    if not args.async_loading:
        return 100.0 / n
    return 100.0 / (len(batches) * min(batches))


def eval_forwards(args, epochs_run: int) -> int:
    """The model forwards of run_cv's eval epochs: one an eval batch (the
    fully padded tail batches too) after each epoch and for each of the 7
    masks at the best epoch."""
    pool = wg.split_to_device(first_split(args), args.async_loading, args.seed,
                              torch.device("cpu")).eval_pool
    n_batches = batch_index_matrix(np.arange(len(pool)), args.batch_size)[0].shape[0]
    return (epochs_run + len(wg.MASK_COMBOS)) * n_batches


def check_one_step(seed, dev, baseline=None) -> None:
    """One train step at batch 64 on the card and on the CPU, from equal
    parameters and an equal batch: CAGrad for the flagship, the mean of the
    branch losses for a baseline (DeepAV-Lite and TACA at dropout 0, since
    the card's masks cannot match the CPU's)."""
    runs = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        step, state, ctx, batch, gen = make_step_setup(seed, device, 64, baseline,
                                                       no_dropout=True)
        state, metrics = step(state, batch, gen, ctx)
        runs[name] = (state, metrics)
    card_state, cpu_state = runs["card"][0], runs["cpu"][0]
    gaps = {}
    for what, pick in (("parameters", lambda s, p: p),
                       ("momentum", lambda s, p: s.optimizer.state[p]["momentum_buffer"])):
        want = [pick(cpu_state, p).detach() for p in cpu_state.module.parameters()]
        got = [pick(card_state, p).detach().cpu() for p in card_state.module.parameters()]
        scale = max(1.0, max(w.abs().max().item() for w in want))
        gaps[what] = (max((g - w).abs().max().item() for g, w in zip(got, want)), scale)
    loss_gap = (runs["card"][1]["losses"].cpu() - runs["cpu"][1]["losses"]).abs().max().item()
    log(f"[train] one {baseline or 'CAGrad'} step at batch 64, card vs CPU: parameters max abs "
        f"gap {gaps['parameters'][0]:.3e} (tol {STEP_PARAM_TOL * gaps['parameters'][1]:.2e}), "
        f"momentum {gaps['momentum'][0]:.3e} (tol {STEP_MOMENTUM_TOL * gaps['momentum'][1]:.2e}), "
        f"losses {loss_gap:.3e}")
    if (gaps["parameters"][0] > STEP_PARAM_TOL * gaps["parameters"][1]
            or gaps["momentum"][0] > STEP_MOMENTUM_TOL * gaps["momentum"][1]):
        raise RuntimeError(f"one {baseline or 'CAGrad'} train step: card and CPU differ: {gaps}")


def compare_run_cv(label, common, modes, per_step, nonzero, per_eval_forward=None) -> dict:
    """run_cv on the card and on the CPU from one seed, for each (mode,
    epochs) of ``modes``; the card's run is a main path, with every launch
    count set to 0 just before it and read just after. ``per_step``: the
    launches each non-empty train step must make of a kernel; ``nonzero``:
    the kernels the run must launch at all; ``per_eval_forward``: the
    launches of a kernel each eval forward makes, beside its ``per_step``
    ones (default none)."""
    out = {}
    for mode, epochs in modes:
        args = wg.WearGaitArgs(epochs=epochs, async_loading=mode == "async", **common)
        reset_launches()
        card_res, card_rec, card_s = run_training(args)
        torch.cuda.synchronize()
        launches = read_launches()
        cpu_res, cpu_rec, cpu_s = run_training(dataclasses.replace(args, device="cpu"))
        steps = card_rec.steps
        tag = f"{label} {mode}"
        log(f"[train] {tag}: {epochs} epoch(s), {steps} train steps of batch 64; card "
            f"{card_s:.2f} s, CPU {cpu_s:.2f} s; launches on the card {launches}")
        if steps == 0 or steps != cpu_rec.steps:
            raise RuntimeError(f"train {tag}: {steps} card steps vs {cpu_rec.steps} on the CPU")
        for ep, (a, b) in enumerate(zip(card_rec.train_loss, cpu_rec.train_loss), 1):
            gap = float((np.abs(a - b) / np.abs(b)).max())
            log(f"[train] {tag} epoch {ep}: train losses card {np.round(a, 6).tolist()} "
                f"CPU {np.round(b, 6).tolist()}, max rel gap {gap:.3e} (tol {TRAIN_LOSS_RTOL})")
            if not np.all(np.isfinite(a)) or gap > TRAIN_LOSS_RTOL:
                raise RuntimeError(f"train {tag} epoch {ep}: card losses differ from the CPU's")
        scale = max(1.0, max(p.abs().max().item() for p in cpu_rec.first_epoch_params.values()))
        p_gap = max((card_rec.first_epoch_params[n] - p).abs().max().item()
                    for n, p in cpu_rec.first_epoch_params.items())
        log(f"[train] {tag}: parameters after epoch 1, max abs gap {p_gap:.3e} "
            f"(tol {TRAIN_PARAM_TOL * scale:.2e})")
        if p_gap > TRAIN_PARAM_TOL * scale:
            raise RuntimeError(f"train {tag}: parameters after epoch 1 differ from the CPU's")
        share = mask_share(args)
        if args.single_mod is not None:  # pooled accuracy, no masked table
            a, b = card_res["macro"][0], cpu_res["macro"][0]
            log(f"[train] {tag}: best pooled accuracy card {a:.4f} %, CPU {b:.4f} % "
                f"(one eval window {share:.4f} points)")
            if abs(a - b) > share + 1e-4:
                raise RuntimeError(f"train {tag}: accuracy {a} vs {b}")
        else:
            flips = 0
            for mk in wg.MASK_COMBOS:
                a, b = card_res["masks"][mk], cpu_res["masks"][mk]
                flips += a != b
                log(f"[train] {tag} mask {mk:5}: card {a:.4f} %, CPU {b:.4f} %")
                if a is None or abs(a - b) > share + 1e-4:
                    raise RuntimeError(f"train {tag} mask {mk}: {a} vs {b} "
                                       f"(one window {share:.3f})")
            log(f"[train] {tag}: {flips} of 7 subset accuracies differ, each by at most one "
                f"eval window ({share:.4f} points); macro card {card_res['macro'][0]:.4f} %, "
                f"CPU {cpu_res['macro'][0]:.4f} %")
        per_eval_forward = per_eval_forward or {}
        n_eval = eval_forwards(args, len(card_rec.train_loss)) if per_eval_forward else 0
        want = {k: n * steps + per_eval_forward.get(k, 0) * n_eval for k, n in per_step.items()}
        if per_eval_forward:
            log(f"[train] {tag}: {steps} train steps and {n_eval} eval forwards; want launches "
                f"{want}")
        wrong = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
        if wrong:
            raise RuntimeError(f"train {tag}: launches (got, want) {wrong} for {steps} steps "
                               f"and {n_eval} eval forwards")
        idle = [k for k in nonzero if launches[k] == 0]
        if idle:
            raise RuntimeError(f"train {tag}: kernel(s) {idle} were not launched")
        out[mode] = {"launches": launches, "steps": steps}
    return out


def train_common(seed) -> dict:
    return dict(synthetic=True, seed=seed, batch_size=64, wm="gcl", alpha=0.5,
                noise_mul=0.0, verbose=False, patience=50, **TRAIN_CV)


def phase_training(seed, dev) -> dict:
    """The flagship's CAGrad training (the previous slice's main path):
    3 backward and 1 solver launch a step."""
    check_one_step(seed, dev)
    return compare_run_cv("cagrad", train_common(seed), (("sync", 3), ("async", 1)),
                          {"stream_block_backward": 3, "cagrad_solver": 1, "stream_block_wide": 0,
                           "stream_block_backward_wide": 0}, ("stream_block",))


def phase_fusion_training(seed, dev) -> tuple:
    """This slice's main path: the cheap-xattn fusion baseline trains on the
    mean of its branch losses, with one launch each of the cross-attention
    and stream-block backward kernels a step and no solver; before it, one
    step of each fusion baseline (the stream block at 36 and 16 input
    channels too); after it, the single-modality mode."""
    for baseline in wg.FUSION_BASELINES:
        check_one_step(seed, dev, baseline)
    xattn = compare_run_cv(
        "cheap_xattn", dict(train_common(seed), baseline="cheap_xattn"),
        (("sync", 3), ("async", 1)),
        {"cheap_xattn_backward": 1, "stream_block_backward": 1, "cagrad_solver": 0,
         "stream_block_wide": 0, "stream_block_backward_wide": 0},
        ("stream_block", "cheap_xattn"))
    single = compare_run_cv(
        "single_mod imu", dict(train_common(seed), single_mod="imu"), (("sync", 1),),
        {"stream_block_backward": 1, "cagrad_solver": 0, "cheap_xattn": 0,
         "cheap_xattn_backward": 0}, ("stream_block",))
    return xattn, single


# ---------------------------------------------------------------------------
# 5e. the SOTA baselines: DeepAV-Lite, FOCAL, TACA
# ---------------------------------------------------------------------------

# FOCAL's backbone, (B, T, C_in, K, C_out, t_out) at 128 + 3 * 64 = 320
# input channels: a sync train step's batch, the timed batch, and an async
# step's three streams in one launch
FOCAL_SHAPES = {"sync_batch64": (64, 64, 320, 3, 16, 8),
                "sync_batch1024": (1024, 64, 320, 3, 16, 8),
                "async_batch64": (3 * 64, 64, 320, 3, 16, 8)}
# the wide variants beyond the generic kernels' limit (one window and w in
# shared memory, about 510 channels)
WIDE_ONLY_SHAPES = {"cin1024_batch65": (65, 64, 1024, 3, 16, 8)}
DROPOUT_RATE = 0.1  # DeepAV-Lite's and TACA's default
DROPOUT_ENTRIES = 1_000_000


def focal_block_inputs(rng, bsz, t, cin, k, cout, dev, t_out):
    """x, w, b, g at the scale of FOCAL's backbone: unit-normal projected
    frames and a kernel of standard deviation 1/sqrt(K * C_in), so the
    960-term pre-activations are of unit scale."""
    x = rng.normal(size=(bsz, t, cin)).astype(np.float32)
    w = (rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin)).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(bsz, t_out, cout)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (x, w, b, g)]


def check_focal_blocks(rng, dev, card) -> dict:
    """The stream block's wide variants at FOCAL's shapes and beyond the
    generic kernels' width, ReLU and GELU, against their plain versions (as
    phase 2: two launches the same bits), and each launch."""
    errors = {}
    for name, (bsz, t, cin, k, cout, t_out) in {**FOCAL_SHAPES, **WIDE_ONLY_SHAPES}.items():
        for act in ("relu", "gelu"):
            x, w, b, g = focal_block_inputs(rng, bsz, t, cin, k, cout, dev, t_out)
            tag = f"focal_{name}_{act}"
            errors[tag] = (hold_forward(tag, x, w, b, t_out, act),
                           hold_backward(tag, x, w, b, g, t_out, act)[0])
        forward = sb.forward_config(bsz, t, cin, cout, k, t_out, "gelu")
        backward = sb.backward_config(bsz, t, cin, cout, k, t_out, "gelu")
        log(f"[config] {card}: stream_block focal_{name} (B {bsz}, T {t}, C_in {cin}, K {k}, "
            f"C_out {cout}, t_out {t_out}, gelu): forward {forward}; backward {backward}")
        if forward["variant"] != "wide" or backward["variant"] != "wide":
            raise RuntimeError(f"stream_block focal_{name}: not the wide variants: "
                               f"{forward['variant']}, {backward['variant']}")
    return errors


def check_dropout_on_card(dev) -> None:
    """The baselines' dropout on the card: the keep rate over a million
    entries within 5 sigma of 1 - rate, every kept entry exactly x / (1 -
    rate) (IEEE division, as on the CPU), the identity at eval, and the
    global CUDA generator untouched."""
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(DROPOUT_ENTRIES, device=dev, generator=gen) + 4.0  # no entry is 0
    state = torch.cuda.get_rng_state(dev)
    y = dropout(x, DROPOUT_RATE, gen, train=True)
    kept = (y != 0).cpu()
    keep = 1.0 - DROPOUT_RATE
    sigma = float(np.sqrt(DROPOUT_ENTRIES * keep * DROPOUT_RATE))
    n_kept = int(kept.sum())
    exact = torch.equal(y.cpu()[kept], (x.cpu() / torch.tensor(keep))[kept])
    untouched = torch.equal(torch.cuda.get_rng_state(dev), state)
    identity = dropout(x, DROPOUT_RATE, gen, train=False) is x
    log(f"[kernel] dropout rate {DROPOUT_RATE} on the card: kept {n_kept} of {DROPOUT_ENTRIES} "
        f"({(n_kept - keep * DROPOUT_ENTRIES) / sigma:+.2f} sigma from {keep}); kept entries "
        f"exactly x / {keep}: {exact}; identity at eval: {identity}; global generator "
        f"untouched: {untouched}")
    if abs(n_kept - keep * DROPOUT_ENTRIES) > 5 * sigma or not (exact and identity and untouched):
        raise RuntimeError("dropout on the card does not keep its law")


def card_only_run_cv(label, common, modes) -> dict:
    """run_cv on the card alone, at the baseline's own dropout, whose masks
    the CPU cannot draw alike (phase 5e's one-step check holds the card
    against the CPU at dropout 0): finite losses, the 7-subset table, and no
    launch of the stream-block, cross-attention or solver kernels."""
    out = {}
    for mode, epochs in modes:
        args = wg.WearGaitArgs(epochs=epochs, async_loading=mode == "async", **common)
        reset_launches()
        res, rec, secs = run_training(args)
        torch.cuda.synchronize()
        launches = read_launches()
        tag = f"{label} {mode}"
        log(f"[train] {tag}: {epochs} epoch(s), {rec.steps} train steps of batch 64 on the "
            f"card, {secs:.2f} s; train losses {[np.round(a, 6).tolist() for a in rec.train_loss]};"
            f" launches {launches}")
        for mk in wg.MASK_COMBOS:
            log(f"[train] {tag} mask {mk:5}: card {res['masks'][mk]:.4f} %")
        losses = np.concatenate(rec.train_loss + rec.eval_loss)
        if rec.steps == 0 or not np.all(np.isfinite(losses)):
            raise RuntimeError(f"train {tag}: {rec.steps} steps, losses {losses}")
        if any(res["masks"][mk] is None or not np.isfinite(res["masks"][mk])
               for mk in wg.MASK_COMBOS):
            raise RuntimeError(f"train {tag}: the 7-subset table is incomplete: {res['masks']}")
        if any(launches.values()):
            raise RuntimeError(f"train {tag}: launched a kernel it has no use for: {launches}")
        out[mode] = {"launches": launches, "steps": rec.steps}
    return out


def phase_sota_training(seed, dev) -> dict:
    """This slice's main path: one step of each SOTA baseline card vs CPU;
    FOCAL's run_cv on the card and the CPU (one stream-block forward and one
    backward a train step, sync and async, no other kernel); DeepAV-Lite's
    and TACA's run_cv on the card at their dropout."""
    for baseline in wg.SOTA_BASELINES:
        check_one_step(seed, dev, baseline)
    out = {"focal": compare_run_cv(
        "focal", dict(train_common(seed), baseline="focal"), (("sync", 3), ("async", 1)),
        {"stream_block": 1, "stream_block_backward": 1, "stream_block_wide": 1,
         "stream_block_backward_wide": 1, "cagrad_solver": 0, "cheap_xattn": 0,
         "cheap_xattn_backward": 0}, ("stream_block_wide", "stream_block_backward_wide"),
        per_eval_forward={"stream_block": 1, "stream_block_wide": 1})}
    for baseline in wg.DROPOUT_BASELINES:
        out[baseline] = card_only_run_cv(baseline, dict(train_common(seed), baseline=baseline),
                                         (("sync", 1), ("async", 1)))
    return out


# ---------------------------------------------------------------------------
# 5. timings
# ---------------------------------------------------------------------------


def stream_block_bound(bsz, t, cin, k, cout, t_out):
    moved = 4 * (bsz * t * cin + k * cin * cout + cout + bsz * t_out * cout)
    flop = 2 * bsz * t * cin * cout * k
    return _bound(moved, flop)


def stream_block_backward_bound(bsz, t, cin, k, cout, t_out, live=None):
    """Read x, w, b, g once, write gx, gw, gb once (for every window); on the
    ``live`` windows (all by default) recompute z, then gx and gw, each
    2*T*Cin*Cout*K FLOP a window, plus g_y, act' and gb, about 4 per z."""
    live = bsz if live is None else live
    moved = 4 * (2 * bsz * t * cin + 2 * (k * cin * cout + cout) + bsz * t_out * cout)
    flop = 3 * 2 * live * t * cin * cout * k + 4 * live * t * cout
    return _bound(moved, flop)


def solver_ops(k, iters=60, ls_iters=30, rounds=4):
    """f32 operations of one solve, counted from csrc/cagrad_solver.cu."""
    dot = 2 * k - 1
    f = k * dot + 2 * dot + 4  # G w, two dot products, +EPS, sqrt, *c, +
    golden = ls_iters * (6 + 4 * k + 2 * f + 1) + 2
    line_step = golden + 2 * k + 2 * f + 1
    outer = k * dot + dot + 2 + 5 * k + k * k + 5 * k + k + line_step
    polish = rounds * k * (k - 1) * (k + line_step)
    setup = 2 * k * k + 6 + k * dot + 3
    return setup + iters * outer + polish


def _bound(moved, flop):
    by_bytes, by_ops = moved / HBM_BYTES_PER_S, flop / F32_FLOP_PER_S
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def time_stream_block(rng, dev, card) -> dict:
    bsz, t, cin, k, cout, t_out, _ = MAIN_SHAPE
    x, w, b, g = stream_block_inputs(rng, bsz, t, cin, k, cout, dev, t_out)
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
        # the same calls without the host: the plain version copies its
        # pooling matrix from pageable host memory each call, which a graph
        # cannot capture, so it has no graph time
        graph_ms = time_cuda_graph(lambda: sb.stream_block(x, w, b, t_out))
        library_graph_ms = time_cuda_graph(library)
        graph_ms_2 = time_cuda_graph(lambda: sb.stream_block(x, w, b, t_out))
    bound_ms, bound_by = stream_block_bound(bsz, t, cin, k, cout, t_out)
    launch = sb.forward_config(bsz, t, cin, cout, k, t_out)
    log(f"[time] {card}: stream_block x({bsz},{t},{cin}) k{k} -> ({bsz},{t_out},{cout}), "
        f"variant {launch['variant']}: back-to-back eager calls (host included): kernel "
        f"{kernel_ms:.4f}/{kernel_ms_2:.4f} ms, plain {plain_ms:.4f}/{plain_ms_2:.4f} ms, "
        f"library conv1d+relu+adaptive_avg_pool1d {library_ms:.4f} ms; 200 calls replayed "
        f"from a CUDA graph (device only): kernel {graph_ms:.4f}/{graph_ms_2:.4f} ms, library "
        f"{library_graph_ms:.4f} ms, plain not capturable; bound {bound_ms:.5f} ms "
        f"({bound_by}); launch {launch}")

    # the backward: (x, w, b, g) -> (gx, gw, gb), each version from scratch
    leaves = [t_.detach().clone().requires_grad_() for t_ in (x, w, b)]

    def library_backward():
        xl, wl, bl = leaves
        y = torch.relu(F.conv1d(xl.transpose(1, 2), wl.permute(2, 1, 0), bl, padding=k // 2))
        out = F.adaptive_avg_pool1d(y, t_out).transpose(1, 2)
        return torch.autograd.grad(out, leaves, g)

    lib_b = library_backward()
    want = sb.stream_block_backward_reference(x, w, b, g, t_out)
    lib_b_err = max((p - q).abs().max().item() / max(1.0, q.abs().max().item())
                    for p, q in zip(lib_b, want))
    if lib_b_err > KERNEL_TOL:
        raise RuntimeError(f"library backward computes another function: {lib_b_err}")
    bwd_plain = time_cuda(lambda: sb.stream_block_backward_reference(x, w, b, g, t_out),
                          warmup=5, reps=50)
    bwd_kernel = time_cuda(lambda: sb.stream_block_backward(x, w, b, g, t_out))
    bwd_kernel_2 = time_cuda(lambda: sb.stream_block_backward(x, w, b, g, t_out))
    bwd_plain_2 = time_cuda(lambda: sb.stream_block_backward_reference(x, w, b, g, t_out),
                            warmup=5, reps=50)
    bwd_library = time_cuda(library_backward, warmup=5, reps=50)
    bwd_bound, bwd_by = stream_block_backward_bound(bsz, t, cin, k, cout, t_out)
    config = sb.backward_config(bsz, t, cin, cout, k, t_out)
    log(f"[time] {card}: stream_block_backward at x({bsz},{t},{cin}) k{k}, all windows live: "
        f"kernel {bwd_kernel:.4f}/{bwd_kernel_2:.4f} ms, plain (autograd of the plain forward) "
        f"{bwd_plain:.4f}/{bwd_plain_2:.4f} ms, library (autograd of conv1d+relu+"
        f"adaptive_avg_pool1d, forward included) {bwd_library:.4f} ms, bound "
        f"{bwd_bound:.5f} ms ({bwd_by}); launch {config} (on "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs)")

    # a CAGrad task pass: only the walkway stream's third carries cotangents
    g_task = g.clone()
    g_task[N_WINDOWS:] = 0.0
    task_kernel = time_cuda(lambda: sb.stream_block_backward(x, w, b, g_task, t_out))
    task_plain = time_cuda(lambda: sb.stream_block_backward_reference(x, w, b, g_task, t_out),
                           warmup=5, reps=50)
    task_kernel_2 = time_cuda(lambda: sb.stream_block_backward(x, w, b, g_task, t_out))
    task_bound, task_by = stream_block_backward_bound(bsz, t, cin, k, cout, t_out,
                                                      live=N_WINDOWS)
    log(f"[time] {card}: stream_block_backward at x({bsz},{t},{cin}) k{k}, CAGrad task layout "
        f"(rows {N_WINDOWS}.. of g zero): kernel {task_kernel:.4f}/{task_kernel_2:.4f} ms, "
        f"plain {task_plain:.4f} ms, bound {task_bound:.5f} ms ({task_by}: operations on the "
        f"live third, bytes on all)")
    return {
        "stream_block": {"ms": min(kernel_ms, kernel_ms_2), "plain_ms": min(plain_ms, plain_ms_2),
                         "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                         "variant": launch["variant"], "launch": launch,
                         "graph_ms": min(graph_ms, graph_ms_2),
                         "library_graph_ms": library_graph_ms},
        "stream_block_backward": {"ms": min(bwd_kernel, bwd_kernel_2),
                                  "plain_ms": min(bwd_plain, bwd_plain_2),
                                  "library_ms": bwd_library, "bound_ms": bwd_bound,
                                  "bound_by": bwd_by,
                                  "cagrad_layout_ms": min(task_kernel, task_kernel_2),
                                  "cagrad_layout_plain_ms": task_plain,
                                  "cagrad_layout_bound_ms": task_bound,
                                  "cagrad_layout_bound_by": task_by},
    }


def device_ms(fn, reps=20) -> float:
    """Milliseconds of device time per call: the self time of its kernels
    under torch.profiler, without the host's cost (which sets the pace of a
    small launch's back-to-back eager calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    return us / 1e3 / reps


def focal_library(x, w, b, k, t_out):
    """A yardstick: conv1d + GELU + adaptive_avg_pool1d (the port never
    calls it)."""
    y = F.gelu(F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), b, padding=k // 2))
    return F.adaptive_avg_pool1d(y, t_out).transpose(1, 2)


def time_focal_block(rng, dev, card) -> dict:
    """The stream block's wide forward and backward at FOCAL's shape (batch
    1024, 320 channels, GELU): kernel, plain version, library call, bound,
    launch, and the generic variants that took these sizes before, in this
    call; then at the train steps' batches (64, 3 x 64), and both variants
    at and below the wrapper's threshold (C_in 32, 48 and 64)."""
    bsz, t, cin, k, cout, t_out = FOCAL_SHAPES["sync_batch1024"]
    x, w, b, g = focal_block_inputs(rng, bsz, t, cin, k, cout, dev, t_out)
    leaves = [t_.detach().clone().requires_grad_() for t_ in (x, w, b)]

    def library_backward():
        return torch.autograd.grad(focal_library(*leaves, k, t_out), leaves, g)

    want = sb.stream_block_reference(x, w, b, t_out, "gelu")
    want_b = sb.stream_block_backward_reference(x, w, b, g, t_out, "gelu")
    lib_err = max([(focal_library(x, w, b, k, t_out) - want).abs().max().item()] + [
        (p - q).abs().max().item() / max(1.0, q.abs().max().item())
        for p, q in zip(library_backward(), want_b)])
    if lib_err > KERNEL_TOL:
        raise RuntimeError(f"library yardstick at FOCAL's shape computes another function: "
                           f"{lib_err}")
    with torch.inference_mode():
        fwd = {"plain": time_cuda(lambda: sb.stream_block_reference(x, w, b, t_out, "gelu")),
               "kernel": time_cuda(lambda: sb.stream_block(x, w, b, t_out, "gelu")),
               "generic": time_cuda(lambda: sb._forward_kernel(x, w, b, t_out, "gelu",
                                                               sb.GENERIC)),
               "kernel_2": time_cuda(lambda: sb.stream_block(x, w, b, t_out, "gelu")),
               "plain_2": time_cuda(lambda: sb.stream_block_reference(x, w, b, t_out, "gelu")),
               "library": time_cuda(lambda: focal_library(x, w, b, k, t_out))}
    bwd = {"plain": time_cuda(lambda: sb.stream_block_backward_reference(
               x, w, b, g, t_out, "gelu"), warmup=3, reps=20),
           "kernel": time_cuda(lambda: sb.stream_block_backward(x, w, b, g, t_out, "gelu"),
                               warmup=3, reps=20),
           "generic": time_cuda(lambda: sb._backward_kernel(x, w, b, g, t_out, "gelu",
                                                            sb.BWD_GENERIC), warmup=3, reps=20),
           "kernel_2": time_cuda(lambda: sb.stream_block_backward(x, w, b, g, t_out, "gelu"),
                                 warmup=3, reps=20),
           "plain_2": time_cuda(lambda: sb.stream_block_backward_reference(
               x, w, b, g, t_out, "gelu"), warmup=3, reps=20),
           "library": time_cuda(library_backward, warmup=3, reps=20)}
    launch = {"forward": sb.forward_config(bsz, t, cin, cout, k, t_out, "gelu"),
              "backward": sb.backward_config(bsz, t, cin, cout, k, t_out, "gelu")}
    log(f"[config] {card}: stream_block at FOCAL's shape x({bsz},{t},{cin}) k{k} gelu: forward "
        f"{launch['forward']}; backward {launch['backward']}")
    out = {}
    for what, ms, (bound_ms, bound_by), fn in (
            ("stream_block", fwd, stream_block_bound(bsz, t, cin, k, cout, t_out),
             lambda: sb.stream_block(x, w, b, t_out, "gelu")),
            ("stream_block_backward", bwd,
             stream_block_backward_bound(bsz, t, cin, k, cout, t_out),
             lambda: sb.stream_block_backward(x, w, b, g, t_out, "gelu"))):
        part = "forward" if what == "stream_block" else "backward"
        autograd = ", autograd, forward included" if part == "backward" else ""
        out[what] = {"ms": min(ms["kernel"], ms["kernel_2"]),
                     "plain_ms": min(ms["plain"], ms["plain_2"]), "library_ms": ms["library"],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "variant": launch[part]["variant"],
                     "launch": launch[part], "device_ms": device_ms(fn),
                     "generic_ms": ms["generic"]}
        log(f"[time] {card}: {what} at FOCAL's shape x({bsz},{t},{cin}) k{k} gelu -> "
            f"({bsz},{t_out},{cout}), variant {launch[part]['variant']}: kernel "
            f"{ms['kernel']:.4f}/"
            f"{ms['kernel_2']:.4f} ms (device {out[what]['device_ms']:.4f}), generic variant "
            f"{ms['generic']:.4f} ms, plain {ms['plain']:.4f}/{ms['plain_2']:.4f} ms, library "
            f"(conv1d+gelu+adaptive_avg_pool1d{autograd}) {ms['library']:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by})")

    # the train steps' batches: device time, since the eager calls time the host
    for name in ("sync_batch64", "async_batch64"):
        bsz, t, cin, k, cout, t_out = FOCAL_SHAPES[name]
        xb, wb, bb, gb = focal_block_inputs(rng, bsz, t, cin, k, cout, dev, t_out)
        lv = [t_.detach().clone().requires_grad_() for t_ in (xb, wb, bb)]
        with torch.inference_mode():
            f_ms = {"kernel": device_ms(lambda: sb.stream_block(xb, wb, bb, t_out, "gelu")),
                    "eager": time_cuda(lambda: sb.stream_block(xb, wb, bb, t_out, "gelu")),
                    "library": device_ms(lambda: focal_library(xb, wb, bb, k, t_out))}
        b_ms = {"kernel": device_ms(lambda: sb.stream_block_backward(xb, wb, bb, gb, t_out,
                                                                     "gelu")),
                "eager": time_cuda(lambda: sb.stream_block_backward(xb, wb, bb, gb, t_out,
                                                                    "gelu")),
                "library": device_ms(lambda: torch.autograd.grad(
                    focal_library(*lv, k, t_out), lv, gb))}
        bounds = (stream_block_bound(bsz, t, cin, k, cout, t_out)[0],
                  stream_block_backward_bound(bsz, t, cin, k, cout, t_out)[0])
        out[f"{name}_ms"] = {"forward": f_ms, "backward": b_ms, "bound_ms": bounds}
        log(f"[time] {card}: stream_block wide at FOCAL's {name} x({bsz},{t},{cin}) gelu: "
            f"forward device {f_ms['kernel']:.4f} ms (eager {f_ms['eager']:.4f}), library "
            f"device {f_ms['library']:.4f}, bound {bounds[0]:.5f}; backward device "
            f"{b_ms['kernel']:.4f} ms (eager {b_ms['eager']:.4f}), library autograd device "
            f"{b_ms['library']:.4f}, bound {bounds[1]:.5f}; launch forward "
            f"{sb.forward_config(bsz, t, cin, cout, k, t_out, 'gelu')}, backward "
            f"{sb.backward_config(bsz, t, cin, cout, k, t_out, 'gelu')}")

    # the threshold: both variants at and below the C_in where the wrapper
    # starts to take the wide ones (36 is warp_tile's)
    out["threshold_ms"] = {}
    for cin in (32, 48, sb.WIDE_MIN_CIN):
        bsz, t, k, cout, t_out = 1024, 64, 3, 16, 8
        xt, wt, bt, gt = focal_block_inputs(rng, bsz, t, cin, k, cout, dev, t_out)
        with torch.inference_mode():
            edge = {v: device_ms(lambda v=v: sb._forward_kernel(xt, wt, bt, t_out, "gelu", v))
                    for v in (sb.WIDE, sb.GENERIC)}
        edge_b = {v: device_ms(lambda v=v: sb._backward_kernel(xt, wt, bt, gt, t_out, "gelu",
                                                                 v))
                  for v in (sb.BWD_WIDE, sb.BWD_GENERIC)}
        out["threshold_ms"][cin] = {
            "forward_wide": edge[sb.WIDE], "forward_generic": edge[sb.GENERIC],
            "backward_wide": edge_b[sb.BWD_WIDE], "backward_generic": edge_b[sb.BWD_GENERIC]}
        log(f"[time] {card}: stream_block at x({bsz},{t},{cin}) gelu (the wrapper's wide "
            f"variants from C_in {sb.WIDE_MIN_CIN}), device: forward wide "
            f"{edge[sb.WIDE]:.4f} ms, generic {edge[sb.GENERIC]:.4f} ms; backward wide "
            f"{edge_b[sb.BWD_WIDE]:.4f} ms, generic {edge_b[sb.BWD_GENERIC]:.4f} ms")
    return out


def cheap_xattn_bound(n, tq, tk, d):
    """Read A and B once, write O once; two products of 2*N*Tq*Tk*d FLOP."""
    return _bound(4 * n * d * (2 * tq + tk), 2 * 2 * n * tq * tk * d)


def cheap_xattn_backward_bound(n, tq, tk, d):
    """Read A, B, dO once, write dA, dB once; five products (S, dP, dA, and
    dB's two), each 2*N*Tq*Tk*d FLOP."""
    return _bound(4 * n * d * (3 * tq + 2 * tk), 5 * 2 * n * tq * tk * d)


def time_cheap_xattn(rng, dev, card) -> dict:
    n, tq, tk, d = XATTN_CASES["main"]
    a, b, g = xattn_inputs(rng, n, tq, tk, d, dev)

    def library():  # its default scale is 1/sqrt(d): the same function
        return F.scaled_dot_product_attention(a, b, b)

    lib_err = (library() - cx.cheap_xattn_reference(a, b)).abs().max().item()
    if lib_err > KERNEL_TOL:
        raise RuntimeError(f"library yardstick computes another function: {lib_err}")
    with torch.inference_mode():
        plain_ms = time_cuda(lambda: cx.cheap_xattn_reference(a, b))
        kernel_ms = time_cuda(lambda: cx.cheap_xattn(a, b))
        kernel_ms_2 = time_cuda(lambda: cx.cheap_xattn(a, b))
        plain_ms_2 = time_cuda(lambda: cx.cheap_xattn_reference(a, b))
        library_ms = time_cuda(library)
    bound_ms, bound_by = cheap_xattn_bound(n, tq, tk, d)
    log(f"[time] {card}: cheap_xattn N {n}, Tq {tq}, Tk {tk}, d {d}: kernel "
        f"{kernel_ms:.4f}/{kernel_ms_2:.4f} ms, plain {plain_ms:.4f}/{plain_ms_2:.4f} ms, "
        f"library scaled_dot_product_attention {library_ms:.4f} ms (max abs diff "
        f"{lib_err:.2e}), bound {bound_ms:.5f} ms ({bound_by})")

    leaves = [t.detach().clone().requires_grad_() for t in (a, b)]

    def library_backward():
        out = F.scaled_dot_product_attention(leaves[0], leaves[1], leaves[1])
        return torch.autograd.grad(out, leaves, g)

    want = cx.cheap_xattn_backward_reference(a, b, g)
    lib_b_err = max((p - q).abs().max().item() for p, q in zip(library_backward(), want))
    if lib_b_err > XATTN_GRAD_ATOL + XATTN_GRAD_RTOL * max(q.abs().max().item() for q in want):
        raise RuntimeError(f"library backward computes another function: {lib_b_err}")
    bwd_plain = time_cuda(lambda: cx.cheap_xattn_backward_reference(a, b, g), warmup=5, reps=50)
    bwd_kernel = time_cuda(lambda: cx.cheap_xattn_backward(a, b, g))
    bwd_kernel_2 = time_cuda(lambda: cx.cheap_xattn_backward(a, b, g))
    bwd_plain_2 = time_cuda(lambda: cx.cheap_xattn_backward_reference(a, b, g),
                            warmup=5, reps=50)
    bwd_library = time_cuda(library_backward, warmup=5, reps=50)
    bwd_bound, bwd_by = cheap_xattn_backward_bound(n, tq, tk, d)
    launch = {bw: xattn_launch(n, tq, tk, d, bw) for bw in (False, True)}
    log(f"[time] {card}: cheap_xattn launch {launch[False]}; cheap_xattn_backward launch "
        f"{launch[True]}")
    log(f"[time] {card}: cheap_xattn_backward at N {n}, Tq {tq}, Tk {tk}, d {d}: kernel "
        f"{bwd_kernel:.4f}/{bwd_kernel_2:.4f} ms, plain (autograd of the plain forward) "
        f"{bwd_plain:.4f}/{bwd_plain_2:.4f} ms, library (autograd of "
        f"scaled_dot_product_attention, forward included; max abs diff {lib_b_err:.2e}) "
        f"{bwd_library:.4f} ms, bound {bwd_bound:.5f} ms ({bwd_by})")
    return {
        "cheap_xattn": {"ms": min(kernel_ms, kernel_ms_2), "plain_ms": min(plain_ms, plain_ms_2),
                        "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "launch": launch[False]},
        "cheap_xattn_backward": {"ms": min(bwd_kernel, bwd_kernel_2),
                                 "plain_ms": min(bwd_plain, bwd_plain_2),
                                 "library_ms": bwd_library, "bound_ms": bwd_bound,
                                 "bound_by": bwd_by, "launch": launch[True]},
    }


# The solver's dependent chain at K = 3, the estimate of
# csrc/cagrad_solver.cu's header from clock64() readings of the kernel: 84
# golden-section searches of 6 rounds of about 320 cycles (plus 8 for the
# midpoint) and about 60,000 cycles of serial outer steps, at the H100 SXM's
# 1,980 MHz maximum SM clock. An estimate, not a reading of this run: it is
# printed beside the times and kept out of the kernels line.
SOLVER_CHAIN_MS = 1e3 * (84 * (6 * 320 + 8) + 60_000) / 1.98e9


def time_solver(rng, dev, card) -> dict:
    gram = torch.from_numpy(solver_grams(rng, 1, 3)[0]).to(dev)  # the main path: K = 3
    kernel_ms = time_cuda(lambda: cs.cagrad_solve(gram, 0.5), warmup=10, reps=200)
    plain_ms = time_cuda(lambda: cs.cagrad_solve_reference(gram, 0.5), warmup=1, reps=3)
    kernel_ms_2 = time_cuda(lambda: cs.cagrad_solve(gram, 0.5), warmup=10, reps=200)
    bound_ms, bound_by = _bound(4 * (9 + 3), solver_ops(3))
    log(f"[time] {card}: cagrad_solver K=3 (one Gram matrix): kernel {kernel_ms:.4f}/"
        f"{kernel_ms_2:.4f} ms, plain (eager torch on the card, 3 calls) {plain_ms:.2f} ms, "
        f"bound {bound_ms:.3e} ms ({bound_by}: {solver_ops(3)} f32 operations); the "
        f"dependent chain's estimate (csrc/cagrad_solver.cu's header, not measured here) "
        f"{SOLVER_CHAIN_MS:.4f} ms at 1980 MHz")
    return {"ms": min(kernel_ms, kernel_ms_2), "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by}


def time_serving(engine, rng, card) -> dict:
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
    return serving


def make_step_setup(seed, dev, bsz, baseline=None, no_dropout=False):
    """A flagship model with its SGD and CAGrad step, or a baseline with SGD
    on the mean of its branch losses (sync; DeepAV-Lite and TACA with their
    dropout, or at rate 0 with ``no_dropout``), one card-resident batch of
    ``bsz`` window tuples, and the step's generator."""
    args = wg.WearGaitArgs(seed=seed, baseline=baseline)
    model = wg.build_model(args, True)
    if no_dropout:
        BL.without_dropout(model)
    model = model.to(dev)
    settings = StepSettings(n_streams=3, wm="gcl", synchronized=True,
                            private_grads="sum_plus_own",
                            dropout=baseline in wg.DROPOUT_BASELINES)
    if baseline is None:
        mtl = make_method("cagrad", 3, c=0.5)
        step = make_train_step(settings, mtl, build_flat_partition(
            model, model.shared_modules, model.task_modules))
        mtl_state = mtl.init_state()
    else:
        step = make_train_step(settings, train_apply=wg.baseline_adapters(args)[0])
        mtl_state = {}
    state = TrainState(module=model, optimizer=sgd_torch(model.parameters(), 1e-3),
                       mtl_state=mtl_state)
    ctx = make_loss_ctx(settings, [[900, 700]] * 3, device=dev)
    g = torch.Generator().manual_seed(seed)  # on the host: the same batch on any device
    batch = {
        "xs": tuple(torch.randn((bsz, args.win_len, CHANNELS[m]), generator=g).to(dev)
                    for m in MODALITIES),
        "ys": tuple(torch.randint(0, 2, (bsz,), generator=g).to(dev) for _ in MODALITIES),
        "valid": torch.ones(bsz, device=dev),
        "n_valid": bsz,
    }
    return step, state, ctx, batch, torch.Generator(device=dev).manual_seed(seed)


def time_train_step(seed, dev, card, baseline=None) -> dict:
    out = {}
    for bsz in TRAIN_BATCHES:
        step, state, ctx, batch, gen = make_step_setup(seed, dev, bsz, baseline)
        for _ in range(3):
            step(state, batch, gen, ctx)
        torch.cuda.synchronize()
        reps = 20
        t0 = time.perf_counter()
        for _ in range(reps):
            _, metrics = step(state, batch, gen, ctx)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / reps
        if not torch.isfinite(metrics["losses"]).all():
            raise RuntimeError(f"train step at batch {bsz}: non-finite loss")
        out[f"batch{bsz}"] = {"ms": ms, "window_tuples_per_s": 1e3 * bsz / ms}
        log(f"[time] {card}: {baseline or 'CAGrad'} train step, batch {bsz} window tuples "
            f"(card-resident): "
            f"{ms:.3f} ms, {1e3 * bsz / ms:.1f} window tuples/s")
    return out


def profile_table(prof, label, wall_ms, card) -> None:
    from torch.autograd import DeviceType

    events = prof.key_averages()
    # kernels only: a user annotation (the optimizer's step range) is a CUDA
    # event too, and would count its kernels twice
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    log(f"[profile] {card}: {label}: {wall_ms:.3f} ms wall under the profiler, "
        f"{device_us / 1e3:.3f} ms device time (sum of kernel self times), device idle "
        f"{100 * max(0.0, 1 - device_us / 1e3 / wall_ms):.1f} %")
    log(events.table(sort_by="self_device_time_total", row_limit=25))


def phase_profiles(engine, seed, dev, card) -> None:
    """Device time by kernel over 10 batch-1024 predict_windows calls, 10
    batch-1024 CAGrad train steps and 10 batch-1024 cheap-xattn train steps."""
    from torch.profiler import ProfilerActivity, profile

    batch = {m: np.random.default_rng(0).normal(size=(N_WINDOWS, WIN, c)).astype(np.float32)
             for m, c in CHANNELS.items()}
    engine.predict_windows(batch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            engine.predict_windows(batch)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    profile_table(prof, f"10 x predict_windows batch {N_WINDOWS}", wall_ms, card)

    step, state, ctx, tbatch, _ = make_step_setup(seed, dev, 1024)
    step(state, tbatch, None, ctx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            step(state, tbatch, None, ctx)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    profile_table(prof, "10 x CAGrad train step batch 1024", wall_ms, card)

    step, state, ctx, tbatch, _ = make_step_setup(seed, dev, 1024, "cheap_xattn")
    step(state, tbatch, None, ctx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            step(state, tbatch, None, ctx)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    profile_table(prof, "10 x cheap_xattn train step batch 1024", wall_ms, card)


def phase_sota_profiles(seed, dev, card) -> None:
    """Device time by kernel over 10 batch-1024 train steps of each SOTA
    baseline, at its dropout."""
    from torch.profiler import ProfilerActivity, profile

    for baseline in wg.SOTA_BASELINES:
        step, state, ctx, tbatch, gen = make_step_setup(seed, dev, 1024, baseline)
        step(state, tbatch, gen, ctx)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(10):
                step(state, tbatch, gen, ctx)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        profile_table(prof, f"10 x {baseline} train step batch 1024", wall_ms, card)


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
    sb_errors = check_stream_block(
        rng, dev, [n for n in STREAM_BLOCK_CASES if n not in FUSION_WIDTH_CASES])
    solver_err = check_solver(rng, dev)
    engine, serve_launches = phase_serving(args.seed, rng)
    training = phase_training(args.seed, dev)
    # the fusion slice draws from its own stream, so the phases above see the
    # inputs they always saw
    xrng = np.random.default_rng([args.seed, 3])
    check_stream_block(xrng, dev, FUSION_WIDTH_CASES)
    xattn_errors = check_cheap_xattn(xrng, dev, card, XATTN_CASES)
    # later slices' checks: each a stream of its own as well
    zrng = np.random.default_rng([args.seed, 6])
    check_zero_rows(zrng, dev)
    check_wide_xattn(zrng, dev, card)
    check_cheap_xattn(np.random.default_rng([args.seed, 7]), dev, card, XATTN_EDGE_CASES)
    print_xattn_configs(card)
    check_forward_edges(np.random.default_rng([args.seed, 8]), dev, card)
    check_solver_each_k(np.random.default_rng([args.seed, 9]), dev)
    fusion, single = phase_fusion_training(args.seed, dev)
    # the SOTA baselines' slice: a stream of its own as well
    frng = np.random.default_rng([args.seed, 10])
    focal_errors = check_focal_blocks(frng, dev, card)
    check_dropout_on_card(dev)
    sota = phase_sota_training(args.seed, dev)
    times = time_stream_block(rng, dev, card)
    times["cagrad_solver"] = time_solver(rng, dev, card)
    serving = time_serving(engine, rng, card)
    train_steps = time_train_step(args.seed, dev, card)
    times.update(time_cheap_xattn(xrng, dev, card))
    fusion_steps = time_train_step(args.seed, dev, card, "cheap_xattn")
    focal_times = time_focal_block(frng, dev, card)
    sota_steps = {b: time_train_step(args.seed, dev, card, b) for b in wg.SOTA_BASELINES}
    phase_profiles(engine, args.seed, dev, card)
    phase_sota_profiles(args.seed, dev, card)

    # launches on each kernel's own main path: the CAGrad training's for the
    # earlier slices' kernels, the cheap-xattn training's for this slice's
    launches = dict(training["sync"]["launches"])
    for name in ("cheap_xattn", "cheap_xattn_backward"):
        launches[name] = fusion["sync"]["launches"][name]
    # the wide variants on their own main path: FOCAL's training, the times
    # at FOCAL's shape
    for name in ("stream_block", "stream_block_backward"):
        launches[f"{name}_wide"] = sota["focal"]["sync"]["launches"][f"{name}_wide"]
        times[f"{name}_wide"] = focal_times[name]
    focal_err = focal_errors["focal_sync_batch1024_gelu"]
    entries = [
        ("stream_block", "gaitpd_torch/csrc/stream_block.cu", "gaitpd/ops/pallas_blocks.py:72",
         sb_errors["main"][0]),
        ("stream_block_wide", "gaitpd_torch/csrc/stream_block.cu",
         "gaitpd/ops/pallas_blocks.py:72", focal_err[0]),
        ("stream_block_backward_wide", "gaitpd_torch/csrc/stream_block.cu",
         "gaitpd/ops/pallas_blocks.py:160", focal_err[1]),
        ("stream_block_backward", "gaitpd_torch/csrc/stream_block.cu",
         "gaitpd/ops/pallas_blocks.py:160", sb_errors["main"][1]),
        # not a TPU kernel: the CAGrad solver that XLA compiles into the step
        ("cagrad_solver", "gaitpd_torch/csrc/cagrad_solver.cu", "gaitpd/learning/minnorm.py:58",
         solver_err),
        ("cheap_xattn", "gaitpd_torch/csrc/cheap_xattn.cu", "gaitpd/ops/pallas_blocks.py:184",
         xattn_errors["main"][0]),
        ("cheap_xattn_backward", "gaitpd_torch/csrc/cheap_xattn.cu",
         "gaitpd/ops/pallas_blocks.py:275", xattn_errors["main"][1]),
    ]
    kernels = []
    for name, source, replaces, err in entries:
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": err, **times[name]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s; serving launches {serve_launches}; "
        f"training {json.dumps(training)}; fusion training {json.dumps(fusion)}; single_mod "
        f"{json.dumps(single)}; serving {json.dumps(serving)}; train steps "
        f"{json.dumps(train_steps)}; cheap_xattn train steps {json.dumps(fusion_steps)}; "
        f"SOTA baselines' training {json.dumps(sota)} (FOCAL's stream-block launches in "
        f"'focal'); FOCAL's stream block (max abs err forward/backward) "
        f"{json.dumps(focal_errors)} and times {json.dumps(focal_times)}; SOTA train steps "
        f"{json.dumps(sota_steps)}")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
