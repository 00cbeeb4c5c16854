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
     two launches each way bitwise equal) at the training path's shape (six
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
     cheap cross-attention at d = 65, 96 and 200 and at d 96, Tq = Tk = 128
     (tiles in shared memory both ways), forward and backward, timed at d =
     96, Tq = Tk = 64 and 128, both ways (eager and from a CUDA graph)
     beside scaled_dot_product_attention and its autograd (a yardstick); then,
     from a stream of their own, the tiled kernels at d 128 and 256, Tq 65,
     Tq 1 against Tk 63, and over several key tiles (Tk 65, 128, 130),
     each launch printed;
  5c. this slice's checks, from a random stream of their own: the cheap
     cross-attention at each kernel variant's edges (Tk 64/65, Tq 64/65,
     masked scores, d = 12 against 8, 16, 36, 64, N odd and N above one round
     of the persistent grid), as in phase 5; the launch of every variant
     (threads, shared memory, blocks an SM, grid); then, from a stream of
     their own, the sweep over 128 keys at FoG's (2 x 256 and 2 x 1024
     window pairs, d 6), FBG's (2 x 32, d 3), the symmetric 2-mod (2 x 64,
     d 12) and --win_len 128's (Tq = Tk = 128, d 12) shapes and at its edges
     (d 8 and 9 at T 101, d 64 over 128 keys; 129 keys and 129 query rows
     on the two-pass kernels), each launch printed;
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
  5f. the other 15 MTL methods, from a random stream of their own: the
     MGDA, FairGrad (alpha 0.5, 1, 2) and NashMTL solver kernels against
     their plain versions at K = 1..8 on seeded and degenerate Gram
     matrices, in one launch and one matrix a launch (w bitwise equal,
     finite, MGDA's on the simplex, each launch counted); each method's
     host synchronisations in one train step, none more than CAGrad's
     (torch.cuda's sync debug mode); for the 12 methods that draw nothing,
     one train step card vs CPU as in phase 4 and run_cv card vs CPU (sync 2
     epochs, async 1 for FAMO and MGDA; phase 4's checks, 3 stream-block
     backward launches a step and one of the method's own solver, no other
     solver); RLW, PCGrad and GradDrop run_cv on the card alone (sync 1
     epoch: finite losses, the 7-subset table, the same launches) and their
     draws on the card by their laws (RLW's mean weight 1/K, PCGrad's 6
     orders, GradDrop's keep rate: each within 5 sigma);
  5g. the WearGait recipe (augmentation, modality dropout, checkpoints),
     from seeds of its own, at the flagship's widths on synthetic streams:
     the draws on the card by their laws (gaitpd_torch.tools.recipe_laws:
     the identity at zero strengths, the noise's std over 10^6 entries, the
     axis-mask gate's rate, one zeroed channel a gated sample and the
     channels uniform by chi-squared, modality dropout's keep rate
     (1 - p) + p^3 / 3 over 2 x 10^4 draws and never all three dropped);
     0 host synchronisations in one CAGrad step with aug_noise_std 0.05,
     aug_axis_p 0.2, modality_dropout 0.3; run_cv (sync, CAGrad, that
     recipe) for 3 epochs against the same run again and against 2 epochs
     with ckpt_dir resumed to 3 (phase 4's tolerances, and whether losses,
     parameters and the 7-subset table are bitwise equal; 3 stream-block
     backward and 1 solver launch a step); a resumed card run with the recipe off against the uninterrupted
     CPU run (phase 4's checks); WearGaitEngine.from_checkpoint on the card
     bitwise equal to an engine on the run's best module and within 1e-5 of
     the checkpoint served on the CPU (predict_windows, batch 1024);
  5h. the FBG/FoG driver (skeleton + sensor multitask training, CAGrad at
     K = 2), from a random stream of its own, on synthetic readers (the
     card's machine has no pandas): the stream block at the path's shapes
     (T 101 pooled to 8 overlapping bins, C_in 6 and 3, both streams of 256
     and of 1024 window pairs in one launch), forward and backward against
     their plain versions as in phase 2, the backward also with either
     stream's half of g zero (an async task pass), each launch printed; one
     train step card vs CPU as in phase 4 (FoG multimodal async; FoG sync
     with the consistency term); 0 host synchronisations in a FoG CAGrad
     step; one fold of the driver's main (n_folds_cap 1, verbose on the
     card: the reports print without sklearn) card vs CPU for FoG
     multimodal async 3 epochs, FoG sync with consistency 2, FBG multimodal
     async 1 and FoG sensor-only (CE) 1: per-epoch losses within 1e-4
     relative, parameters after epoch 1 within 1e-4 of the largest, the
     skeleton, sensor and average accuracies within one eval sample's
     share, and launches a multimodal step of 1 stream-block forward, 2
     backward and 1 solver (a single-modality step 1 and 1, no solver; an
     eval batch 1 forward); one FoG fold at the data's real scale (30
     subjects of 36 segments) on the card alone: finite losses, the same
     launches;
  5i. the FBG/FoG baseline drivers (the 2-mod fusions, DeepAV-Lite, FOCAL,
     TACA), from a random stream of their own: the cheap cross-attention
     (the sweep over 128 keys) at the fusion's shapes (2 x 256 and 2 x 1024 window
     pairs at d = 6, 2 x 32 at d = 3; T 101 both ways) and the generic
     stream block at the early (C_in 12), shared-latent (2 x 256, C_in 16)
     and FOCAL (2 x 256, C_in 32 -> C_out 4, t_out 4) shapes, forward and
     backward against their plain versions as in phase 5 and phase 2, each
     launch printed; one train step card vs CPU of each model on FoG async
     (the cheap-xattn and shared-latent fusions also sync; TACA at dropout
     0): parameters within 1e-6 and Adam's moments within 1e-4 of their
     largest; 0 host synchronisations in a cheap-xattn fusion step under
     Adam and a FOCAL step under AdamW with the clip; one fold of the
     drivers' main card vs CPU (the cheap-xattn fusion FoG async 3 epochs,
     FOCAL FoG async 2, DeepAV-Lite FBG async and FoG sync 1 each, early
     fusion FBG async 1): phase 5h's checks, and launches a cheap-xattn
     fusion step of 1 cross-attention forward and backward and 1 stream-block
     forward and backward, a FOCAL step 1 and 1, DeepAV-Lite none, an eval
     batch one forward of each kernel it uses; TACA at its dropout of 0.1
     and the cheap-xattn fusion at FoG's real scale on the card alone:
     finite losses, the same launches;
  5j. the kernel redesigns: the cheap-xattn fusion at enc_out_ch 96 (the
     cross-attention at d 96 on the tiled kernels both ways), one sync
     epoch card vs CPU as in phase 5, then one train step at win_len 128
     card vs CPU as in phase 4 (both tiled kernels over two key tiles, one
     launch each);
  6. timings: each kernel, its plain version and a PyTorch library call at
     the main path's shape (CUDA events around back-to-back eager calls;
     the stream block's forward, its plain version and its library call,
     and its backward and the library's, also as 200 calls replayed from a
     CUDA graph, the device's time without the host's)
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
     train step of each SOTA baseline at batch 64 and 1024; the MGDA,
     FairGrad and NashMTL solver kernels at K = 3, one matrix (eager and
     device time, plain version, bound) and one train step of every MTL
     method at batch 64 and 1024; one CAGrad train step with the recipe on
     at batch 64 and 1024, beside the plain one, with both steps' device
     time and kernel launches at batch 1024 (torch.profiler, in turns), and
     the host time to save one fold checkpoint; the FoG multimodal CAGrad
     train step at batch 256 and 1024 beside the WearGait one, its device
     time and kernel launches (profiler), and the stream block's forward
     and backward at FoG's shape (2 x 256 windows, C_in 6), eager and from a
     CUDA graph, beside the plain versions, the library calls and the
     bounds (the backward also in the async skeleton task's layout); device
     time
     by kernel of batch-1024 predict_windows and of 10 batch-1024 train
     steps of each (torch.profiler), the SOTA baselines' too; the
     cross-attention forward and backward at the FoG fusion's shape (2 x 256,
     T 101, d 6) and at Tq = Tk = 128, d 12, eager and from a CUDA graph,
     beside the two-pass kernels they replaced (by name, in turns), the
     plain versions, scaled_dot_product_attention and its autograd, and the
     bounds; the
     stream block at FOCAL's 2-mod shape beside conv1d + ReLU + pool; every
     T 101 forward shape of phases 5h and 5i (C_in 3, 6, 12, 16, 32) from a
     CUDA graph: per_frame, the generic variant it replaces, the library
     call and the plain version, in turns; the wide threshold's shapes also
     with per_frame; the FoG cheap-xattn fusion train step at batch 256 and
     1024 with its device time and launches.

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
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from gaitpd_torch.config import FBG_FOG_DIMS
from gaitpd_torch.data import synthetic as syn
from gaitpd_torch.data.sampler import batch_index_matrix
from gaitpd_torch.data.weargait import prepare_split
from gaitpd_torch.learning.mtl import (
    METHODS,
    _graddrop_mask,
    _rlw_weights,
    build_flat_partition,
    make_method,
)
from gaitpd_torch.models import baselines as BL
from gaitpd_torch.models.blocks import dropout
from gaitpd_torch.models.multitask import CHANNELS, MODALITIES, WearGaitThreeModal
from gaitpd_torch.ops import _build
from gaitpd_torch.ops import cagrad_solver as cs
from gaitpd_torch.ops import cheap_xattn as cx
from gaitpd_torch.ops import mtl_solvers as ms
from gaitpd_torch.ops import stream_block as sb
from gaitpd_torch.runtime.device import resolve_device
from gaitpd_torch.serve import StreamingSession, WearGaitEngine, poll_sessions
from gaitpd_torch.tools import recipe_laws
from gaitpd_torch.train import baseline_drivers as bd
from gaitpd_torch.train import fbg_fog_driver as ff
from gaitpd_torch.train import weargait_driver as wg
from gaitpd_torch.train.checkpoint import save_fold_checkpoint
from gaitpd_torch.train.cv import build_subj2label, make_fixed_balanced_folds_no_overlap
from gaitpd_torch.train.optim import adam_torch, adamw_torch, sgd_torch
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
    "min_norm_solver": (ms, "min_norm_launches"),
    "fairgrad_solver": (ms, "fairgrad_launches"),
    "nashmtl_solver": (ms, "nashmtl_launches"),
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
        same_f = torch.equal(got, cx.cheap_xattn(a, b))
        grads = cx.cheap_xattn_backward(a, b, g)
        again = cx.cheap_xattn_backward(a, b, g)
        torch.cuda.synchronize()
        if (cx.launches, cx.backward_launches) != (before[0] + 2, before[1] + 2):
            raise RuntimeError(f"cheap_xattn[{name}]: launch counts did not go up")
        want = cx.cheap_xattn_reference(a, b)
        atol, rtol = (KERNEL_TOL, 0.0) if tk <= 64 else (XATTN_LONG_ATOL, XATTN_LONG_RTOL)
        err = (got - want).abs().max().item()
        ok = bool(((got - want).abs() <= atol + rtol * want.abs()).all())
        want_g = cx.cheap_xattn_backward_reference(a, b, g)
        errs = [(gk - wk).abs().max().item() for gk, wk in zip(grads, want_g)]
        ok_g = all(bool(((gk - wk).abs() <= XATTN_GRAD_ATOL + XATTN_GRAD_RTOL * wk.abs()).all())
                   for gk, wk in zip(grads, want_g))
        same = same_f and all(torch.equal(x, y) for x, y in zip(grads, again))
        variants = "/".join(cx.VARIANT_NAMES[cx._variant(tq, tk, d, bw)] for bw in (False, True))
        log(f"[kernel] {card}: cheap_xattn {name} (N {n}, Tq {tq}, Tk {tk}, d {d}; variants "
            f"{variants}): forward max "
            f"abs err {err:.3e} (tol {atol:.0e} + {rtol:.0e} rel); backward dA/dB max abs err "
            f"{errs[0]:.3e}/{errs[1]:.3e} (tol {XATTN_GRAD_ATOL:.0e} + {XATTN_GRAD_RTOL:.0e} "
            f"rel); two launches of each bitwise equal: {same}")
        if not (np.isfinite(err) and ok):
            raise RuntimeError(f"cheap_xattn[{name}] disagrees with its plain version: {err}")
        if not (all(np.isfinite(errs)) and ok_g):
            raise RuntimeError(f"cheap_xattn backward[{name}] disagrees: {errs}")
        if not same:
            raise RuntimeError(f"cheap_xattn[{name}] is not deterministic")
        errors[name] = (err, max(errs))
    return errors


# d beyond the kernels' register rows (64): the tiles in shared memory, both
# ways, at every length. Checked against the plain version forward and
# backward; the first and last shapes timed (the fusion's train batch at
# win_len 64 and 128)
WIDE_XATTN_CASES = {"d96_train_batch64": (6 * 64, 64, 64, 96), "d65": (2 * 7, 33, 47, 65),
                    "d200": (6, 64, 130, 200), "d96_win128_batch64": (6 * 64, 128, 128, 96)}
WIDE_XATTN_TIMED = ("d96_train_batch64", "d96_win128_batch64")
# the tiled kernels' widths, units and key tiles, from a stream of their
# own: d 128 (one forward chunk of 128 columns) and 256 (two) at the fusion's
# train batch, two 64-row units (Tq 65), one query row against a masked key
# (Tk 63); then a second key tile (Tk 65), a part-filled third (Tk 130) at
# Tq 65, one query row against two key tiles, two query tiles against a
# second key tile of one key, at d 96, 200, 256 and 65
TILED_XATTN_CASES = {"d128_train_batch64": (6 * 64, 64, 64, 128),
                     "d256_train_batch64": (6 * 64, 64, 64, 256),
                     "d96_tq65": (2 * 7, 65, 64, 96), "d96_tq1_tk63": (5, 1, 63, 96),
                     "d96_tk65": (2 * 7, 64, 65, 96), "d200_tq65_tk130": (6, 65, 130, 200),
                     "d256_tq1_tk128": (5, 1, 128, 256), "d65_tq128_tk65": (2 * 7, 128, 65, 65)}


def check_wide_xattn(rng, dev, card, cases) -> dict:
    """Each case's forward, dA and dB max abs errors against the plain
    version, within their tolerances, two launches of each the same bits."""
    errors = {}
    for name, (n, tq, tk, d) in cases.items():
        a, b, g = xattn_inputs(rng, n, tq, tk, d, dev)
        got = cx.cheap_xattn(a, b)
        same_f = torch.equal(got, cx.cheap_xattn(a, b))
        grads = cx.cheap_xattn_backward(a, b, g)
        again = cx.cheap_xattn_backward(a, b, g)
        want = cx.cheap_xattn_reference(a, b)
        atol, rtol = (KERNEL_TOL, 0.0) if tk <= 64 else (XATTN_LONG_ATOL, XATTN_LONG_RTOL)
        ok = bool(((got - want).abs() <= atol + rtol * want.abs()).all())
        want_g = cx.cheap_xattn_backward_reference(a, b, g)
        ok_g = all(bool(((gk - wk).abs() <= XATTN_GRAD_ATOL + XATTN_GRAD_RTOL * wk.abs()).all())
                   for gk, wk in zip(grads, want_g))
        same = same_f and all(torch.equal(x, y) for x, y in zip(grads, again))
        errs = [(got - want).abs().max().item()] + [
            (gk - wk).abs().max().item() for gk, wk in zip(grads, want_g)]
        launch = {bw: xattn_launch(n, tq, tk, d, bw) for bw in (False, True)}
        log(f"[kernel] {card}: cheap_xattn {name} (N {n}, Tq {tq}, Tk {tk}, d {d}, variants "
            f"{launch[False]['variant']}/{launch[True]['variant']}): forward/dA/dB max abs err "
            f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (forward tol {atol:.0e} + {rtol:.0e} "
            f"rel); two launches of each bitwise equal: {same}")
        log(f"[config] {card}: cheap_xattn {name}: forward {launch[False]}; backward "
            f"{launch[True]}")
        if not (ok and ok_g and same and all(np.isfinite(errs))):
            raise RuntimeError(f"cheap_xattn[{name}] at d > 64 disagrees: {errs}, {same}")
        errors[name] = (errs[0], max(errs[1:]))
    return errors


def time_wide_xattn(rng, dev, card) -> dict:
    """The cross-attention at d 96 (the fusion's train batch at win_len 64
    and 128), both ways: the tiled kernels, eager and from a CUDA graph,
    beside the plain versions and scaled_dot_product_attention (and its
    autograd)."""
    out = {}
    for name in WIDE_XATTN_TIMED:
        n, tq, tk, d = WIDE_XATTN_CASES[name]
        a, b, g = xattn_inputs(rng, n, tq, tk, d, dev)
        leaves = [t.detach().clone().requires_grad_() for t in (a, b)]

        def library():  # a yardstick: the port never calls it
            return F.scaled_dot_product_attention(a, b, b)

        def library_backward():
            o = F.scaled_dot_product_attention(leaves[0], leaves[1], leaves[1])
            return torch.autograd.grad(o, leaves, g)

        want = cx.cheap_xattn_reference(a, b)
        want_g = cx.cheap_xattn_backward_reference(a, b, g)
        lib_errs = [(library() - want).abs().max().item()] + [
            (p - q).abs().max().item() for p, q in zip(library_backward(), want_g)]
        if not max(lib_errs) <= 1e-4:
            raise RuntimeError(f"library yardstick at {name} computes another function: "
                               f"{lib_errs}")
        with torch.inference_mode():
            fwd = {"kernel": time_cuda(lambda: cx.cheap_xattn(a, b), warmup=3, reps=20),
                   "plain": time_cuda(lambda: cx.cheap_xattn_reference(a, b), warmup=3, reps=20),
                   "library": time_cuda(library, warmup=3, reps=20),
                   "graph": time_cuda_graph(lambda: cx.cheap_xattn(a, b)),
                   "library_graph": time_cuda_graph(library),
                   "plain_graph": time_cuda_graph(lambda: cx.cheap_xattn_reference(a, b)),
                   "graph_2": time_cuda_graph(lambda: cx.cheap_xattn(a, b)),
                   "kernel_2": time_cuda(lambda: cx.cheap_xattn(a, b), warmup=3, reps=20)}
        bwd = {"kernel": time_cuda(lambda: cx.cheap_xattn_backward(a, b, g), warmup=3, reps=20),
               "plain": time_cuda(lambda: cx.cheap_xattn_backward_reference(a, b, g), warmup=3,
                                  reps=20),
               "library": time_cuda(library_backward, warmup=3, reps=20),
               "graph": time_cuda_graph(lambda: cx.cheap_xattn_backward(a, b, g)),
               "library_graph": time_cuda_graph(library_backward, warmup=3, reps=20),
               "graph_2": time_cuda_graph(lambda: cx.cheap_xattn_backward(a, b, g)),
               "kernel_2": time_cuda(lambda: cx.cheap_xattn_backward(a, b, g), warmup=3,
                                     reps=20)}
        bound = {"forward": cheap_xattn_bound(n, tq, tk, d),
                 "backward": cheap_xattn_backward_bound(n, tq, tk, d)}
        launch = {bw: xattn_launch(n, tq, tk, d, bw) for bw in (False, True)}
        for way, t, (bound_ms, bound_by), lib in (
                ("cheap_xattn", fwd, bound["forward"], "scaled_dot_product_attention"),
                ("cheap_xattn_backward", bwd, bound["backward"],
                 "autograd of scaled_dot_product_attention, forward included")):
            bw = way.endswith("backward")
            log(f"[time] {card}: {way} {name} (N {n}, Tq {tq}, Tk {tk}, d {d}), variant "
                f"{launch[bw]['variant']}: eager kernel {t['kernel']:.4f}/{t['kernel_2']:.4f} "
                f"ms, plain {t['plain']:.4f} ms, library ({lib}) {t['library']:.4f} ms; from a "
                f"CUDA graph (device only): kernel {t['graph']:.4f}/{t['graph_2']:.4f} ms, "
                f"library {t['library_graph']:.4f} ms"
                + (f", plain {t['plain_graph']:.4f} ms" if not bw else "")
                + f"; bound {bound_ms:.5f} ms ({bound_by}); launch {launch[bw]}")
        log(f"[time] {card}: cheap_xattn {name}: library max abs diffs forward/dA/dB "
            f"{lib_errs[0]:.2e}/{lib_errs[1]:.2e}/{lib_errs[2]:.2e}")
        out[name] = {"forward": fwd, "backward": bwd, "bound": bound, "launch": launch}
    return out


# each kernel variant's edges: the sweep kernels at Tk = 64 against 65 (the
# sweep over 128 keys), Tq = 64 against 65 (its backward; the forward's second
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
# the sweep over 128 keys at the shapes that reach it, from a stream of their
# own: FoG's cheap-xattn fusion at the driver's batch and at 1024, FBG's at
# its batch of 32, the symmetric 2-mod shape (WearGait's d 12) and
# --win_len 128 at d 12; then its edges: its width 8 at d 8 against 16 at
# d 9, d 64 over 128 keys, and the two-pass kernels beyond it (129 keys;
# 129 query rows, whose forward is the sweep's)
SWEEP128_XATTN_CASES = {
    "fog_batch256": (2 * 256, 101, 101, 6), "fog_batch1024": (2 * 1024, 101, 101, 6),
    "fbg_batch32": (2 * 32, 101, 101, 3), "sym_t101": (2 * 64, 101, 101, 12),
    "t128_d12": (2 * 64, 128, 128, 12), "d8_t101": (5, 101, 101, 8), "d9_t101": (5, 101, 101, 9),
    "d64_tq65_tk128": (5, 65, 128, 64), "tk129": (5, 128, 129, 12),
    "tq129_tk64": (5, 129, 64, 12),
}
# one shape a variant for the launch table: the main shape (sweep_d12), then
# the main shape's N at d = 36 (sweep), at Tk = 65 (sweep_128), at d = 96,
# FoG's fusion (sweep_128 at W 8) and 129 keys (two_pass)
CONFIG_SHAPES = {"main": (6 * N_WINDOWS, 64, 64, 12), "d36": (6 * N_WINDOWS, 64, 64, 36),
                 "tk65": (6 * N_WINDOWS, 64, 65, 12), "d96": (6 * N_WINDOWS, 64, 64, 96),
                 "fog_batch256": (2 * 256, 101, 101, 6), "tk129": (2 * 64, 128, 129, 12)}


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


def check_sweep128_xattn(rng, dev, card) -> dict:
    """SWEEP128_XATTN_CASES as in phase 5, each launch printed."""
    errors = check_cheap_xattn(rng, dev, card, SWEEP128_XATTN_CASES)
    for name, (n, tq, tk, d) in SWEEP128_XATTN_CASES.items():
        log(f"[config] {card}: cheap_xattn {name} (N {n}, Tq {tq}, Tk {tk}, d {d}): forward "
            f"{xattn_launch(n, tq, tk, d, False)}; backward {xattn_launch(n, tq, tk, d, True)}")
    return errors


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


def check_one_step(seed, dev, baseline=None, mtl_method="cagrad") -> None:
    """One train step at batch 64 on the card and on the CPU, from equal
    parameters and an equal batch: ``mtl_method`` (CAGrad by default) for
    the flagship, the mean of the branch losses for a baseline (DeepAV-Lite
    and TACA at dropout 0, since the card's masks cannot match the CPU's)."""
    label = baseline or ("CAGrad" if mtl_method == "cagrad" else mtl_method)
    compare_one_step(f"{label} step at batch 64", dev, lambda device: make_step_setup(
        seed, device, 64, baseline, no_dropout=True, mtl_method=mtl_method))


# an optimizer's per-parameter state held card vs CPU after one step, by name
MOMENT_NAMES = {"momentum_buffer": "momentum", "exp_avg": "Adam's first moment",
                "exp_avg_sq": "Adam's second moment"}


# Adam's first-step allowance covers only entries whose gradient is rounding
# noise around 0 on both sides, and only a handful of them
ADAM_NOISE_GRAD = 1e-7  # 10 eps
ADAM_MAX_ALLOWED = 8


def adam_first_step_allowance(card_state, cpu_state, p_card, p_cpu):
    """What one entry of a parameter may differ between the card and the
    CPU after Adam's first step, beyond rounding, because the gradients do,
    and where the gradients are both within ADAM_NOISE_GRAD of 0 (0
    elsewhere): the first update is lr * g / (|g| + eps), whose slope
    lr * eps / (|g| + eps)^2 turns a gradient gap at |g| near eps into up to
    lr times its relative size. Bounded by the slope at the smaller |g| (at
    0 where the signs differ) times the gap; the gradients are the first
    moments over 1 - beta1. Returns the allowance and the larger |g| of
    each entry."""
    group = cpu_state.optimizer.param_groups[0]
    lr, eps, beta1 = group["lr"], group["eps"], group["betas"][0]
    g_card = card_state.optimizer.state[p_card]["exp_avg"].detach().cpu() / (1.0 - beta1)
    g_cpu = cpu_state.optimizer.state[p_cpu]["exp_avg"].detach() / (1.0 - beta1)
    g_max = torch.maximum(g_card.abs(), g_cpu.abs())
    g_min = torch.where(g_card * g_cpu > 0, torch.minimum(g_card.abs(), g_cpu.abs()),
                        torch.zeros_like(g_cpu))
    allowance = lr * (g_card - g_cpu).abs() * eps / (g_min + eps) ** 2
    return torch.where(g_max <= ADAM_NOISE_GRAD, allowance, torch.zeros_like(allowance)), g_max


def compare_one_step(label, dev, make, moments=("momentum_buffer",)) -> None:
    """One train step of ``make(device)``'s (step, state, ctx, batch,
    generator) on the card and on the CPU: parameters within STEP_PARAM_TOL
    and the optimizer's ``moments`` (SGD's momentum, or Adam's two moments)
    within STEP_MOMENTUM_TOL of their largest value. Under Adam each
    parameter entry may differ by ``adam_first_step_allowance`` beyond
    STEP_PARAM_TOL, at most ADAM_MAX_ALLOWED entries in all; Adam's
    moments are held to STEP_MOMENTUM_TOL of their own largest value, with
    no floor, since they lie far below 1."""
    runs = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        step, state, ctx, batch, gen = make(device)
        state, metrics = step(state, batch, gen, ctx)
        runs[name] = (state, metrics)
    card_state, cpu_state = runs["card"][0], runs["cpu"][0]
    pairs = list(zip(card_state.module.parameters(), cpu_state.module.parameters()))
    adam = "exp_avg" in moments
    gaps, beyond, allowed, allowed_g = {}, 0.0, 0, 0.0
    for what, pick in [("parameters", lambda s, p: p)] + [
            (MOMENT_NAMES[m], lambda s, p, m=m: s.optimizer.state[p][m]) for m in moments]:
        want = [pick(cpu_state, q).detach() for _, q in pairs]
        got = [pick(card_state, p).detach().cpu() for p, _ in pairs]
        largest = max(w.abs().max().item() for w in want)
        scale = largest if adam and what != "parameters" else max(1.0, largest)
        tol = (STEP_PARAM_TOL if what == "parameters" else STEP_MOMENTUM_TOL) * scale
        diffs = [(g - w).abs() for g, w in zip(got, want)]
        gaps[what] = (max(d.max().item() for d in diffs), tol)
        if what == "parameters" and adam:
            for d, (p, q) in zip(diffs, pairs):
                allowance, g_max = adam_first_step_allowance(card_state, cpu_state, p, q)
                beyond = max(beyond, (d - tol - allowance).max().item())
                used = (d > tol) & (d <= tol + allowance)
                allowed += int(used.sum())
                if used.any():
                    allowed_g = max(allowed_g, g_max[used].max().item())
    loss_gap = (runs["card"][1]["losses"].cpu() - runs["cpu"][1]["losses"]).abs().max().item()
    log(f"[train] one {label}, card vs CPU: " + ", ".join(
        f"{what} max abs gap {gap:.3e} (tol {tol:.2e})" for what, (gap, tol) in gaps.items())
        + (f" ({allowed} parameter entries within Adam's first-step allowance beyond it, "
           f"their gradients at most {allowed_g:.3e} on either side, "
           f"none beyond that: {beyond <= 0})" if adam else "")
        + f", losses {loss_gap:.3e}")
    failed = [what for what, (gap, tol) in gaps.items()
              if gap > tol and not (adam and what == "parameters")]
    if failed or beyond > 0 or allowed > ADAM_MAX_ALLOWED:
        raise RuntimeError(f"one {label}: card and CPU differ: {gaps}")


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


# the encoders' width at which the cheap-xattn fusion's cross-attention runs
# at d 96 (gaitpd/cli.py's --enc_out_ch; 12 by default)
WIDE_FUSION_CH = 96


# a window of 128 frames (gaitpd/cli.py's --win_len; 64 by default): the
# cross-attention at Tq = Tk = 128, two key tiles of the tiled kernels
LONG_WINDOW = 128


def phase_wide_fusion_training(seed, dev) -> dict:
    """The cheap-xattn fusion at enc_out_ch 96: the cross-attention at d 96,
    on the tiled variants both ways, the backbone at C_in 96 on the wide
    one; one sync epoch card vs CPU as in phase 5, one cross-attention and
    one stream-block backward launch a train step. Then one train step at
    win_len 128 card vs CPU, where both tiled kernels take two key tiles
    inside the model: one launch each."""
    out = compare_run_cv(
        f"cheap_xattn enc_out_ch {WIDE_FUSION_CH}",
        dict(train_common(seed), baseline="cheap_xattn", enc_out_ch=WIDE_FUSION_CH),
        (("sync", 1),),
        {"cheap_xattn_backward": 1, "stream_block_backward": 1, "cagrad_solver": 0},
        ("stream_block", "cheap_xattn"))
    widths = dict(enc_out_ch=WIDE_FUSION_CH, win_len=LONG_WINDOW)
    reset_launches()
    compare_one_step(f"cheap_xattn step at batch 64, enc_out_ch {WIDE_FUSION_CH}, win_len "
                     f"{LONG_WINDOW}", dev, lambda device: make_step_setup(
                         seed, device, 64, "cheap_xattn", no_dropout=True, **widths))
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[train] cheap_xattn step at win_len {LONG_WINDOW}: launches {launches}")
    if (launches["cheap_xattn"], launches["cheap_xattn_backward"]) != (1, 1):
        raise RuntimeError(f"win_len {LONG_WINDOW} step: cross-attention launches {launches}")
    out["win_len_128_step"] = {"launches": launches}
    return out


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


def card_only_run_cv(label, common, modes, per_step=None) -> dict:
    """run_cv on the card alone, for what draws random numbers the CPU
    cannot draw alike (a baseline's dropout: phase 5e's one-step check holds
    the card against the CPU at dropout 0; an MTL method's draws: phase 5f
    holds them by their statistics): finite losses, the 7-subset table, and
    with ``per_step`` the launches each train step must make of a kernel,
    else no launch of any kernel."""
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
        if per_step is None and any(launches.values()):
            raise RuntimeError(f"train {tag}: launched a kernel it has no use for: {launches}")
        wrong = {k: (launches[k], n * rec.steps) for k, n in (per_step or {}).items()
                 if launches[k] != n * rec.steps}
        if wrong:
            raise RuntimeError(f"train {tag}: launches (got, want) {wrong}")
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
# 5f. the other MTL methods: MGDA's, FairGrad's and NashMTL's solver kernels
# ---------------------------------------------------------------------------

# the methods whose weights involve no random draw, and the drawing ones
DRAWLESS_METHODS = ("stl", "ls", "uw", "scaleinvls", "dwa", "famo", "mgda", "log_mgda",
                    "imtl", "log_imtl", "nashmtl", "fairgrad")
DRAWING_METHODS = ("rlw", "pcgrad", "graddrop")
# the solver kernel each method launches once a train step
METHOD_SOLVER = {"mgda": "min_norm_solver", "log_mgda": "min_norm_solver",
                 "fairgrad": "fairgrad_solver", "nashmtl": "nashmtl_solver",
                 "cagrad": "cagrad_solver", "log_cagrad": "cagrad_solver"}
MTL_SOLVER_NAMES = ("min_norm_solver", "fairgrad_solver", "nashmtl_solver")
FAIRGRAD_ALPHAS = (0.5, 1.0, 2.0)  # FairGrad's default 1.0 and tests/test_mtl.py's others
DRAW_SIGMAS = 5.0


def mtl_solver_grams(rng, n, k):
    """n seeded PSD Gram matrices over four decades of scale, then the
    degenerate ones: zero, rank one (tasks of one sign: with opposed tasks
    FairGrad's G w = w^(-1/alpha) has no solution, and gaitpd's solver
    gives NaN too), all tasks equal, two tasks equal, one zero task."""
    a = rng.normal(size=(n, k, 6)) * 10.0 ** rng.uniform(-2, 2, size=(n, 1, 1))
    grams = a @ a.transpose(0, 2, 1) + 1e-4 * np.eye(k)
    v = np.abs(rng.normal(size=k)) + 0.1
    zero_task = grams[0].copy()
    zero_task[0, :] = zero_task[:, 0] = 0.0
    degenerate = [np.zeros((k, k)), np.outer(v, v), np.full((k, k), 2.0), zero_task]
    if k > 1:
        b = rng.normal(size=(k, 6))
        b[1] = b[0]
        degenerate.append(b @ b.T)
    return np.concatenate([grams, np.stack(degenerate)]).astype(np.float32)


def nash_normalised(grams: torch.Tensor) -> torch.Tensor:
    """The Gram matrices as NashMTL's combine hands them to its solver."""
    return grams / torch.linalg.matrix_norm(grams).clamp(min=1e-8)[..., None, None]


def mtl_solver_calls():
    """(label, kernel call, plain call, counter, input map, weights on the
    simplex) for each solver, FairGrad at each alpha."""
    calls = [("min_norm_solver", ms.min_norm_solve, ms.min_norm_solve_reference,
              "min_norm_solver", lambda g: g, True)]
    for alpha in FAIRGRAD_ALPHAS:
        calls.append((f"fairgrad_solver alpha={alpha}",
                      lambda g, a=alpha: ms.fairgrad_solve(g, a),
                      lambda g, a=alpha: ms.fairgrad_solve_reference(g, a),
                      "fairgrad_solver", lambda g: g, False))
    calls.append(("nashmtl_solver", ms.nashmtl_solve, ms.nashmtl_solve_reference,
                  "nashmtl_solver", nash_normalised, False))
    return calls


def check_mtl_solvers(rng, dev) -> dict:
    """Each solver kernel against its plain version at K = 1..8 on seeded
    and degenerate Gram matrices, in one launch and one matrix a launch:
    w bitwise equal (FairGrad's too: kernel and plain version call the
    same device powf); every w finite, MGDA's on the simplex; the launch
    counter up by one a launch. Returns each solver's max abs error at
    K = 3 (FairGrad's at its default alpha 1)."""
    errors = {}
    for k in range(1, ms.MAX_TASKS + 1):
        raw = torch.from_numpy(mtl_solver_grams(rng, 12, k)).to(dev)
        for label, run, plain, counter, prep, simplex in mtl_solver_calls():
            grams = prep(raw)
            before = read_launches()[counter]
            got = run(grams)
            alone = [run(g) for g in grams]
            torch.cuda.synchronize()
            launched = read_launches()[counter] - before
            want = plain(grams)
            same = int((got.view(torch.int32) == want.view(torch.int32)).all(-1).sum())
            same_alone = sum(bool(torch.equal(a.view(torch.int32), w.view(torch.int32)))
                             for a, w in zip(alone, want))
            err = (got - want).abs().max().item()
            finite = bool(torch.isfinite(got).all() and torch.isfinite(want).all())
            on_simplex = (not simplex) or bool(
                (got >= 0).all() and (got.sum(-1) - 1).abs().max().item() <= 1e-5)
            n = len(grams)
            log(f"[kernel] {label} K={k}, {n} Gram matrices ({n - 12} degenerate): bitwise "
                f"equal {same}/{n} in one launch, {same_alone}/{n} one matrix a launch; max abs "
                f"err {err:.3e}; finite {finite}" + (f"; on the simplex {on_simplex}"
                                                     if simplex else "")
                + f"; launches {launched}")
            if launched != 1 + n:
                raise RuntimeError(f"{label} K={k}: {launched} launches counted, want {1 + n}")
            if not (finite and on_simplex):
                raise RuntimeError(f"{label} K={k}: w not finite or off the simplex")
            if same != n or same_alone != n:
                raise RuntimeError(f"{label} K={k}: w not bitwise equal to the plain version's "
                                   f"(max abs err {err:.3e})")
            if k == 3 and (counter not in errors or "alpha=1.0" in label):
                errors[counter] = err
    return errors


def step_syncs(seed, dev, mtl_method, recipe=False) -> int:
    """Synchronisations of the host with the card in one train step at
    batch 64 (after a warm-up step), as torch.cuda's sync debug mode
    reports them."""
    return count_syncs(*make_step_setup(seed, dev, 64, mtl_method=mtl_method, recipe=recipe))


def count_syncs(step, state, ctx, batch, gen) -> int:
    """Synchronisations of the host with the card in one call of ``step``
    after a warm-up call, as torch.cuda's sync debug mode reports them."""
    step(state, batch, gen, ctx)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(state, batch, gen, ctx)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def check_step_syncs(seed, dev) -> dict:
    """No method's train step synchronises more often than CAGrad's. The
    first count of a process reads one synchronisation more than the same
    step counted again, so a first count is made and dropped."""
    first = step_syncs(seed, dev, "cagrad")
    counts = {m: step_syncs(seed, dev, m) for m in sorted(METHODS)}
    log(f"[train] host synchronisations in one train step at batch 64, by method: {counts} "
        f"(the first count of the process, dropped: CAGrad {first})")
    worse = {m: n for m, n in counts.items() if n > counts["cagrad"]}
    if worse:
        raise RuntimeError(f"train steps that synchronise more than CAGrad's "
                           f"({counts['cagrad']}): {worse}")
    return counts


def check_draws_on_card(dev) -> None:
    """The drawing methods' draws from a generator on the card, by their
    laws, each within 5 sigma: RLW's mean weight 1/K, PCGrad's K! orders
    alike, GradDrop's keep rate of a column against its sign purity p."""
    k = 3
    gen = torch.Generator(device=dev).manual_seed(11)
    ones = torch.ones(k, device=dev)
    rlw = make_method("rlw", k)
    n = 4000
    w = torch.stack([_rlw_weights(rlw.draw(ones, gen)) for _ in range(n)]).double()
    sigma = (w.std(0) / np.sqrt(n)).cpu().numpy()
    gap = (w.mean(0) - 1.0 / k).abs().cpu().numpy()
    log(f"[kernel] RLW on the card: {n} draws, mean weights {w.mean(0).cpu().numpy()}, "
        f"gap from 1/K in sigmas {np.round(gap / sigma, 2).tolist()}")
    if np.any(gap > DRAW_SIGMAS * sigma):
        raise RuntimeError("RLW's draws on the card do not keep their law")

    pc = make_method("pcgrad", k)
    n = 3000
    perms = torch.stack([pc.draw(ones, gen) for _ in range(n)]).cpu().numpy()
    counts = {p: int((perms == np.array(p)).all(-1).sum())
              for p in itertools.permutations(range(k))}
    p = 1.0 / len(counts)
    sigma = np.sqrt(n * p * (1 - p))
    log(f"[kernel] PCGrad on the card: {n} draws, counts of the {len(counts)} orders "
        f"{list(counts.values())} (expected {n * p:.0f} each, sigma {sigma:.1f})")
    if sum(counts.values()) != n or any(abs(c - n * p) > DRAW_SIGMAS * sigma
                                        for c in counts.values()):
        raise RuntimeError("PCGrad's draws on the card do not keep their law")

    cols = 1_000_000
    j = torch.tensor([1.0, 0.5, -0.3], device=dev)[:, None].expand(k, cols).contiguous()
    gd = make_method("graddrop", k)
    mask = _graddrop_mask(j, gd.draw(j, gen))
    purity = 0.5 * (1.0 + 1.2 / 1.8)
    for row, rate in ((0, purity), (2, 1.0 - purity)):
        kept = int(mask[row].sum())
        sigma = np.sqrt(cols * rate * (1 - rate))
        log(f"[kernel] GradDrop on the card: row {row} of {cols} columns of purity "
            f"{purity:.4f}: kept {kept} ({(kept - cols * rate) / sigma:+.2f} sigma)")
        if abs(kept - cols * rate) > DRAW_SIGMAS * sigma:
            raise RuntimeError("GradDrop's draws on the card do not keep their law")


def solver_per_step(method) -> dict:
    """The solver launches a train step of ``method`` must make: one of its
    own solver, none of the others."""
    own = METHOD_SOLVER.get(method)
    return {name: int(name == own) for name in ("cagrad_solver",) + MTL_SOLVER_NAMES}


def phase_mtl_methods(seed, dev, rng) -> dict:
    """This slice's main path: the 12 drawless methods one step card vs CPU
    and run_cv card vs CPU (sync 2 epochs; async 1 for FAMO and MGDA), 3
    stream-block backward launches and one launch of the method's own solver
    a step; the 3 drawing methods' run_cv on the card alone (sync 1 epoch)
    and their draws' laws; each method's host synchronisations a step."""
    solver_errors = check_mtl_solvers(rng, dev)
    syncs = check_step_syncs(seed, dev)
    runs = {}
    for method in DRAWLESS_METHODS:
        check_one_step(seed, dev, mtl_method=method)
        modes = (("sync", 2), ("async", 1)) if method in ("famo", "mgda") else (("sync", 2),)
        per_step = {"stream_block_backward": 3, "stream_block_wide": 0,
                    "stream_block_backward_wide": 0, **solver_per_step(method)}
        own = METHOD_SOLVER.get(method)
        runs[method] = compare_run_cv(method, dict(train_common(seed), mtl_method=method),
                                      modes, per_step, ("stream_block",) + ((own,) if own else ()))
    for method in DRAWING_METHODS:
        per_step = {"stream_block_backward": 3, **solver_per_step(method)}
        runs[method] = card_only_run_cv(method, dict(train_common(seed), mtl_method=method),
                                        (("sync", 1),), per_step=per_step)
    check_draws_on_card(dev)
    return {"solver_errors": solver_errors, "syncs": syncs, "runs": runs}


# ---------------------------------------------------------------------------
# 5g. the WearGait recipe: augmentation, modality dropout, checkpoints
# ---------------------------------------------------------------------------

RECIPE = dict(aug_noise_std=0.05, aug_axis_p=0.2, modality_dropout=0.3)
RESUME_EPOCHS = 3  # the interrupted run stops one epoch before, then resumes


class StateRecorder(EpochRecorder):
    """EpochRecorder that also keeps each epoch's module state and eval
    ensemble accuracy, over one run or an interrupted run and its resume."""

    def __init__(self):
        super().__init__()
        self.states, self.ens = [], []

    def __call__(self, fold, epoch, state, tr, ev):
        super().__call__(fold, epoch, state, tr, ev)
        self.states.append({k: v.detach().clone() for k, v in state.module.state_dict().items()})
        self.ens.append(ev.ens_acc)

    def best_state(self) -> dict:
        """The state of the sync run's best epoch: the ensemble accuracy
        improves strictly, as the driver's early stopper reads it."""
        best, out = 0.0, None
        for ens, st in zip(self.ens, self.states):
            if ens > best:
                best, out = ens, st
        return out


def recipe_run(common, epochs, ckpt_dir=None) -> tuple:
    """run_cv for ``epochs``, or with ``ckpt_dir`` for ``epochs`` - 1 and
    then resumed to ``epochs``; every launch count set to 0 just before and
    read just after. Returns (the last run's result, one recorder over both
    runs, launches, seconds)."""
    rec = StateRecorder()
    reset_launches()
    t0 = time.perf_counter()
    if ckpt_dir is not None:
        wg.run_cv(wg.WearGaitArgs(epochs=epochs - 1, ckpt_dir=ckpt_dir, **common), on_epoch=rec)
        res = wg.run_cv(wg.WearGaitArgs(epochs=epochs, ckpt_dir=ckpt_dir, resume=True, **common),
                        on_epoch=rec)
    else:
        res = wg.run_cv(wg.WearGaitArgs(epochs=epochs, **common), on_epoch=rec)
    torch.cuda.synchronize()
    return res, rec, read_launches(), time.perf_counter() - t0


def check_recipe_launches(tag, launches, steps) -> None:
    """The CAGrad flagship's launches: 3 stream-block backward and 1 solver
    a train step, no wide variant."""
    want = {"stream_block_backward": 3 * steps, "cagrad_solver": steps, "stream_block_wide": 0,
            "stream_block_backward_wide": 0}
    wrong = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    log(f"[recipe] {tag}: {steps} train steps, launches {launches}")
    if steps == 0 or wrong or launches["stream_block"] == 0:
        raise RuntimeError(f"recipe {tag}: launches (got, want) {wrong} for {steps} steps")


def compare_runs(tag, got, want, share, params_epoch) -> dict:
    """Two runs, each (result, StateRecorder): per-epoch train losses within
    1e-4 relative, the module state after epoch ``params_epoch`` (1-based)
    within 1e-4 of its largest entry, the 7-subset table within one eval
    window's share; and whether each is bitwise equal."""
    (got_res, got_rec), (want_res, want_rec) = got, want
    if len(got_rec.train_loss) != len(want_rec.train_loss):
        raise RuntimeError(f"recipe {tag}: {len(got_rec.train_loss)} epochs vs "
                           f"{len(want_rec.train_loss)}")
    loss_gap = max(float((np.abs(a - b) / np.abs(b)).max())
                   for a, b in zip(got_rec.train_loss, want_rec.train_loss))
    a_state = {k: v.cpu() for k, v in got_rec.states[params_epoch - 1].items()}
    b_state = {k: v.cpu() for k, v in want_rec.states[params_epoch - 1].items()}
    scale = max(1.0, max(v.abs().max().item() for v in b_state.values()))
    p_gap = max((a_state[k] - v).abs().max().item() for k, v in b_state.items())
    mask_gap = max(abs(got_res["masks"][mk] - want_res["masks"][mk]) for mk in wg.MASK_COMBOS)
    bitwise = {
        "losses": all(np.array_equal(a, b) for a, b in zip(got_rec.train_loss,
                                                            want_rec.train_loss)),
        "params": all(torch.equal(a_state[k], v) for k, v in b_state.items()),
        "masks": got_res["masks"] == want_res["masks"],
    }
    log(f"[recipe] {tag}: per-epoch train losses max rel gap {loss_gap:.3e} (tol "
        f"{TRAIN_LOSS_RTOL}), state after epoch {params_epoch} max abs gap {p_gap:.3e} (tol "
        f"{TRAIN_PARAM_TOL * scale:.2e}), 7-subset table max gap {mask_gap:.4f} points (one "
        f"eval window {share:.4f}); bitwise equal {bitwise}")
    if (not all(np.all(np.isfinite(a)) for a in got_rec.train_loss) or loss_gap > TRAIN_LOSS_RTOL
            or p_gap > TRAIN_PARAM_TOL * scale or mask_gap > share + 1e-4):
        raise RuntimeError(f"recipe {tag}: the runs differ beyond phase 4's tolerances")
    return {"bitwise": bitwise, "loss_gap": loss_gap, "param_gap": p_gap, "mask_gap": mask_gap}


def check_from_checkpoint(ckpt_dir, rec, seed) -> dict:
    """WearGaitEngine.from_checkpoint on the card against an engine on the
    run's best module (bitwise) and the same checkpoint on the CPU (within
    serving's 1e-5), predict_windows at batch 1024."""
    module = WearGaitThreeModal(synchronized=True)
    module.load_state_dict(rec.best_state())
    rng = np.random.default_rng([seed, 12])
    windows = {m: rng.normal(size=(N_WINDOWS, WIN, c)).astype(np.float32)
               for m, c in CHANNELS.items()}
    engine = WearGaitEngine.from_checkpoint(ckpt_dir, fold=1)
    if engine.device.type != "cuda":
        raise RuntimeError("from_checkpoint's default engine is not on the card")
    got = engine.predict_windows(windows)
    want = WearGaitEngine(module).predict_windows(windows)
    cpu = WearGaitEngine.from_checkpoint(ckpt_dir, fold=1, device="cpu").predict_windows(windows)
    bitwise = bool(np.array_equal(got, want))
    gap = float(np.abs(got - cpu).max())
    log(f"[recipe] from_checkpoint on the card, predict_windows batch {N_WINDOWS}: bitwise "
        f"equal to the best module's engine: {bitwise}; max abs gap to the CPU {gap:.3e} "
        f"(tol {SERVE_TOL})")
    if not bitwise or not np.all(np.isfinite(got)) or gap > SERVE_TOL:
        raise RuntimeError("from_checkpoint's engine differs from the best module's or the CPU's")
    return {"bitwise": bitwise, "cpu_gap": gap}


def phase_recipe(seed, dev) -> dict:
    """The recipe on the card: the draws' laws; 0 host synchronisations in a
    CAGrad step with the recipe on; run_cv with the recipe uninterrupted
    against itself run again and against interrupted and resumed; a resumed card run against the
    uninterrupted CPU run with the augmentation off; from_checkpoint."""
    laws = {**recipe_laws.check_augment_laws(dev, seed, noise_std=RECIPE["aug_noise_std"],
                                             axis_p=RECIPE["aug_axis_p"]),
            **recipe_laws.check_modality_dropout_law(dev, seed, p=RECIPE["modality_dropout"])}
    log(f"[recipe] draws on the card hold their laws (sigmas, chi-squared): "
        f"{ {k: round(v, 3) for k, v in laws.items()} }")
    syncs = {"plain": step_syncs(seed, dev, "cagrad"),
             "recipe": step_syncs(seed, dev, "cagrad", recipe=True)}
    log(f"[recipe] host synchronisations in one CAGrad train step at batch 64: {syncs}")
    if syncs["recipe"] != 0:
        raise RuntimeError(f"the recipe's train step synchronises the host: {syncs}")
    common = dict(train_common(seed), **RECIPE)
    share = mask_share(wg.WearGaitArgs(**common))
    out = {"laws": laws, "syncs": syncs}
    with tempfile.TemporaryDirectory() as tmp:
        full = recipe_run(common, RESUME_EPOCHS)
        check_recipe_launches("uninterrupted", full[2], full[1].steps)
        # the same run again: whether the card's run is bitwise repeatable
        # at all says whether a resume can be
        again = recipe_run(common, RESUME_EPOCHS)
        out["repeat"] = compare_runs("card uninterrupted, run twice", again[:2], full[:2],
                                     share, RESUME_EPOCHS)
        resumed = recipe_run(common, RESUME_EPOCHS, ckpt_dir=f"{tmp}/recipe")
        check_recipe_launches("interrupted and resumed", resumed[2], resumed[1].steps)
        out["resume"] = compare_runs("card resumed vs card uninterrupted", resumed[:2], full[:2],
                                     share, RESUME_EPOCHS)
        out["from_checkpoint"] = check_from_checkpoint(f"{tmp}/recipe", resumed[1], seed)
        plain = train_common(seed)
        card = recipe_run(plain, RESUME_EPOCHS, ckpt_dir=f"{tmp}/plain")
        check_recipe_launches("plain, interrupted and resumed", card[2], card[1].steps)
        cpu = recipe_run(dict(plain, device="cpu"), RESUME_EPOCHS)
        out["card_vs_cpu"] = compare_runs("plain card resumed vs CPU uninterrupted", card[:2],
                                          cpu[:2], mask_share(wg.WearGaitArgs(**plain)), 1)
    out["seconds"] = {"uninterrupted": full[3], "resumed": resumed[3], "plain_card": card[3],
                      "plain_cpu": cpu[3]}
    return out


# ---------------------------------------------------------------------------
# 5h. the FBG/FoG driver: skeleton + sensor multitask training at K = 2
# ---------------------------------------------------------------------------

FF_BATCH = 256  # FBG_FOG_TRAIN's batch: window pairs a train step
# (B, T, C_in, K, C_out, t_out, act) of the FBG/FoG backbone: both streams'
# windows in one launch, T 101 pooled to 8 overlapping bins, C_in 6 (FoG) and
# 3 (FBG), at the driver's batch and at 1024
FF_BLOCK_CASES = {
    "fog_batch256": (2 * FF_BATCH, 101, 6, 3, 16, 8, "relu"),
    "fbg_batch256": (2 * FF_BATCH, 101, 3, 3, 16, 8, "relu"),
    "fog_batch1024": (2 * 1024, 101, 6, 3, 16, 8, "relu"),
    "fbg_batch1024": (2 * 1024, 101, 3, 3, 16, 8, "relu"),
}
FF_SHAPE = FF_BLOCK_CASES["fog_batch256"]
# the compared runs' synthetic readers: 2 train steps of 256 an epoch
FF_READERS = {"fog": dict(n_subjects=12, segments=36),
              "fbg": dict(n_subjects=12, walks=30, trials=30)}
# real FoG recordings are cut into 36 equal segments (FoGReader)
FF_REAL_SCALE = dict(n_subjects=30, segments=36)


def check_ff_blocks(rng, dev) -> dict:
    """The stream block at the FBG/FoG path's shapes, forward and backward
    against their plain versions as in phase 2, the backward also in the
    async task passes' layouts (the other stream's half of g zero: its gx
    exactly 0); each launch printed. Returns (forward, backward) errors."""
    errors = {}
    for name, (bsz, t, cin, k, cout, t_out, act) in FF_BLOCK_CASES.items():
        x, w, b, g = stream_block_inputs(rng, bsz, t, cin, k, cout, dev, t_out)
        fwd = hold_forward(f"fbg_fog {name}", x, w, b, t_out, act)
        bwd = hold_backward(f"fbg_fog {name}", x, w, b, g, t_out, act)[0]
        half = bsz // 2
        for task, zero in (("skeleton task", slice(half, bsz)), ("sensor task", slice(0, half))):
            g_task = g.clone()
            g_task[zero] = 0.0
            err, grads = hold_backward(
                f"fbg_fog {name} {task} (rows {zero.start}..{zero.stop - 1} of g zero)",
                x, w, b, g_task, t_out, act)
            if grads[0][zero].abs().max().item() != 0.0:
                raise RuntimeError(f"stream_block backward fbg_fog {name} {task}: gx of a "
                                   "zero-cotangent window is not 0")
            bwd = max(bwd, err)
        log(f"[config] fbg_fog {name}: forward {sb.forward_config(bsz, t, cin, cout, k, t_out, act)}"
            f"; backward {sb.backward_config(bsz, t, cin, cout, k, t_out, act)}")
        errors[name] = (fwd, bwd)
    return errors


def ff_step_setup(seed, dev, bsz, dataset="fog", modality="multimodal", sync=False,
                  wm="gcl", consistency_lambda=1.0):
    """The FBG/FoG driver's model (choose_model, weights from ``seed``), its
    SGD and, multimodal, its CAGrad step at K = 2 (c 0.1, max_norm 1,
    private grads "sum"), one card-resident batch of ``bsz`` window pairs
    (skeleton in [0, 1) as the min-max poses, sensor N(0, 1)), and the
    step's generator."""
    args = ff.FbgFogArgs(dataset=dataset, modality=modality, synchronized_loading=sync,
                         seed=seed, wm=wm, consistency_lambda=consistency_lambda,
                         use_norm_and_cos=wm == "gcl")
    dims = FBG_FOG_DIMS[dataset]
    multimodal = modality == "multimodal"
    model = ff.choose_model(args, dims).to(dev)
    settings = StepSettings(n_streams=2 if multimodal else 1, wm=wm, synchronized=sync,
                            consistency_lambda=consistency_lambda if multimodal else 0.0,
                            private_grads="sum")
    if multimodal:
        mtl = make_method("cagrad", 2, c=args.alpha, max_norm=args.max_norm)
        step = make_train_step(settings, mtl, build_flat_partition(
            model, model.shared_modules, model.task_modules))
        mtl_state = mtl.init_state(dev)
    else:
        step, mtl_state = make_train_step(settings), {}
    state = TrainState(module=model, optimizer=sgd_torch(model.parameters(), 1e-3, 0.9, 1e-4),
                       mtl_state=mtl_state)
    ctx = make_loss_ctx(settings, [[300, 200, 120]] * settings.n_streams, device=dev)
    g = torch.Generator().manual_seed(seed)  # on the host: the same batch on any device
    xs = {"skeleton": torch.rand((bsz, dims.pose_length, dims.skeleton_input_dim), generator=g),
          "sensor": torch.randn((bsz, dims.sensor_length, dims.sensor_in_channels), generator=g)}
    streams = ("skeleton", "sensor") if multimodal else (modality,)
    ys = torch.randint(0, dims.num_classes, (bsz,), generator=g)
    batch = {"xs": tuple(xs[s].to(dev) for s in streams),
             "ys": tuple(ys.to(dev) for _ in streams),
             "valid": torch.ones(bsz, device=dev), "n_valid": bsz}
    return step, state, ctx, batch, torch.Generator(device=dev).manual_seed(seed)


class FoldRecorder(EpochRecorder):
    """on_epoch hook of the FBG/FoG driver (0-based epochs): per-epoch
    losses, non-empty train steps, the parameters after the first epoch and
    the eval samples' count."""

    def __init__(self):
        super().__init__()
        self.n_eval = 0

    def __call__(self, fold, epoch, state, tr, ev):
        super().__call__(fold, epoch + 1, state, tr, ev)
        self.n_eval = len(ev.trues[0])


def ff_launches_wanted(kw, steps, eval_forwards) -> dict:
    """A multimodal train step launches 1 stream-block forward, 2 backward
    (one a task pass) and 1 solver; a single-modality step 1 forward and 1
    backward; an eval batch 1 forward. No other kernel."""
    multimodal = kw["modality"] == "multimodal"
    want = {name: 0 for name in COUNTERS}
    want.update(stream_block=steps + eval_forwards,
                stream_block_backward=(2 if multimodal else 1) * steps,
                cagrad_solver=steps if multimodal else 0)
    return want


def ff_run(kw, epochs, reader, device, seed):
    """The driver's main (n_folds_cap 1) on ``reader``; every launch count
    set to 0 just before and read just after. Returns (summary of the mode,
    recorder, launches, seconds)."""
    args = ff.FbgFogArgs(epochs=epochs, n_folds_cap=1, seed=seed, device=device,
                         verbose=device is None, **kw)
    rec = FoldRecorder()
    reset_launches()
    t0 = time.perf_counter()
    summary = ff.main(args, on_epoch=rec, reader=reader)
    if device is None:
        torch.cuda.synchronize()
    return summary[kw["modality"]], rec, read_launches(), time.perf_counter() - t0


def check_ff_launches(tag, kw, rec, launches, epochs, wanted=ff_launches_wanted,
                      batch=FF_BATCH) -> int:
    """The launches of ``wanted(kw, train steps, eval forwards)``, an eval
    forward a batch of ``batch`` (the padded tail's too), or raise."""
    n_eval_batches = batch_index_matrix(np.arange(rec.n_eval), batch)[0].shape[0]
    want = wanted(kw, rec.steps, epochs * n_eval_batches)
    log(f"[fbg_fog] {tag}: {rec.steps} train steps and {epochs * n_eval_batches} eval "
        f"forwards; launches {launches}")
    wrong = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    if rec.steps == 0 or wrong:
        raise RuntimeError(f"fbg_fog {tag}: launches (got, want) {wrong} for {rec.steps} steps")
    return rec.steps


def compare_ff_fold(label, kw, epochs, seed, run=ff_run, wanted=ff_launches_wanted,
                    batch=FF_BATCH) -> dict:
    """One fold of ``run`` (the FBG/FoG driver's by default) on the card and
    on the CPU from one seed and one reader (FF_READERS): per-epoch train
    losses within 1e-4 relative, parameters after epoch 1 within 1e-4 of the
    largest, the skeleton, sensor and average accuracies within one eval
    sample's share; the card's launches as ``wanted`` counts them."""
    dataset = kw.get("dataset", "fog")
    make = syn.make_fbg_reader if dataset == "fbg" else syn.make_fog_reader
    reader = make(seed=seed, **FF_READERS[dataset])
    card, card_rec, launches, card_s = run(kw, epochs, reader, None, seed)
    cpu, cpu_rec, _, cpu_s = run(kw, epochs, reader, "cpu", seed)
    tag = f"{label}, {epochs} epoch(s)"
    steps = check_ff_launches(tag, kw, card_rec, launches, epochs, wanted, batch)
    if steps != cpu_rec.steps:
        raise RuntimeError(f"fbg_fog {tag}: {steps} card steps vs {cpu_rec.steps} on the CPU")
    gaps = []
    for ep, (a, b) in enumerate(zip(card_rec.train_loss, cpu_rec.train_loss), 1):
        gap = float((np.abs(a - b) / np.abs(b)).max())
        gaps.append(gap)
        log(f"[fbg_fog] {tag} epoch {ep}: train losses card {np.round(a, 6).tolist()} CPU "
            f"{np.round(b, 6).tolist()}, max rel gap {gap:.3e} (tol {TRAIN_LOSS_RTOL})")
        if not np.all(np.isfinite(a)) or gap > TRAIN_LOSS_RTOL:
            raise RuntimeError(f"fbg_fog {tag} epoch {ep}: card losses differ from the CPU's")
    scale = max(1.0, max(p.abs().max().item() for p in cpu_rec.first_epoch_params.values()))
    p_gap = max((card_rec.first_epoch_params[n] - p).abs().max().item()
                for n, p in cpu_rec.first_epoch_params.items())
    share = 100.0 / card_rec.n_eval
    acc_gap = max(abs(card[k] - cpu[k]) for k in ("skel", "sensor", "avg"))
    log(f"[fbg_fog] {tag}: card {card_s:.2f} s, CPU {cpu_s:.2f} s; parameters after epoch 1 "
        f"max abs gap {p_gap:.3e} (tol {TRAIN_PARAM_TOL * scale:.2e}); accuracies card "
        f"{ {k: round(float(v), 4) for k, v in card.items()} }, CPU "
        f"{ {k: round(float(v), 4) for k, v in cpu.items()} } (one eval sample {share:.4f} "
        f"points)")
    if p_gap > TRAIN_PARAM_TOL * scale or acc_gap > share + 1e-4:
        raise RuntimeError(f"fbg_fog {tag}: card and CPU differ beyond phase 4's tolerances")
    return {"launches": launches, "steps": steps, "loss_gap": max(gaps), "param_gap": p_gap,
            "acc_gap": acc_gap, "seconds": {"card": card_s, "cpu": cpu_s}}


FF_RUNS = {
    "fog multimodal async (CAGrad, GCL)": (dict(dataset="fog", modality="multimodal",
                                                use_norm_and_cos=True), 3),
    "fog multimodal sync (consistency 1.0)": (dict(dataset="fog", modality="multimodal",
                                                   synchronized_loading=True,
                                                   consistency_lambda=1.0), 2),
    "fbg multimodal async": (dict(dataset="fbg", modality="multimodal"), 1),
    "fog sensor-only (CE)": (dict(dataset="fog", modality="sensor", wm="ce"), 1),
}


def phase_fbg_fog(seed, dev, rng) -> dict:
    """The FBG/FoG driver: the stream block at its shapes; one train step
    card vs CPU (FoG multimodal async, and sync with the consistency term);
    0 host synchronisations in a multimodal CAGrad step; one fold card vs
    CPU for each of FF_RUNS; one FoG fold at the data's real scale on the
    card alone."""
    t0 = time.perf_counter()
    errors = check_ff_blocks(rng, dev)
    compare_one_step("FoG multimodal async CAGrad step at batch 256", dev,
                     lambda device: ff_step_setup(seed, device, FF_BATCH))
    compare_one_step("FoG multimodal sync CAGrad step with consistency 1.0 at batch 256", dev,
                     lambda device: ff_step_setup(seed, device, FF_BATCH, sync=True))
    # the first count of a process reads one more than the same step counted
    # again (check_step_syncs): made and dropped
    first = count_syncs(*ff_step_setup(seed, dev, FF_BATCH))
    syncs = count_syncs(*ff_step_setup(seed, dev, FF_BATCH))
    log(f"[fbg_fog] host synchronisations in one FoG multimodal CAGrad train step at batch "
        f"{FF_BATCH}: {syncs} (a first count, dropped: {first})")
    if syncs != 0:
        raise RuntimeError(f"the FoG CAGrad train step synchronises the host {syncs} times")
    runs = {label: compare_ff_fold(label, kw, epochs, seed)
            for label, (kw, epochs) in FF_RUNS.items()}
    kw = dict(dataset="fog", modality="multimodal", use_norm_and_cos=True)
    reader = syn.make_fog_reader(seed=seed, **FF_REAL_SCALE)
    _, rec, launches, secs = ff_run(kw, 1, reader, None, seed)
    tag = f"real scale ({len(reader.pose_dict)} FoG segment pairs), card only, 1 epoch"
    check_ff_launches(tag, kw, rec, launches, 1)
    losses = np.concatenate(rec.train_loss + rec.eval_loss)
    log(f"[fbg_fog] {tag}: {secs:.2f} s; train losses {rec.train_loss[0].tolist()}, eval "
        f"losses {rec.eval_loss[0].tolist()}")
    if not np.all(np.isfinite(losses)):
        raise RuntimeError(f"fbg_fog {tag}: non-finite losses")
    runs["real scale"] = {"launches": launches, "steps": rec.steps, "seconds": secs}
    log(f"[fbg_fog] phase 5h: {time.perf_counter() - t0:.1f} s")
    return {"errors": errors, "syncs": syncs, "runs": runs}


# ---------------------------------------------------------------------------
# 5i. the FBG/FoG baseline drivers: the 2-mod fusions, DeepAV-Lite, FOCAL, TACA
# ---------------------------------------------------------------------------

# (N, Tq, Tk, d) of the cheap-xattn fusion's two directions at T 101 (the
# sweep over 128 keys): FoG's d = 6 at the driver's batch and at 1024, FBG's
# d = 3 at its batch of 32
BB_XATTN_CASES = {"fog_batch256": (2 * FF_BATCH, 101, 101, 6),
                  "fog_batch1024": (2 * 1024, 101, 101, 6),
                  "fbg_batch32": (2 * 32, 101, 101, 3)}
# (B, T, C_in, K, C_out, t_out, act) of the drivers' backbones on FoG: early
# fusion's 6 + 6 channels, the shared latent's two streams of 16, FOCAL's two
# async streams of 16 + 8 + 8 channels pooled to 4 bins of 4 channels
BB_BLOCK_CASES = {"early_fog_batch256": (FF_BATCH, 101, 12, 3, 16, 8, "relu"),
                  "share_latent_fog_batch256": (2 * FF_BATCH, 101, 16, 3, 16, 8, "relu"),
                  "focal_fog_batch256": (2 * FF_BATCH, 101, 32, 3, 4, 4, "relu")}
BB_XATTN_SHAPE = BB_XATTN_CASES["fog_batch256"]
BB_FOCAL_SHAPE = BB_BLOCK_CASES["focal_fog_batch256"]
# every T 101 forward shape of phases 5h and 5i, timed against the library
T101_FORWARD_SHAPES = {"fbg_batch256": FF_BLOCK_CASES["fbg_batch256"], "fog_batch256": FF_SHAPE,
                       **BB_BLOCK_CASES}
# the one-step comparisons: each kind on FoG async, and the two fusions
# whose sync mode differs (one joint head; the shared latent's two)
BB_STEPS = [("fusion", dict(fusion_type=t)) for t in ("early", "late", "share_latent",
                                                      "cheap_xattn")]
BB_STEPS += [("deepav", {}), ("focal", {}), ("taca", {})]
BB_STEPS += [("fusion", dict(fusion_type=t, synced=True)) for t in ("cheap_xattn",
                                                                     "share_latent")]
# the folds card vs CPU (FBG has no synchronized mode: its pose and GRF keys
# share no segment, so the fold builder raises for it; DeepAV-Lite's CLS
# pooling runs on FoG sync)
BB_RUNS = {
    "fusion cheap_xattn fog async": (dict(kind="fusion", fusion_type="cheap_xattn"), 3),
    "focal fog async": (dict(kind="focal"), 2),
    "deepav fbg async": (dict(kind="deepav", dataset="fbg"), 1),
    "deepav fog sync": (dict(kind="deepav", synced=True), 1),
    "fusion early fbg async": (dict(kind="fusion", fusion_type="early", dataset="fbg"), 1),
}


def check_bb_kernels(rng, dev, card) -> dict:
    """The cheap cross-attention (the sweep over 128 keys) and the stream block at
    the drivers' shapes against their plain versions as in phase 5 and
    phase 2, with each launch's variant and configuration."""
    errors = {"xattn": check_cheap_xattn(rng, dev, card, BB_XATTN_CASES)}
    for name, (n, tq, tk, d) in BB_XATTN_CASES.items():
        for backward in (False, True):
            log(f"[config] {card}: cheap_xattn{'_backward' if backward else ''} baselines "
                f"{name} (N {n}, Tq {tq}, Tk {tk}, d {d}): {xattn_launch(n, tq, tk, d, backward)}")
    for name, (bsz, t, cin, k, cout, t_out, act) in BB_BLOCK_CASES.items():
        x, w, b, g = stream_block_inputs(rng, bsz, t, cin, k, cout, dev, t_out)
        errors[name] = (hold_forward(f"baselines {name}", x, w, b, t_out, act),
                        hold_backward(f"baselines {name}", x, w, b, g, t_out, act)[0])
        log(f"[config] {card}: stream_block baselines {name}: forward "
            f"{sb.forward_config(bsz, t, cin, cout, k, t_out, act)}; backward "
            f"{sb.backward_config(bsz, t, cin, cout, k, t_out, act)}")
    return errors


def bb_step_setup(seed, dev, bsz, kind, **kw):
    """A baseline driver's model (weights from ``seed``; TACA at dropout 0),
    its optimizer (Adam for a fusion, AdamW with the clip otherwise), its
    train step on the mean or sum of its CE losses, one card-resident batch
    of ``bsz`` FoG window pairs (skeleton in [0, 1), sensor N(0, 1), of the
    driver's sensor length) and the step's generator."""
    args = bd.BaselineArgs(kind=kind, seed=seed, device=dev, **kw)
    dims = FBG_FOG_DIMS["fog"]
    hp = bd._hp(args, "fog")
    model = bd._build_model(args, dims, hp, args.synced)
    if kind == "taca":
        BL.without_dropout(model)
    model = model.to(dev)
    two_heads = not args.synced or args.fusion_type == "share_latent" and kind == "fusion"
    n_heads = 2 if two_heads else 1
    settings = StepSettings(n_streams=n_heads, wm="ce", synchronized=args.synced,
                            loss_reduction="mean" if kind == "fusion" else "sum")
    if kind == "fusion":
        optimizer = adam_torch(model.parameters(), hp["lr"])
    else:
        optimizer = adamw_torch(model.parameters(), hp["lr"], weight_decay=1e-4, grad_clip=1.0)
    step = make_train_step(settings, train_apply=bd._adapters(args, hp)[0])
    state = TrainState(module=model, optimizer=optimizer, mtl_state={})
    ctx = make_loss_ctx(settings, [[300, 200, 120]] * n_heads, device=dev)
    g = torch.Generator().manual_seed(seed)  # on the host: the same batch on any device
    xs = (torch.rand((bsz, dims.pose_length, dims.skeleton_input_dim), generator=g),
          torch.randn((bsz, hp["sensor_length"], dims.sensor_in_channels), generator=g))
    ys = torch.randint(0, dims.num_classes, (bsz,), generator=g)
    batch = {"xs": tuple(x.to(dev) for x in xs), "ys": tuple(ys.to(dev) for _ in range(n_heads)),
             "valid": torch.ones(bsz, device=dev), "n_valid": bsz}
    return step, state, ctx, batch, torch.Generator(device=dev).manual_seed(seed)


def bb_label(kind, kw) -> str:
    name = {"deepav": "DeepAV-Lite", "focal": "FOCAL", "taca": "TACA"}.get(kind)
    name = name or f"{kw['fusion_type']} fusion"
    return f"{name} FoG {'sync' if kw.get('synced') else 'async'}"


def bb_launches_wanted(kw, steps, eval_forwards) -> dict:
    """A fusion or FOCAL train step launches 1 stream-block forward and 1
    backward, the cheap-xattn fusion also 1 cross-attention forward and 1
    backward; an eval batch one forward of each kernel its model uses;
    DeepAV-Lite and TACA launch nothing."""
    want = {name: 0 for name in COUNTERS}
    if kw["kind"] in ("fusion", "focal"):
        want.update(stream_block=steps + eval_forwards, stream_block_backward=steps)
    if kw["kind"] == "fusion" and kw.get("fusion_type", "cheap_xattn") == "cheap_xattn":
        want.update(cheap_xattn=steps + eval_forwards, cheap_xattn_backward=steps)
    return want


def bb_run(kw, epochs, reader, device, seed):
    """The baseline driver's main (n_folds_cap 1) on ``reader``; every
    launch count set to 0 just before and read just after. Returns (summary,
    recorder, launches, seconds)."""
    args = bd.BaselineArgs(seed=seed, device=device, epochs=epochs, n_folds_cap=1,
                           verbose=device is None, **kw)
    rec = FoldRecorder()
    reset_launches()
    t0 = time.perf_counter()
    summary = bd.main(args, on_epoch=rec, reader=reader)
    if device is None:
        torch.cuda.synchronize()
    return summary, rec, read_launches(), time.perf_counter() - t0


def bb_batch(kw) -> int:
    return bd._hp(bd.BaselineArgs(**kw), kw.get("dataset", "fog"))["batch"]


def phase_baselines(seed, dev, card, rng) -> dict:
    """The FBG/FoG baseline drivers: the kernels at their shapes; one train
    step card vs CPU of each model (BB_STEPS); 0 host synchronisations in a
    cheap-xattn fusion step under Adam and a FOCAL step under AdamW with
    the clip; one fold card vs CPU of each of BB_RUNS; TACA at its dropout
    and the cheap-xattn fusion at FoG's real scale on the card alone."""
    t0 = time.perf_counter()
    errors = check_bb_kernels(rng, dev, card)
    for kind, kw in BB_STEPS:
        compare_one_step(f"{bb_label(kind, kw)} step at batch {FF_BATCH}", dev,
                         lambda device, kind=kind, kw=kw: bb_step_setup(seed, device, FF_BATCH,
                                                                        kind, **kw),
                         moments=("exp_avg", "exp_avg_sq"))
    counted = (("cheap_xattn fusion, Adam", "fusion", dict(fusion_type="cheap_xattn")),
               ("FOCAL, AdamW with the clip", "focal", {}))
    # a process's first count reads one more than the same step counted
    # again (check_step_syncs): made and dropped
    first = count_syncs(*bb_step_setup(seed, dev, FF_BATCH, "fusion", fusion_type="cheap_xattn"))
    syncs = {label: count_syncs(*bb_step_setup(seed, dev, FF_BATCH, kind, **kw))
             for label, kind, kw in counted}
    log(f"[baselines] host synchronisations in one FoG train step at batch {FF_BATCH}: {syncs} "
        f"(a first count, dropped: {first})")
    if any(syncs.values()):
        raise RuntimeError(f"a baseline's train step synchronises the host: {syncs}")
    runs = {label: compare_ff_fold(f"baselines {label}", kw, epochs, seed, bb_run,
                                   bb_launches_wanted, bb_batch(kw))
            for label, (kw, epochs) in BB_RUNS.items()}
    # TACA at its dropout of 0.1, and the cheap-xattn fusion at FoG's real
    # segment count: on the card alone
    for label, kw, reader in (
            ("taca fog async, dropout 0.1", dict(kind="taca"),
             syn.make_fog_reader(seed=seed, **FF_READERS["fog"])),
            ("fusion cheap_xattn fog async, real scale", dict(kind="fusion"),
             syn.make_fog_reader(seed=seed, **FF_REAL_SCALE))):
        _, rec, launches, secs = bb_run(kw, 1, reader, None, seed)
        tag = f"{label} ({len(reader.pose_dict)} FoG segment pairs), card only, 1 epoch"
        check_ff_launches(f"baselines {tag}", kw, rec, launches, 1, bb_launches_wanted,
                          bb_batch(kw))
        losses = np.concatenate(rec.train_loss + rec.eval_loss)
        log(f"[baselines] {tag}: {secs:.2f} s; train losses {rec.train_loss[0].tolist()}, "
            f"eval losses {rec.eval_loss[0].tolist()}")
        if not np.all(np.isfinite(losses)):
            raise RuntimeError(f"baselines {tag}: non-finite losses")
        runs[label] = {"launches": launches, "steps": rec.steps, "seconds": secs}
    seconds = time.perf_counter() - t0
    log(f"[baselines] phase 5i: {seconds:.1f} s")
    return {"errors": errors, "syncs": syncs, "runs": runs, "seconds": seconds}


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


def time_stream_block(rng, dev, card, shape=MAIN_SHAPE, task_zero=slice(N_WINDOWS, None),
                      task="CAGrad task layout") -> dict:
    """The stream block's forward and backward at ``shape``: eager and from
    a CUDA graph, beside the plain version, the library call and the bound;
    the backward also with the rows ``task_zero`` of g zero (a task pass's
    layout: at the main shape only the walkway stream's third is live)."""
    bsz, t, cin, k, cout, t_out, _ = shape
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
        # the same calls without the host
        graph_ms = time_cuda_graph(lambda: sb.stream_block(x, w, b, t_out))
        library_graph_ms = time_cuda_graph(library)
        plain_graph_ms = time_cuda_graph(lambda: sb.stream_block_reference(x, w, b, t_out))
        graph_ms_2 = time_cuda_graph(lambda: sb.stream_block(x, w, b, t_out))
    bound_ms, bound_by = stream_block_bound(bsz, t, cin, k, cout, t_out)
    launch = sb.forward_config(bsz, t, cin, cout, k, t_out)
    log(f"[time] {card}: stream_block x({bsz},{t},{cin}) k{k} -> ({bsz},{t_out},{cout}), "
        f"variant {launch['variant']}: back-to-back eager calls (host included): kernel "
        f"{kernel_ms:.4f}/{kernel_ms_2:.4f} ms, plain {plain_ms:.4f}/{plain_ms_2:.4f} ms, "
        f"library conv1d+relu+adaptive_avg_pool1d {library_ms:.4f} ms; 200 calls replayed "
        f"from a CUDA graph (device only): kernel {graph_ms:.4f}/{graph_ms_2:.4f} ms, library "
        f"{library_graph_ms:.4f} ms, plain {plain_graph_ms:.4f} ms; bound {bound_ms:.5f} ms "
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
    bwd_graph = time_cuda_graph(lambda: sb.stream_block_backward(x, w, b, g, t_out))
    bwd_library_graph = time_cuda_graph(library_backward, warmup=5, reps=50)
    bwd_bound, bwd_by = stream_block_backward_bound(bsz, t, cin, k, cout, t_out)
    config = sb.backward_config(bsz, t, cin, cout, k, t_out)
    log(f"[time] {card}: stream_block_backward at x({bsz},{t},{cin}) k{k}, all windows live: "
        f"kernel {bwd_kernel:.4f}/{bwd_kernel_2:.4f} ms, plain (autograd of the plain forward) "
        f"{bwd_plain:.4f}/{bwd_plain_2:.4f} ms, library (autograd of conv1d+relu+"
        f"adaptive_avg_pool1d, forward included) {bwd_library:.4f} ms; from a CUDA graph "
        f"(device only): kernel {bwd_graph:.4f} ms, library {bwd_library_graph:.4f} ms; bound "
        f"{bwd_bound:.5f} ms ({bwd_by}); launch {config} (on "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs)")

    # a task pass: only the task's own stream carries cotangents
    g_task = g.clone()
    g_task[task_zero] = 0.0
    live = bsz - len(range(bsz)[task_zero])
    task_kernel = time_cuda(lambda: sb.stream_block_backward(x, w, b, g_task, t_out))
    task_plain = time_cuda(lambda: sb.stream_block_backward_reference(x, w, b, g_task, t_out),
                           warmup=5, reps=50)
    task_kernel_2 = time_cuda(lambda: sb.stream_block_backward(x, w, b, g_task, t_out))
    task_bound, task_by = stream_block_backward_bound(bsz, t, cin, k, cout, t_out, live=live)
    log(f"[time] {card}: stream_block_backward at x({bsz},{t},{cin}) k{k}, {task} "
        f"(rows {range(bsz)[task_zero].start}..{range(bsz)[task_zero].stop - 1} of g zero): "
        f"kernel {task_kernel:.4f}/{task_kernel_2:.4f} ms, plain {task_plain:.4f} ms, bound "
        f"{task_bound:.5f} ms ({task_by}: operations on the {live} live rows, bytes on all)")
    return {
        "stream_block": {"ms": min(kernel_ms, kernel_ms_2), "plain_ms": min(plain_ms, plain_ms_2),
                         "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                         "variant": launch["variant"], "launch": launch,
                         "graph_ms": min(graph_ms, graph_ms_2),
                         "library_graph_ms": library_graph_ms, "plain_graph_ms": plain_graph_ms},
        "stream_block_backward": {"ms": min(bwd_kernel, bwd_kernel_2),
                                  "plain_ms": min(bwd_plain, bwd_plain_2),
                                  "library_ms": bwd_library, "bound_ms": bwd_bound,
                                  "bound_by": bwd_by, "graph_ms": bwd_graph,
                                  "library_graph_ms": bwd_library_graph,
                                  "cagrad_layout_ms": min(task_kernel, task_kernel_2),
                                  "cagrad_layout_plain_ms": task_plain,
                                  "cagrad_layout_bound_ms": task_bound,
                                  "cagrad_layout_bound_by": task_by},
    }


def time_t101_forwards(rng, dev, card) -> dict:
    """The stream block's forward at every T 101 shape of phases 5h and 5i
    (C_in 3, 6, 12, 16, and 32 -> 4 channels in 4 bins), each from a CUDA
    graph: the kernel the wrapper takes (per_frame), the generic variant
    that took these sizes before, the library call and the plain version,
    in turns, beside the bound."""
    out = {}
    for name, shape in T101_FORWARD_SHAPES.items():
        bsz, t, cin, k, cout, t_out, act = shape
        x, w, b, _ = stream_block_inputs(rng, bsz, t, cin, k, cout, dev, t_out)
        w_torch = w.permute(2, 1, 0).contiguous()

        def library():
            y = torch.relu(F.conv1d(x.transpose(1, 2), w_torch, b, padding=k // 2))
            return F.adaptive_avg_pool1d(y, t_out).transpose(1, 2)

        def kernel():
            return sb.stream_block(x, w, b, t_out, act)

        def generic():
            return sb._forward_kernel(x, w, b, t_out, act, sb.GENERIC)

        want = sb.stream_block_reference(x, w, b, t_out, act)
        errs = {"library": (library() - want).abs().max().item(),
                "generic": (generic() - want).abs().max().item()}
        if act != "relu" or max(errs.values()) > KERNEL_TOL:
            raise RuntimeError(f"stream_block {name}: a yardstick computes another function: "
                               f"{errs}")
        with torch.inference_mode():
            ms = {"kernel": time_cuda_graph(kernel), "generic": time_cuda_graph(generic),
                  "library": time_cuda_graph(library),
                  "plain": time_cuda_graph(lambda: sb.stream_block_reference(x, w, b, t_out,
                                                                             act)),
                  "generic_2": time_cuda_graph(generic), "kernel_2": time_cuda_graph(kernel)}
        bound_ms, bound_by = stream_block_bound(bsz, t, cin, k, cout, t_out)
        launch = sb.forward_config(bsz, t, cin, cout, k, t_out, act)
        out[name] = {"graph_ms": min(ms["kernel"], ms["kernel_2"]),
                     "generic_graph_ms": min(ms["generic"], ms["generic_2"]),
                     "library_graph_ms": ms["library"], "plain_graph_ms": ms["plain"],
                     "bound_ms": bound_ms, "bound_by": bound_by, "launch": launch}
        log(f"[time] {card}: stream_block {name} x({bsz},{t},{cin}) k{k} -> ({bsz},{t_out},"
            f"{cout}), 200 calls from a CUDA graph (device only), in turns: {launch['variant']} "
            f"{ms['kernel']:.4f}/{ms['kernel_2']:.4f} ms, the generic variant "
            f"{ms['generic']:.4f}/{ms['generic_2']:.4f} ms, library conv1d+relu+"
            f"adaptive_avg_pool1d {ms['library']:.4f} ms, plain {ms['plain']:.4f} ms; bound "
            f"{bound_ms:.5f} ms ({bound_by}); launch {launch}")
    return out


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
                    for v in (sb.WIDE, sb.PER_FRAME, sb.GENERIC)}
        edge_b = {v: device_ms(lambda v=v: sb._backward_kernel(xt, wt, bt, gt, t_out, "gelu",
                                                                 v))
                  for v in (sb.BWD_WIDE, sb.BWD_GENERIC)}
        out["threshold_ms"][cin] = {
            "forward_wide": edge[sb.WIDE], "forward_per_frame": edge[sb.PER_FRAME],
            "forward_generic": edge[sb.GENERIC],
            "backward_wide": edge_b[sb.BWD_WIDE], "backward_generic": edge_b[sb.BWD_GENERIC]}
        log(f"[time] {card}: stream_block at x({bsz},{t},{cin}) gelu (the wrapper's wide "
            f"variants from C_in {sb.WIDE_MIN_CIN}), device: forward wide "
            f"{edge[sb.WIDE]:.4f} ms, per_frame {edge[sb.PER_FRAME]:.4f} ms, generic "
            f"{edge[sb.GENERIC]:.4f} ms; backward wide "
            f"{edge_b[sb.BWD_WIDE]:.4f} ms, generic {edge_b[sb.BWD_GENERIC]:.4f} ms")
    return out


def cheap_xattn_bound(n, tq, tk, d):
    """Read A and B once, write O once; two products of 2*N*Tq*Tk*d FLOP."""
    return _bound(4 * n * d * (2 * tq + tk), 2 * 2 * n * tq * tk * d)


def cheap_xattn_backward_bound(n, tq, tk, d):
    """Read A, B, dO once, write dA, dB once; five products (S, dP, dA, and
    dB's two), each 2*N*Tq*Tk*d FLOP."""
    return _bound(4 * n * d * (3 * tq + 2 * tk), 5 * 2 * n * tq * tk * d)


def time_cheap_xattn(rng, dev, card, shape=XATTN_CASES["main"], old=None) -> dict:
    """The cross-attention's forward and backward at ``shape``: kernel,
    plain version, library call (scaled_dot_product_attention and its
    autograd) and bound, eager and each replayed from a CUDA graph, the
    device's time without the host's. With ``old``, also that variant's
    kernels by name, held against the plain versions and timed in turns
    with the chosen ones (new, old, new from a graph)."""
    n, tq, tk, d = shape
    a, b, g = xattn_inputs(rng, n, tq, tk, d, dev)
    old_name = None if old is None else cx.VARIANT_NAMES[old]

    def library():  # its default scale is 1/sqrt(d): the same function
        return F.scaled_dot_product_attention(a, b, b)

    lib_err = (library() - cx.cheap_xattn_reference(a, b)).abs().max().item()
    if lib_err > (KERNEL_TOL if tk <= 64 else XATTN_LONG_ATOL):
        raise RuntimeError(f"library yardstick computes another function: {lib_err}")
    with torch.inference_mode():
        plain_ms = time_cuda(lambda: cx.cheap_xattn_reference(a, b))
        kernel_ms = time_cuda(lambda: cx.cheap_xattn(a, b))
        kernel_ms_2 = time_cuda(lambda: cx.cheap_xattn(a, b))
        plain_ms_2 = time_cuda(lambda: cx.cheap_xattn_reference(a, b))
        library_ms = time_cuda(library)
        graph = {"graph_ms": time_cuda_graph(lambda: cx.cheap_xattn(a, b)),
                 "library_graph_ms": time_cuda_graph(library),
                 "plain_graph_ms": time_cuda_graph(lambda: cx.cheap_xattn_reference(a, b))}
        if old is not None:
            def old_forward():
                return cx._forward_kernel(a, b, old)

            old_err = (old_forward() - cx.cheap_xattn_reference(a, b)).abs().max().item()
            if old_err > XATTN_LONG_ATOL:
                raise RuntimeError(f"{old_name} forward disagrees with its plain version: "
                                   f"{old_err}")
            graph[f"{old_name}_ms"] = time_cuda(old_forward)
            graph[f"{old_name}_graph_ms"] = time_cuda_graph(old_forward)
            graph["graph_ms_2"] = time_cuda_graph(lambda: cx.cheap_xattn(a, b))
    bound_ms, bound_by = cheap_xattn_bound(n, tq, tk, d)
    variant = cx.VARIANT_NAMES[cx._variant(tq, tk, d)]
    log(f"[time] {card}: cheap_xattn N {n}, Tq {tq}, Tk {tk}, d {d} (variant {variant}): kernel "
        f"{kernel_ms:.4f}/{kernel_ms_2:.4f} ms, plain {plain_ms:.4f}/{plain_ms_2:.4f} ms, "
        f"library scaled_dot_product_attention {library_ms:.4f} ms (max abs diff "
        f"{lib_err:.2e}), bound {bound_ms:.5f} ms ({bound_by})"
        f"; from a CUDA graph (device only): kernel {graph['graph_ms']:.4f} ms, library "
        f"{graph['library_graph_ms']:.4f} ms, plain {graph['plain_graph_ms']:.4f} ms"
        + ("" if old is None else
           f"; {old_name} by name: eager {graph[f'{old_name}_ms']:.4f} ms, from a graph "
           f"{graph[f'{old_name}_graph_ms']:.4f} ms (max abs err {old_err:.2e}), then the "
           f"kernel again {graph['graph_ms_2']:.4f} ms"))

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
    bwd_graph = {"graph_ms": time_cuda_graph(lambda: cx.cheap_xattn_backward(a, b, g)),
                 "library_graph_ms": time_cuda_graph(library_backward, warmup=5, reps=50)}
    if old is not None:
        def old_backward():
            return cx._backward_kernel(a, b, g, old)

        old_b_err = max((p - q).abs().max().item() for p, q in zip(old_backward(), want))
        if old_b_err > XATTN_GRAD_ATOL + XATTN_GRAD_RTOL * max(q.abs().max().item() for q in want):
            raise RuntimeError(f"{old_name} backward disagrees with its plain version: "
                               f"{old_b_err}")
        bwd_graph[f"{old_name}_ms"] = time_cuda(old_backward)
        bwd_graph[f"{old_name}_graph_ms"] = time_cuda_graph(old_backward)
        bwd_graph["graph_ms_2"] = time_cuda_graph(lambda: cx.cheap_xattn_backward(a, b, g))
    bwd_bound, bwd_by = cheap_xattn_backward_bound(n, tq, tk, d)
    launch = {bw: xattn_launch(n, tq, tk, d, bw) for bw in (False, True)}
    log(f"[time] {card}: cheap_xattn launch {launch[False]}; cheap_xattn_backward launch "
        f"{launch[True]}")
    log(f"[time] {card}: cheap_xattn_backward at N {n}, Tq {tq}, Tk {tk}, d {d}: kernel "
        f"{bwd_kernel:.4f}/{bwd_kernel_2:.4f} ms, plain (autograd of the plain forward) "
        f"{bwd_plain:.4f}/{bwd_plain_2:.4f} ms, library (autograd of "
        f"scaled_dot_product_attention, forward included; max abs diff {lib_b_err:.2e}) "
        f"{bwd_library:.4f} ms, bound {bwd_bound:.5f} ms ({bwd_by})"
        f"; from a CUDA graph (device only): kernel {bwd_graph['graph_ms']:.4f} ms, "
        f"library {bwd_graph['library_graph_ms']:.4f} ms"
        + ("" if old is None else
           f"; {old_name} by name: eager {bwd_graph[f'{old_name}_ms']:.4f} ms, from a graph "
           f"{bwd_graph[f'{old_name}_graph_ms']:.4f} ms (max abs err {old_b_err:.2e}), then "
           f"the kernel again {bwd_graph['graph_ms_2']:.4f} ms"))
    return {
        "cheap_xattn": {"ms": min(kernel_ms, kernel_ms_2), "plain_ms": min(plain_ms, plain_ms_2),
                        "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "variant": launch[False]["variant"], "launch": launch[False], **graph},
        "cheap_xattn_backward": {"ms": min(bwd_kernel, bwd_kernel_2),
                                 "plain_ms": min(bwd_plain, bwd_plain_2),
                                 "library_ms": bwd_library, "bound_ms": bwd_bound,
                                 "bound_by": bwd_by, "variant": launch[True]["variant"],
                                 "launch": launch[True], **bwd_graph},
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


def mtl_solver_ops(name, k):
    """f32 operations of one solve at K tasks, counted from
    csrc/mtl_solvers.cu, a powf as one."""
    dot = 2 * k - 1
    matvec = k * dot
    newton = (2 * k + sum((k - p - 1) * (3 + 2 * (k - p - 1)) for p in range(k))
              + sum(2 * (k - p - 1) + 1 for p in range(k)) + 3 * k)
    if name == "min_norm_solver":
        return 250 * (2 * matvec + (k - 1) + k + 2 * dot + 5 + 3 * k)
    if name == "fairgrad_solver":
        return 3 + 100 * (matvec + 4 * k + newton)
    return 50 * (matvec + 4 * k + newton)


def time_mtl_solvers(rng, dev, card) -> dict:
    """Each solver kernel at the main path's shape (K = 3, one matrix, a
    step's launch) beside its plain version on the card and its bound."""
    raw = torch.from_numpy(mtl_solver_grams(rng, 1, 3)[0]).to(dev)
    out = {}
    for name, run, plain, prep in (
            ("min_norm_solver", ms.min_norm_solve, ms.min_norm_solve_reference, lambda g: g),
            ("fairgrad_solver", lambda g: ms.fairgrad_solve(g, 1.0),
             lambda g: ms.fairgrad_solve_reference(g, 1.0), lambda g: g),
            ("nashmtl_solver", ms.nashmtl_solve, ms.nashmtl_solve_reference, nash_normalised)):
        gram = prep(raw)
        kernel_ms = time_cuda(lambda: run(gram), warmup=10, reps=200)
        plain_ms = time_cuda(lambda: plain(gram), warmup=1, reps=3)
        kernel_ms_2 = time_cuda(lambda: run(gram), warmup=10, reps=200)
        dev_ms = device_ms(lambda: run(gram))
        ops = mtl_solver_ops(name, 3)
        bound_ms, bound_by = _bound(4 * (9 + 3), ops)
        log(f"[time] {card}: {name} K=3 (one Gram matrix): kernel {kernel_ms:.4f}/"
            f"{kernel_ms_2:.4f} ms eager (device {dev_ms:.4f} ms under the profiler), plain "
            f"(eager torch on the card, 3 calls) {plain_ms:.2f} ms, bound {bound_ms:.3e} ms "
            f"({bound_by}: {ops} f32 operations)")
        out[name] = {"ms": min(kernel_ms, kernel_ms_2), "plain_ms": plain_ms,
                     "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
                     "device_ms": dev_ms}
    return out


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


def make_step_setup(seed, dev, bsz, baseline=None, no_dropout=False, mtl_method="cagrad",
                    recipe=False, **widths):
    """A flagship model with its SGD and ``mtl_method`` step (CAGrad at
    c = 0.5 by default), or a baseline with SGD on the mean of its branch
    losses (sync; DeepAV-Lite and TACA with their dropout, or at rate 0 with
    ``no_dropout``), one card-resident batch of ``bsz`` window tuples, and
    the step's generator. With ``recipe`` the step augments and drops
    modalities as RECIPE sets them; ``widths`` sets WearGaitArgs' sizes
    (enc_out_ch, win_len)."""
    args = wg.WearGaitArgs(seed=seed, baseline=baseline, **(RECIPE if recipe else {}), **widths)
    model = wg.build_model(args, True)
    if no_dropout:
        BL.without_dropout(model)
    model = model.to(dev)
    aug_specs, aug_params = wg.weargait_aug_config(args)
    settings = StepSettings(n_streams=3, wm="gcl", synchronized=True,
                            private_grads="sum_plus_own",
                            dropout=baseline in wg.DROPOUT_BASELINES,
                            modality_dropout=args.modality_dropout, augment=aug_specs)
    if baseline is None:
        kwargs = {"c": 0.5} if mtl_method in ("cagrad", "log_cagrad") else {}
        mtl = make_method(mtl_method, 3, **kwargs)
        step = make_train_step(settings, mtl, build_flat_partition(
            model, model.shared_modules, model.task_modules))
        mtl_state = mtl.init_state(dev)
    else:
        step = make_train_step(settings, train_apply=wg.baseline_adapters(args)[0])
        mtl_state = {}
    state = TrainState(module=model, optimizer=sgd_torch(model.parameters(), 1e-3),
                       mtl_state=mtl_state)
    ctx = make_loss_ctx(settings, [[900, 700]] * 3, device=dev, aug_params=aug_params)
    g = torch.Generator().manual_seed(seed)  # on the host: the same batch on any device
    batch = {
        "xs": tuple(torch.randn((bsz, args.win_len, CHANNELS[m]), generator=g).to(dev)
                    for m in MODALITIES),
        "ys": tuple(torch.randint(0, 2, (bsz,), generator=g).to(dev) for _ in MODALITIES),
        "valid": torch.ones(bsz, device=dev),
        "n_valid": bsz,
    }
    return step, state, ctx, batch, torch.Generator(device=dev).manual_seed(seed)


def time_train_step(seed, dev, card, baseline=None, mtl_method="cagrad", recipe=False) -> dict:
    out = {}
    label = baseline or ("CAGrad" if mtl_method == "cagrad" else mtl_method)
    label += " recipe" if recipe else ""
    for bsz in TRAIN_BATCHES:
        step, state, ctx, batch, gen = make_step_setup(seed, dev, bsz, baseline,
                                                       mtl_method=mtl_method, recipe=recipe)
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
        log(f"[time] {card}: {label} train step, batch {bsz} window tuples "
            f"(card-resident): "
            f"{ms:.3f} ms, {1e3 * bsz / ms:.1f} window tuples/s")
    return out


def time_ff_train_step(seed, dev, card, setup=None, label="FoG multimodal CAGrad") -> dict:
    """A FoG train step at batch 256 and 1024, host clock around 20
    synchronised steps after 3, as time_train_step times the WearGait step:
    ``setup(seed, dev, bsz)``'s (default: the multimodal CAGrad step, async,
    GCL, LayerNorm + cosine heads)."""
    setup = setup or ff_step_setup
    out = {}
    for bsz in (FF_BATCH, 1024):
        step, state, ctx, batch, gen = setup(seed, dev, bsz)
        for _ in range(3):
            step(state, batch, gen, ctx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            _, metrics = step(state, batch, gen, ctx)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / 20
        if not torch.isfinite(metrics["losses"]).all():
            raise RuntimeError(f"FoG train step at batch {bsz}: non-finite loss")
        out[f"batch{bsz}"] = {"ms": ms, "window_pairs_per_s": 1e3 * bsz / ms}
        log(f"[time] {card}: {label} train step, batch {bsz} window pairs "
            f"(card-resident): {ms:.3f} ms, {1e3 * bsz / ms:.1f} window pairs/s")
    return out


def time_ff_step_profile(seed, dev, card, setup=None, label="FoG multimodal CAGrad") -> dict:
    """Device time, kernel launches and wall time a step of a FoG train
    step (``setup`` as time_ff_train_step's) at batch 256 and 1024
    (torch.profiler over 10 steps after one), and the device time by kernel
    at batch 256."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    setup = setup or ff_step_setup
    out = {}
    for bsz in (FF_BATCH, 1024):
        step, state, ctx, batch, gen = setup(seed, dev, bsz)
        step(state, batch, gen, ctx)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(10):
                step(state, batch, gen, ctx)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        out[f"batch{bsz}"] = {
            "device_ms": sum(e.self_device_time_total for e in kernels) / 1e4,
            "kernels": sum(e.count for e in kernels) / 10, "wall_ms_profiled": wall_ms / 10}
        if bsz == FF_BATCH:
            profile_table(prof, f"10 x {label} train step batch {bsz}", wall_ms, card)
    log(f"[time] {card}: {label} train step, device time (ms), kernel "
        f"launches and profiled wall time (ms) a step: {out}")
    return out


def time_recipe_step(seed, dev, card) -> dict:
    """Device time and kernel launches of one batch-1024 CAGrad train step,
    plain and with the recipe (torch.profiler over 10 steps each, in turns:
    plain, recipe, recipe, plain)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    runs = {"plain": [], "recipe": []}
    for label in ("plain", "recipe", "recipe", "plain"):
        step, state, ctx, batch, gen = make_step_setup(seed, dev, 1024, recipe=label == "recipe")
        step(state, batch, gen, ctx)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                step(state, batch, gen, ctx)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        runs[label].append((sum(e.self_device_time_total for e in kernels) / 1e4,
                            sum(e.count for e in kernels) / 10))
    out = {label: {"device_ms": [r[0] for r in rs], "kernels": [r[1] for r in rs]}
           for label, rs in runs.items()}
    log(f"[time] {card}: CAGrad train step batch 1024, device time (ms) and kernel launches a "
        f"step, plain {out['plain']}, recipe {out['recipe']}")
    return out


def time_checkpoint_save(seed, dev, card) -> dict:
    """Host time to save one fold checkpoint of the flagship (module,
    momentum, CAGrad state, generators) from the card, 20 saves after one."""
    step, state, ctx, batch, gen = make_step_setup(seed, dev, 64)
    step(state, batch, gen, ctx)
    rng = np.random.default_rng(seed)
    lat = []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(21):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = save_fold_checkpoint(tmp, 1, state, best_metric=50.0, rng=rng, generator=gen)
            if i:
                lat.append(1e3 * (time.perf_counter() - t0))
        size = path.stat().st_size
    out = {"ms_p50": float(np.percentile(lat, 50)), "ms_max": float(max(lat)), "bytes": size}
    log(f"[time] {card}: save one fold checkpoint from the card ({size} bytes): p50 "
        f"{out['ms_p50']:.3f} ms, max {out['ms_max']:.3f} ms over {len(lat)} saves")
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
    wide_errors = check_wide_xattn(zrng, dev, card, WIDE_XATTN_CASES)
    wide_xattn_times = time_wide_xattn(zrng, dev, card)
    check_wide_xattn(np.random.default_rng([args.seed, 15]), dev, card, TILED_XATTN_CASES)
    check_cheap_xattn(np.random.default_rng([args.seed, 7]), dev, card, XATTN_EDGE_CASES)
    check_sweep128_xattn(np.random.default_rng([args.seed, 17]), dev, card)
    print_xattn_configs(card)
    check_forward_edges(np.random.default_rng([args.seed, 8]), dev, card)
    check_solver_each_k(np.random.default_rng([args.seed, 9]), dev)
    fusion, single = phase_fusion_training(args.seed, dev)
    # the SOTA baselines' slice: a stream of its own as well
    frng = np.random.default_rng([args.seed, 10])
    focal_errors = check_focal_blocks(frng, dev, card)
    check_dropout_on_card(dev)
    sota = phase_sota_training(args.seed, dev)
    # the other MTL methods' slice: a stream of its own as well
    mrng = np.random.default_rng([args.seed, 11])
    mtl = phase_mtl_methods(args.seed, dev, mrng)
    # the recipe's slice: a stream of its own as well
    recipe = phase_recipe(args.seed, dev)
    # the FBG/FoG driver's slice: a stream of its own as well
    ff_rng = np.random.default_rng([args.seed, 13])
    fbg_fog = phase_fbg_fog(args.seed, dev, ff_rng)
    # the FBG/FoG baseline drivers' slice: a stream of its own as well
    bb_rng = np.random.default_rng([args.seed, 14])
    baselines = phase_baselines(args.seed, dev, card, bb_rng)
    # the kernel redesigns' slice: the tiled cross-attention on the fusion's
    # path at enc_out_ch 96
    wide_fusion = phase_wide_fusion_training(args.seed, dev)
    times = time_stream_block(rng, dev, card)
    times["cagrad_solver"] = time_solver(rng, dev, card)
    serving = time_serving(engine, rng, card)
    train_steps = time_train_step(args.seed, dev, card)
    ff_steps = time_ff_train_step(args.seed, dev, card)
    ff_profile = time_ff_step_profile(args.seed, dev, card)
    ff_times = time_stream_block(ff_rng, dev, card, FF_SHAPE, slice(FF_BATCH, None),
                                 "FoG async skeleton task layout")
    recipe_times = {"steps": time_train_step(args.seed, dev, card, recipe=True),
                    "profile": time_recipe_step(args.seed, dev, card),
                    "checkpoint_save": time_checkpoint_save(args.seed, dev, card)}
    times.update(time_cheap_xattn(xrng, dev, card))
    fusion_steps = time_train_step(args.seed, dev, card, "cheap_xattn")
    focal_times = time_focal_block(frng, dev, card)
    sota_steps = {b: time_train_step(args.seed, dev, card, b) for b in wg.SOTA_BASELINES}
    times.update(time_mtl_solvers(mrng, dev, card))
    mtl_steps = {m: time_train_step(args.seed, dev, card, mtl_method=m)
                 for m in sorted(METHODS) if m != "cagrad"}
    phase_profiles(engine, args.seed, dev, card)
    phase_sota_profiles(args.seed, dev, card)
    bb_xattn_times = time_cheap_xattn(bb_rng, dev, card, BB_XATTN_SHAPE, old=cx.TWO_PASS)
    t128_xattn_times = time_cheap_xattn(np.random.default_rng([args.seed, 18]), dev, card,
                                        SWEEP128_XATTN_CASES["t128_d12"], old=cx.TWO_PASS)
    bb_focal_times = time_stream_block(bb_rng, dev, card, BB_FOCAL_SHAPE, slice(FF_BATCH, None),
                                       "FOCAL async skeleton stream's layout")
    t101_times = time_t101_forwards(np.random.default_rng([args.seed, 16]), dev, card)

    def bb_xattn_setup(seed, device, bsz):
        return bb_step_setup(seed, device, bsz, "fusion", fusion_type="cheap_xattn")

    bb_label_xattn = "FoG cheap_xattn fusion (Adam)"
    bb_steps = time_ff_train_step(args.seed, dev, card, bb_xattn_setup, bb_label_xattn)
    bb_profile = time_ff_step_profile(args.seed, dev, card, bb_xattn_setup, bb_label_xattn)

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
    # the MTL solvers on their own methods' main paths: each method's sync run
    for name, method in (("min_norm_solver", "mgda"), ("fairgrad_solver", "fairgrad"),
                         ("nashmtl_solver", "nashmtl")):
        launches[name] = mtl["runs"][method]["sync"]["launches"][name]
    # the generic variants at the FBG/FoG path's shape: the FoG multimodal
    # async run's launches, the times at FoG's shape
    ff_main = fbg_fog["runs"]["fog multimodal async (CAGrad, GCL)"]["launches"]
    for name in ("stream_block", "stream_block_backward"):
        launches[f"{name}_fbg_fog"] = ff_main[name]
        times[f"{name}_fbg_fog"] = ff_times[name]
    # the cross-attention over up to 128 keys at the FBG/FoG fusion's shape:
    # the FoG cheap-xattn fusion run's launches, the times at its shape
    bb_main = baselines["runs"]["fusion cheap_xattn fog async"]["launches"]
    for name in ("cheap_xattn", "cheap_xattn_backward"):
        launches[f"{name}_fbg_fog"] = bb_main[name]
        times[f"{name}_fbg_fog"] = bb_xattn_times[name]
    # the per_frame forward at FOCAL's 2-mod shape: the FOCAL FoG run's
    # launches, the times at its shape
    launches["stream_block_focal_fbg_fog"] = (
        baselines["runs"]["focal fog async"]["launches"]["stream_block"])
    times["stream_block_focal_fbg_fog"] = bb_focal_times["stream_block"]
    # the tiled cross-attention at d 96 on its own main path: phase 5j's run
    # at enc_out_ch 96, the times at its train batch (win_len 64)
    for name, way in (("cheap_xattn", "forward"), ("cheap_xattn_backward", "backward")):
        launches[f"{name}_tiled"] = wide_fusion["sync"]["launches"][name]
        timed = wide_xattn_times[WIDE_XATTN_TIMED[0]]
        t, (bound_ms, bound_by) = timed[way], timed["bound"][way]
        times[f"{name}_tiled"] = {
            "ms": min(t["kernel"], t["kernel_2"]), "plain_ms": t["plain"],
            "library_ms": t["library"], "bound_ms": bound_ms, "bound_by": bound_by,
            "graph_ms": min(t["graph"], t["graph_2"]), "library_graph_ms": t["library_graph"],
            "variant": timed["launch"][way == "backward"]["variant"]}
    wide_err = wide_errors[WIDE_XATTN_TIMED[0]]
    bb_err = baselines["errors"]["xattn"]["fog_batch256"]
    ff_err = fbg_fog["errors"]["fog_batch256"]
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
        ("stream_block_fbg_fog", "gaitpd_torch/csrc/stream_block.cu",
         "gaitpd/ops/pallas_blocks.py:72", ff_err[0]),
        ("stream_block_backward_fbg_fog", "gaitpd_torch/csrc/stream_block.cu",
         "gaitpd/ops/pallas_blocks.py:160", ff_err[1]),
        ("stream_block_focal_fbg_fog", "gaitpd_torch/csrc/stream_block.cu",
         "gaitpd/ops/pallas_blocks.py:72", baselines["errors"]["focal_fog_batch256"][0]),
        # not a TPU kernel: the CAGrad solver that XLA compiles into the step
        ("cagrad_solver", "gaitpd_torch/csrc/cagrad_solver.cu", "gaitpd/learning/minnorm.py:58",
         solver_err),
        ("cheap_xattn", "gaitpd_torch/csrc/cheap_xattn.cu", "gaitpd/ops/pallas_blocks.py:184",
         xattn_errors["main"][0]),
        ("cheap_xattn_backward", "gaitpd_torch/csrc/cheap_xattn.cu",
         "gaitpd/ops/pallas_blocks.py:275", xattn_errors["main"][1]),
        ("cheap_xattn_fbg_fog", "gaitpd_torch/csrc/cheap_xattn.cu",
         "gaitpd/ops/pallas_blocks.py:184", bb_err[0]),
        ("cheap_xattn_backward_fbg_fog", "gaitpd_torch/csrc/cheap_xattn.cu",
         "gaitpd/ops/pallas_blocks.py:275", bb_err[1]),
        ("cheap_xattn_tiled", "gaitpd_torch/csrc/cheap_xattn.cu",
         "gaitpd/ops/pallas_blocks.py:184", wide_err[0]),
        ("cheap_xattn_backward_tiled", "gaitpd_torch/csrc/cheap_xattn.cu",
         "gaitpd/ops/pallas_blocks.py:275", wide_err[1]),
        # not TPU kernels either: the MGDA, FairGrad and NashMTL solvers
        ("min_norm_solver", "gaitpd_torch/csrc/mtl_solvers.cu", "gaitpd/learning/minnorm.py:35",
         mtl["solver_errors"]["min_norm_solver"]),
        ("fairgrad_solver", "gaitpd_torch/csrc/mtl_solvers.cu",
         "gaitpd/learning/minnorm.py:125", mtl["solver_errors"]["fairgrad_solver"]),
        ("nashmtl_solver", "gaitpd_torch/csrc/mtl_solvers.cu", "gaitpd/learning/minnorm.py:144",
         mtl["solver_errors"]["nashmtl_solver"]),
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
        f"{json.dumps(sota_steps)}; the other MTL methods' runs and syncs "
        f"{json.dumps({k: mtl[k] for k in ('runs', 'syncs')})} and train steps "
        f"{json.dumps(mtl_steps)}; the recipe {json.dumps(recipe)} and its times "
        f"{json.dumps(recipe_times)}; the FBG/FoG driver {json.dumps(fbg_fog)}, its train steps "
        f"{json.dumps(ff_steps)} and profile {json.dumps(ff_profile)}; the baseline drivers "
        f"{json.dumps(baselines)}, the stream block at FOCAL's 2-mod shape "
        f"{json.dumps(bb_focal_times)}, the cheap-xattn fusion's train steps "
        f"{json.dumps(bb_steps)} and profile {json.dumps(bb_profile)}; the cross-attention at "
        f"d 96 {json.dumps(wide_xattn_times)} and the fusion at enc_out_ch {WIDE_FUSION_CH} "
        f"(and its step at win_len {LONG_WINDOW}) "
        f"{json.dumps(wide_fusion)}; the T 101 forwards {json.dumps(t101_times)}; the "
        f"cross-attention at Tq = Tk = 128, d 12 {json.dumps(t128_xattn_times)}")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
