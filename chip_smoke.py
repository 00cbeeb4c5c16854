#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gaitpd_torch) once on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases (each raises on failure, so the script exits non-zero):
  1. device: the card's name, count and power limit; build every kernel in
     gaitpd_torch/csrc with nvcc, one process each, all at once, and print
     each kernel's registers, spills and shared memory from nvcc's -Xptxas -v
     lines; phase 2 starts once the stream block and the CAGrad solver are
     built, the other sources finishing alongside phases 2-4;
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
     their own, 65-128 keys (the sweep over key tiles forward, the sweep
     over 128 keys backward) at FoG's (2 x 256 and 2 x 1024
     window pairs, d 6), FBG's (2 x 32, d 3), the symmetric 2-mod (2 x 64,
     d 12) and --win_len 128's (Tq = Tk = 128, d 12) shapes and at its edges
     (d 8 and 9 at T 101, d 64 over 128 keys; 129 keys and 129 query rows
     on the sweep over key tiles), each launch printed;
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
     matrices, in one launch, one matrix a launch and 257 matrices in one
     launch (w bitwise equal, finite, MGDA's on the simplex, each launch
     counted), MGDA's one-thread design by name too (w bitwise equal);
     each method's
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
     (65-128 keys: the sweep over key tiles forward, over 128 keys backward)
     at the fusion's shapes (2 x 256 and 2 x 1024 window
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
  5k. the sweep over key tiles (d <= 64 beyond 128 keys or, backward, query
     rows), from a random stream of its own: the cross-attention at
     --win_len 256's shapes (6 x 64 and 6 x 1024 problems of 256 x 256, d
     12), at --win_len 129's (2 x 64 of 129 x 129), at 129 keys (N 5) and at
     its edges (257 keys at d 8, one query row, d 3, 13 and 64, query rows
     beyond 128 against 100 and 131 keys), as in phase 5, each launch
     printed; the backbone's kernels at the --win_len 256 step's shape
     (3 x 64 windows of 256 frames, C_in 12) as in phase 2, with their
     launches; one cheap-xattn train step at batch 64, win_len 256, card vs
     CPU as in phase 4, with one launch of each cross-attention kernel and
     of the stream block's forward and backward;
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
     3 x 64 (device time under the profiler, beside the library's); the
     wide variants against per_frame and the generic backward at every C_in
     17..63 of TILE_SIZES, ReLU and GELU, from a CUDA graph in turns (the
     wrapper's thresholds); one
     train step of each SOTA baseline at batch 64 and 1024; the MGDA,
     FairGrad and NashMTL solver kernels at K = 3, one matrix (eager and
     device time, plain version, bound; FairGrad's and NashMTL's warp
     design from a CUDA graph, and each design's launch, registers and
     spills) and one train step of every MTL
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
     beside the plain versions, scaled_dot_product_attention and its
     autograd, and the bounds; the
     stream block at FOCAL's 2-mod shape beside conv1d + ReLU + pool; the
     sweep over key tiles at --win_len 256's shapes (batch 64 and 1024), at
     N 128, Tq = Tk = 129 and at N 5, Tq 128, Tk 129, d 12, as the FoG shape
     above; the cheap-xattn train step at win_len 256,
     batch 64 and 1024; every
     T 101 forward shape of phases 5h and 5i (C_in 3, 6, 12, 16, 32) from a
     CUDA graph: per_frame, the generic variant it replaces, the library
     call and the plain version, in turns; the wide threshold's shapes also
     with per_frame; the FoG cheap-xattn fusion train step at batch 256 and
     1024 with its device time and launches;
  7. the CLI and WearGait's folds in one step (--vmap_folds), from random
     streams of their own: the fold-stacked stream block (10 folds x 3 x 64
     windows: warp_tile, wide at --enc_out_ch 96, per_frame at --win_len
     101) against its plain version (forward within 1e-5; backward as in
     phase 2, the ReLU kink windows' cotangents set to 0 in both), each
     fold's output and gradients bitwise equal to a launch of that fold
     alone, one launch each way, each launch's config printed;
     run_cv_vmapped at the CLI's defaults (10 folds, test_per_class 8; 2
     sync epochs, 1 async) fold by fold against the sequential run_cv on
     the card: the first epoch's losses within 1e-4 relative, later epochs
     within 10x the gap of the sequential run from initial parameters
     scaled by 1 + 1e-7 N(0, 1) (training amplifies rounding over 14 steps
     an epoch), each fold's best macro and 7-subset scores within one eval
     window; a stacked step launches the stream block's forward once, its
     backward 3 times and the CAGrad solver once for all 10 folds, each
     eval forward the stream block once, and synchronises the host 0 times;
     one stacked step at 10 x 64 beside the 10 sequential batch-64 steps
     it replaces (host clock around synchronised steps, in turns; device
     time and kernel launches under the profiler); python -m
     gaitpd_torch.cli --mode weargait --synthetic, with and without
     --vmap_folds, as two subprocesses at once: each exits 0 and prints the
     7-subset table; then the fold-stacked block timed at 10 x 192 windows
     (eager and from a CUDA graph) beside its plain version, a grouped
     F.conv1d + ReLU + pool and its bound;
  8. WearGait's baselines and the recipe's draws under --vmap_folds, from a
     random stream of their own: the cross-attention under torch.func.vmap
     over 10 folds x 6 x 64 problems at each variant's shape (d 12, d 16,
     T 101, d 96): one launch each way for all folds, each fold bitwise
     equal to a launch of its own, within phase 5's tolerances of the plain
     version; run_cv_vmapped of the cheap-xattn fusion (2 sync epochs) and
     of TACA (2 async epochs, its dropout drawn from each fold's generator)
     at the CLI's defaults against the sequential run_cv on the card under
     phase 7's rule, every fold's generator bitwise equal at the end, the
     cheap-xattn run one cross-attention launch each way a stacked step and
     TACA none; a stacked cheap-xattn and DeepAV-Lite step at 10 x 64 beside
     the 10 sequential steps (launches, 0 host synchronisations, host
     clock, device time, kernels and idle share); the merged cross-attention
     at 10 x 384 problems timed beside its plain version, SDPA and its
     bound, and the vmapped forward eager and from a CUDA graph;
  9. the 16 other MTL methods under --vmap_folds, from a random stream of
     their own: the CAGrad, MGDA, FairGrad and NashMTL solvers under
     torch.func.vmap over 10 folds' Gram matrices (K = 3): one launch each
     (counted once by the solver's counter and its fold counter), each
     fold bitwise equal to a launch of its own and to the plain version;
     one stacked step at 10 x 64 of each of the 17 methods (a stateful
     one's after one step) against the 10 sequential steps it replaces,
     each fold's mtl_grads on the card: final gradients and new states
     within phase 4's tolerance, every fold's generator bitwise equal, the
     method's solver once and the stream block's kernels as in phase 7, 0
     host synchronisations; run_cv_vmapped of PCGrad (with the GCL noise)
     and NashMTL (2 sync epochs) against the sequential run_cv on the card
     under phase 7's rule, epoch 1 also held to the yardstick, every
     fold's generator bitwise equal at the end; MGDA and FairGrad (1 sync
     epoch) on the card alone, for their solvers' launches; the stacked
     MGDA, FairGrad, NashMTL and FAMO steps beside the 10 sequential steps
     (host clock, device time, kernels, idle share); each solver's merged
     launch of 10 matrices, the vmapped call and the 10 single launches,
     eager and from a CUDA graph, beside its plain version and its bound;
  10. FBG/FoG's folds and the baseline seed sweeps under --vmap_folds, from
     a random stream of their own: the stream block under torch.func.vmap
     over 3 folds of 2 x 256 windows at T 101 (FoG's C_in 6 and FBG's 3,
     8 bins; FOCAL's 32 -> 4 channels, 4 bins, ReLU and GELU): one launch
     each way for all folds, each fold bitwise equal to a launch of its
     own, within phase 2's tolerances of the plain version; the CAGrad
     solver under vmap over 3 folds' 2 x 2 Gram matrices: one launch, each
     fold bitwise equal to its own launch and to the plain version;
     run_fbg_fog_vmapped (FoG multimodal, GCL and CAGrad, 2 epochs) and
     run_baseline_seeds_vmapped of the cheap-xattn fusion (synced, Adam)
     and FOCAL (async, AdamW with the clip; seeds 0 and 1, 2 folds a seed,
     2 epochs) against the sequential drivers on the card under phase 7's
     rule (the accuracies within one eval sample's share), every fold's
     generator bitwise equal, the launches a stacked step; one stacked FoG
     CAGrad step at 3 x 256 beside the 3 sequential steps (launches, 0 host
     synchronisations, also in a stacked FOCAL step under FoldAdam; host
     clock, device time, kernels, idle share); python -m gaitpd_torch.cli
     --mode fbg_fog --vmap_folds; the fold-stacked block at FoG's and
     FOCAL's shapes timed beside its plain version, the grouped library
     call and its bound, and the solver's merged launch at K = 2.

  11. the HP grid (--vmap_hp) and the sweep runner, from a random stream
     of their own: the stream block under vmap over the grid's 40 instances
     (4 rows x 10 folds x 3 x 64 windows), as in phase 7; the CAGrad solver
     with c one value a matrix (40 matrices at K = 3 and K = 2, c in 0.1,
     0.5, 25): one launch, each matrix bitwise a scalar-c launch of its own
     and the plain version, directly and under vmap with a batched c;
     run_weargait_hp_vmapped of the flagship (GCL, CAGrad c 0.5, 2 sync
     epochs; rows lr 1e-3 / alpha 0.5, alpha 25, lr 1e-8, lr 3e-3) against
     run_cv_vmapped on the card under phase 7's rule (its args' row), every
     instance's generator bitwise its fold's, the other rows training
     otherwise, one solver launch a stacked step reading c per matrix; the
     cheap-xattn fusion's lr grid (1 epoch) likewise; FoG's grid ({}, the
     driver's values written out, lr 10), the written-out row against the
     empty one; one stacked grid step of 4 x 10 x 64 beside the stacked
     10-fold step (launches, 0 host synchronisations, host clock, device
     time, kernels, idle share); python -m gaitpd_torch.cli --vmap_hp and
     python -m gaitpd_torch.sweep (--vmap_seeds, then sequential: done=2,
     then skipped=2, failed=0 both times) as subprocesses; the fold block at
     the grid's 40 instances and the per-matrix solver at 40 matrices timed
     beside their plain versions, the library and their bounds.
  12. the fused forward (--fused), from a random stream of its own: the
     fused flagship against the unfused one on the card at 1024 window
     tuples (sync and async; plain and LayerNorm + cosine heads): logits
     within 2e-5, one stream-block launch a forward; the stream block at
     the main shape in the fused backbone's (b, stream) row order, forward
     and the backward in a CAGrad task pass's layout (every third row live)
     against their plain versions as in phase 2, timed eager and from a
     CUDA graph beside the plain versions, the library calls and the
     bounds, the backward in turns with the stream-major task layout and
     all rows live; one fused CAGrad step card vs CPU as in phase 4; a fused
     run_cv card vs CPU (sync, 2 epochs) as in phase 4, a train step 1
     stream-block forward, 3 backward and 1 solver launch, an eval forward
     1 forward; run_cv_vmapped fused (1 sync epoch) against the
     sequential fused run_cv on the card under phase 7's rule; the fused
     and unfused sequential (64), stacked (10 x 64) and grid (4 x 10 x 64)
     CAGrad steps: the fused step's launches (the unfused law), the host
     clock of synchronised steps in turns (median and spread), and under
     gaitpd_torch.runtime.profiling.trace each one's kernels, cuDNN
     weight-gradient kernels by name and windows/s (StepTimer);
  13. remat and the data-parallel mesh, from a random stream of its own:
     the CAGrad step at batch 64 under remat "none", "dots" and "nothing",
     card vs CPU as in phase 4 and on the card against "none" (phase 4's
     tolerances), its stream-block launches (forward 1/1/4, backward 3/3/3
     a step), its median step time and peak memory at batch 64 and 1024;
     DeepAV-Lite at dropout 0.1 under each policy: the masks a
     recomputation draws bitwise the first forward's, the step equal to
     "none"'s, the generator bitwise where "none" leaves it; the
     data-parallel step over a 1-rank NCCL mesh against the step without
     one; python -m gaitpd_torch.entry multichip 2 (two gloo ranks sharing
     the card through gaitpd's dry-run phases) and the CLI's
     --data_parallel as subprocesses.

The subprocess checks of phases 7, 10, 11 and 13 run all at once before
phase 7 (run_commands), the main process waiting. After each phase a line
``[phase] <name> <seconds>`` gives its wall time.

Every number is printed beside the card's name and power limit. The
second-to-last line is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}. Without a CUDA device it exits 1
before printing any result.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import itertools
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from gaitpd_torch.config import FBG_FOG_DIMS
from gaitpd_torch.data import synthetic as syn
from gaitpd_torch.data.sampler import batch_index_matrix
from gaitpd_torch.data.weargait import prepare_split
from gaitpd_torch.learning import mtl as mtl_lib
from gaitpd_torch.learning.minnorm import min_norm_element_stop, min_norm_every
from gaitpd_torch.learning.mtl import (
    METHODS,
    _graddrop_mask,
    _rlw_weights,
    build_flat_partition,
    make_method,
)
from gaitpd_torch.models import baselines as BL
from gaitpd_torch.models.blocks import dropout
from gaitpd_torch.models.fused import FusedWearGaitThreeModal
from gaitpd_torch.models.multitask import CHANNELS, MODALITIES, WearGaitThreeModal
from gaitpd_torch.ops import _build
from gaitpd_torch.ops import cagrad_solver as cs
from gaitpd_torch.ops import cheap_xattn as cx
from gaitpd_torch.ops import mtl_solvers as ms
from gaitpd_torch.ops import stream_block as sb
from gaitpd_torch.runtime import fold_draws, profiling
from gaitpd_torch.runtime.device import resolve_device
from gaitpd_torch.runtime.mesh import make_mesh, mesh_sharding
from gaitpd_torch.serve import StreamingSession, WearGaitEngine, poll_sessions
from gaitpd_torch.tools import recipe_laws
from gaitpd_torch.train import baseline_drivers as bd
from gaitpd_torch.train import fbg_fog_driver as ff
from gaitpd_torch.train import vmap_cv as vc
from gaitpd_torch.train import weargait_driver as wg
from gaitpd_torch.train.checkpoint import save_fold_checkpoint
from gaitpd_torch.train.cv import build_subj2label, make_fixed_balanced_folds_no_overlap
from gaitpd_torch.train.optim import FoldAdam, adam_torch, adamw_torch, sgd_torch
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
    "stream_block_folds": (sb, "fold_launches"),
    "stream_block_backward_folds": (sb, "fold_backward_launches"),
    "cagrad_solver": (cs, "launches"),
    "cheap_xattn": (cx, "launches"),
    "cheap_xattn_backward": (cx, "backward_launches"),
    "min_norm_solver": (ms, "min_norm_launches"),
    "fairgrad_solver": (ms, "fairgrad_launches"),
    "nashmtl_solver": (ms, "nashmtl_launches"),
    # of those, the launches for every fold of a stacked step (a vmap rule)
    "cagrad_solver_folds": (cs, "fold_launches"),
    "min_norm_solver_folds": (ms, "min_norm_fold_launches"),
    "fairgrad_solver_folds": (ms, "fairgrad_fold_launches"),
    "nashmtl_solver_folds": (ms, "nashmtl_fold_launches"),
    # of the CAGrad solver's, the launches that read c one value a matrix
    "cagrad_solver_per_matrix_c": (cs, "per_matrix_launches"),
}


def log(*parts) -> None:
    print(*parts, flush=True)


_LAP = [0.0]


def lap(name: str) -> None:
    """Print the wall seconds since the last lap as ``[phase] <name> <s>``."""
    now = time.perf_counter()
    log(f"[phase] {name} {now - _LAP[0]:.1f}")
    _LAP[0] = now


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


# the kernels phases 2-4 launch: phase 1 waits for their builds alone, and
# the others (the cheap cross-attention's takes ~145 s) build alongside
# phases 2-4 (finish_builds)
EARLY_KERNELS = ("stream_block", "cagrad_solver")


def log_build(r) -> None:
    log(f"[build] {r.name}: nvcc {r.seconds:.2f} s -> {r.path.name}")
    for kernel, regs, spills, rest in kernel_resources(r.log):
        log(f"[build]   {kernel}: {regs} registers, spill stores/loads {spills[0]}/"
            f"{spills[1]} bytes; {rest}")
    for line in r.log.splitlines():  # anything but ptxas's resource report
        if line.strip() and not re.match(r"\s*(ptxas info|\d+ bytes stack frame)", line):
            log(f"[build]   {line.strip()}")


def phase_device() -> tuple:
    """The card's name, count and power limit; one nvcc a kernel source,
    all started at once, waiting for EARLY_KERNELS' alone. Returns the
    card line, each source's pending build and the builds' start time."""
    log(f"[device] {torch.cuda.get_device_name(0)}, count={torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    card = card_line()
    log(f"[device] nvidia-smi: {card}")
    t0 = time.perf_counter()
    names = _build.sources()
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=len(names))
    builds = {name: pool.submit(_build.build, name) for name in names}
    pool.shutdown(wait=False)
    for name in EARLY_KERNELS:
        log_build(builds[name].result())
    return card, builds, t0


def finish_builds(builds, t0) -> None:
    """Wait for every other build (phase_device) and log it."""
    for name, pending in builds.items():
        if name not in EARLY_KERNELS:
            log_build(pending.result())
    log(f"[build] {len(builds)} kernel(s) in {time.perf_counter() - t0:.2f} s wall, those "
        f"past {', '.join(EARLY_KERNELS)} alongside phases 2-4")


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
                cut = plain.rfind(">(") + 1 if ">(" in plain else plain.find("(")
                r[0] = plain[:cut] if cut > 0 else plain
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
# sweep over key tiles forward, over 128 keys backward), Tq = 64 against 65
# (the backward's; the forward's second 64-row unit), masked scores (Tk 63), d = 12 (the compile-time width) against
# 8, 16, 36 and 64 (the general widths), N odd (a block's second unit idle in
# the last round) and N above one round of the persistent grid
XATTN_EDGE_CASES = {
    "tk64_n7": (7, 64, 64, 12), "tk65": (7, 64, 65, 12), "tq65": (7, 65, 64, 12),
    "tq65_tk65": (7, 65, 65, 12), "tk63_masked": (5, 64, 63, 12), "d8": (5, 64, 64, 8),
    "d16": (5, 64, 64, 16), "d36": (5, 64, 64, 36), "d36_ragged": (3, 33, 47, 36),
    "d64": (5, 64, 64, 64), "tq130_three_units": (3, 130, 20, 12),
    "main_plus_one": (6 * N_WINDOWS + 1, 64, 64, 12),
}
# 65-128 keys (the sweep over 128 keys' backward, the sweep over key tiles'
# forward over one tile) at the shapes that reach them, from a stream of their
# own: FoG's cheap-xattn fusion at the driver's batch and at 1024, FBG's at
# its batch of 32, the symmetric 2-mod shape (WearGait's d 12) and
# --win_len 128 at d 12; then its edges: its width 8 at d 8 against 16 at
# d 9, d 64 over 128 keys, and the sweep over key tiles beyond it (129
# keys; 129 query rows, whose forward is the sweep's)
SWEEP128_XATTN_CASES = {
    "fog_batch256": (2 * 256, 101, 101, 6), "fog_batch1024": (2 * 1024, 101, 101, 6),
    "fbg_batch32": (2 * 32, 101, 101, 3), "sym_t101": (2 * 64, 101, 101, 12),
    "t128_d12": (2 * 64, 128, 128, 12), "d8_t101": (5, 101, 101, 8), "d9_t101": (5, 101, 101, 9),
    "d64_tq65_tk128": (5, 65, 128, 64), "tk129": (5, 128, 129, 12),
    "tq129_tk64": (5, 129, 64, 12),
}
# a window of 256 frames (gaitpd/cli.py's --win_len; 8.5 s at 30 Hz) at the
# published widths (enc_out_ch 12): the cheap-xattn fusion's six directed
# pairs through the sweep over key tiles, both ways
WIN256 = 256
# the sweep over key tiles (d <= 64 beyond 128 keys; backward also beyond 128
# query rows), from a stream of its own: the fusion at --win_len 256 at the
# train batch of 64 and at 1024, --win_len 129's Tq = Tk = 129 over the
# symmetric 2-mod model's two directions of 64 windows, 129 keys at N 5
# (the edge where the retired two-pass kernels lost most to SDPA); then its edges:
# 257 keys (a third tile of one key) at width 8, one query row over 300 keys,
# d 3 and 13 (4-byte copies) with query rows beyond 128, d 64 over 300 keys,
# 200 query rows against 100 keys (the backward alone)
SWEEP_LONG_XATTN_CASES = {
    "win256_batch64": (6 * 64, WIN256, WIN256, 12),
    "win256_batch1024": (6 * 1024, WIN256, WIN256, 12),
    "t129_d12": (2 * 64, 129, 129, 12), "tk129": (5, 128, 129, 12),
    "tk257_d8": (5, 65, 257, 8), "tq1_tk300": (5, 1, 300, 12), "d3_tq129_tk256": (5, 129, 256, 3),
    "d13_tq300_tk131": (5, 300, 131, 13), "d64_tk300": (3, 70, 300, 64),
    "tq200_tk100": (5, 200, 100, 12),
}
# the timed shapes, and the calls a timing there
SWEEP_LONG_TIMED = {"win256_batch64": 200, "win256_batch1024": 20, "t129_d12": 200, "tk129": 200}
# the backbone of the --win_len 256 step: three streams of 64 windows of 256
# frames at enc_out_ch 12, pooled to 8 bins
WIN256_BLOCK_SHAPE = (3 * 64, WIN256, 12, 3, 16, 8, "relu")
# one shape a variant for the launch table: the main shape (sweep_d12), then
# the main shape's N at d = 36 (sweep), at Tk = 65 (sweep_long forward,
# sweep_128 backward), at d = 96, FoG's fusion (the same at W 8), 129 keys
# and --win_len 256's shape
# (sweep_long)
CONFIG_SHAPES = {"main": (6 * N_WINDOWS, 64, 64, 12), "d36": (6 * N_WINDOWS, 64, 64, 36),
                 "tk65": (6 * N_WINDOWS, 64, 65, 12), "d96": (6 * N_WINDOWS, 64, 64, 96),
                 "fog_batch256": (2 * 256, 101, 101, 6), "tk129": (2 * 64, 128, 129, 12),
                 "win256_batch64": SWEEP_LONG_XATTN_CASES["win256_batch64"]}


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


def check_xattn_with_launches(rng, dev, card, cases=SWEEP128_XATTN_CASES) -> dict:
    """``cases`` (those of 65-128 keys by default) as in phase 5, each
    launch printed."""
    errors = check_cheap_xattn(rng, dev, card, cases)
    for name, (n, tq, tk, d) in cases.items():
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


def phase_win256(seed, dev, rng, card) -> dict:
    """The cheap-xattn fusion at --win_len 256 and its published widths: the
    backbone's kernels at the step's shape (per_frame forward, generic
    backward) against their plain versions as in phase 2, each launch
    printed; then one train step at batch 64 card vs CPU as in phase 4,
    with one launch of each cross-attention kernel (the sweep over key
    tiles, N 384 of 256 x 256 at d 12) and of the stream block's forward and
    backward."""
    bsz, t, cin, k, cout, t_out, act = WIN256_BLOCK_SHAPE
    x, w, b, g = stream_block_inputs(rng, bsz, t, cin, k, cout, dev, t_out)
    tag = f"win{WIN256}_batch64"
    errors = (hold_forward(tag, x, w, b, t_out, act), hold_backward(tag, x, w, b, g, t_out, act)[0])
    log(f"[config] {card}: stream_block {tag} (B {bsz}, T {t}, C_in {cin}): forward "
        f"{sb.forward_config(bsz, t, cin, cout, k, t_out, act)}; backward "
        f"{sb.backward_config(bsz, t, cin, cout, k, t_out, act)}")
    n, tq, tk, d = SWEEP_LONG_XATTN_CASES[tag]
    log(f"[config] {card}: cheap_xattn {tag} (N {n}, Tq {tq}, Tk {tk}, d {d}): forward "
        f"{xattn_launch(n, tq, tk, d, False)}; backward {xattn_launch(n, tq, tk, d, True)}")
    reset_launches()
    compare_one_step(f"cheap_xattn step at batch 64, win_len {WIN256}", dev,
                     lambda device: make_step_setup(seed, device, 64, "cheap_xattn",
                                                    no_dropout=True, win_len=WIN256))
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[train] cheap_xattn step at win_len {WIN256}: launches {launches}")
    want = {"cheap_xattn": 1, "cheap_xattn_backward": 1, "stream_block": 1,
            "stream_block_backward": 1}
    if any(launches[name] != v for name, v in want.items()):
        raise RuntimeError(f"win_len {WIN256} step: launches {launches}, want {want}")
    return {"launches": launches, "stream_block_errors": errors}


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


def correlated_grams(rng, n, k):
    """n Gram matrices of K task gradients around one shared direction, each
    task at its own scale over two decades: MGDA's optimum then mostly lies
    at a vertex, and its Frank-Wolfe steps reach their fixed point early."""
    base = rng.normal(size=(n, 1, 6))
    a = (base + 0.3 * rng.normal(size=(n, k, 6))) * 10.0 ** rng.uniform(-1, 1, size=(n, k, 1))
    return (a @ a.transpose(0, 2, 1)).astype(np.float32)


def check_min_norm_stop(rng, dev) -> dict:
    """MGDA's kernel on NEWTON_BATCH matrices in one launch that mix early
    and 250-step solves (half of mtl_solver_grams' law, half correlated, a
    NaN entry in one) at K = 1..8: its default design (counted) and its
    thread design by name bitwise equal to the 250-step plain version; the
    stop steps (min_norm_element_stop) hold both kinds from K = 2 on."""
    out = {}
    for k in range(1, ms.MAX_TASKS + 1):
        half = NEWTON_BATCH // 2
        grams = np.concatenate([mtl_solver_grams(rng, half, k)[:half],
                                correlated_grams(rng, NEWTON_BATCH - half, k)])
        grams[half, 0, k - 1] = np.nan
        grams = torch.from_numpy(grams).to(dev)
        before = read_launches()["min_norm_solver"]
        got = ms.min_norm_solve(grams)
        thread = ms._solve_kernel("min_norm_solver", grams, variant="thread")
        torch.cuda.synchronize()
        launched = read_launches()["min_norm_solver"] - before
        want = ms.min_norm_solve_reference(grams)
        stops = min_norm_element_stop(grams)[1].cpu().numpy()
        early, full = int((stops < 250).sum()), int((stops == 250).sum())
        same, same_thread = bitwise_rows(got, want), bitwise_rows(thread, want)
        log(f"[kernel] min_norm_solver K={k}, {NEWTON_BATCH} mixed Gram matrices in one launch "
            f"(stop steps min/median/max {stops.min()}/{np.median(stops):g}/{stops.max()}: "
            f"{early} stop early, {full} run 250 steps): bitwise equal {same}/{NEWTON_BATCH}, "
            f"the thread design by name {same_thread}/{NEWTON_BATCH}; launches {launched}")
        if same != NEWTON_BATCH or same_thread != NEWTON_BATCH or launched != 1:
            raise RuntimeError(f"min_norm_solver K={k}: the mixed batch is not bitwise equal to "
                               f"the plain version, or {launched} launches were counted")
        if k > 1 and not (early and full):
            raise RuntimeError(f"min_norm_solver K={k}: the batch does not mix early and "
                               f"250-step solves")
        config = ms.launch_config("min_norm_solver", "stop", k)
        if config["stop_every"] != min_norm_every(k):
            raise RuntimeError(f"min_norm_solver K={k}: the kernel compares every "
                               f"{config['stop_every']} steps, the plain stop every "
                               f"{min_norm_every(k)}")
        out[k] = {"early": early, "full": full}
    return out


class GramRecorder:
    """Within ``with``: keeps a copy of each Gram matrix that MGDA's combine
    (gaitpd_torch.learning.mtl) hands to min_norm_solve on the card."""

    def __init__(self):
        self.grams = []

    def __enter__(self):
        self._solve = mtl_lib.min_norm_solve

        def solve(gram):
            if gram.is_cuda:
                self.grams.append(gram.detach().clone())
            return self._solve(gram)

        mtl_lib.min_norm_solve = solve
        return self

    def __exit__(self, *exc):
        mtl_lib.min_norm_solve = self._solve


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


NEWTON_BATCH = 257  # matrices in one launch: a grid that 4 warps a block does not divide


def check_mtl_solvers(rng, dev) -> dict:
    """Each solver kernel against its plain version at K = 1..8 on seeded
    and degenerate Gram matrices, in one launch and one matrix a launch,
    then NEWTON_BATCH of them in one launch; MGDA's one-thread design by
    name on both batches: w bitwise equal (FairGrad's too: kernel and plain
    version call the same device powf); every w finite, MGDA's on the
    simplex; the launch counter up by one a launch (none for the design by
    name). Returns each solver's max abs error at
    K = 3 (FairGrad's at its default alpha 1)."""
    errors = {}
    for k in range(1, ms.MAX_TASKS + 1):
        raw = torch.from_numpy(mtl_solver_grams(rng, 12, k)).to(dev)
        n_degenerate = len(raw) - 12
        raw_batch = torch.from_numpy(
            mtl_solver_grams(rng, NEWTON_BATCH - n_degenerate, k)).to(dev)
        for label, run, plain, counter, prep, simplex in mtl_solver_calls():
            grams, batch = prep(raw), prep(raw_batch)
            before = read_launches()[counter]
            got = run(grams)
            alone = [run(g) for g in grams]
            got_batch = run(batch)
            torch.cuda.synchronize()
            launched = read_launches()[counter] - before
            want, want_batch = plain(grams), plain(batch)
            same = bitwise_rows(got, want)
            same_alone = sum(bool(torch.equal(a.view(torch.int32), w.view(torch.int32)))
                             for a, w in zip(alone, want))
            same_batch = bitwise_rows(got_batch, want_batch)
            err = (got - want).abs().max().item()
            finite = bool(torch.isfinite(got).all() and torch.isfinite(want).all())
            # the seeded batch may hold problems whose w the plain version
            # leaves non-finite too (FairGrad at alpha 2, K 7): bitwise
            # equality holds those
            batch_nonfinite = int((~torch.isfinite(want_batch)).any(-1).sum())
            on_simplex = (not simplex) or all(
                bool((t >= 0).all()) and (t.sum(-1) - 1).abs().max().item() <= 1e-5
                for t in (got, got_batch[torch.isfinite(want_batch).all(-1)]))
            n = len(grams)
            thread = ""
            if counter == "min_norm_solver":  # MGDA's one-thread design, by name
                by_name = [ms._solve_kernel(counter, t, variant="thread") for t in (grams, batch)]
                torch.cuda.synchronize()
                same_thread = (bitwise_rows(by_name[0], want),
                               bitwise_rows(by_name[1], want_batch))
                thread = (f"; the thread design by name {same_thread[0]}/{n} and "
                          f"{same_thread[1]}/{NEWTON_BATCH}")
                if same_thread != (n, NEWTON_BATCH):
                    raise RuntimeError(f"{label} K={k}: the thread design is not bitwise equal "
                                       f"to the plain version")
            log(f"[kernel] {label} K={k}, {n} Gram matrices ({n - 12} degenerate): bitwise "
                f"equal {same}/{n} in one launch, {same_alone}/{n} one matrix a launch, "
                f"{same_batch}/{NEWTON_BATCH} in one launch of {NEWTON_BATCH} (non-finite in "
                f"the plain version: {batch_nonfinite}); max abs "
                f"err {err:.3e}; finite {finite}" + (f"; on the simplex {on_simplex}"
                                                     if simplex else "")
                + f"; launches {launched}" + thread)
            if launched != 2 + n:
                raise RuntimeError(f"{label} K={k}: {launched} launches counted, want {2 + n}")
            if not (finite and on_simplex):
                raise RuntimeError(f"{label} K={k}: w not finite or off the simplex")
            if same != n or same_alone != n or same_batch != NEWTON_BATCH:
                raise RuntimeError(f"{label} K={k}: w not bitwise equal to the plain version's "
                                   f"(max abs err {err:.3e})")
            if k == 3 and (counter not in errors or "alpha=1.0" in label):
                errors[counter] = err
    return errors


def bitwise_rows(got: torch.Tensor, want: torch.Tensor) -> int:
    """Rows of w whose bits all equal the plain version's."""
    return int((got.view(torch.int32) == want.view(torch.int32)).all(-1).sum())


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
    and run_cv card vs CPU (sync 1 epoch; async 1 for FAMO
    and MGDA), 3
    stream-block backward launches and one launch of the method's own solver
    a step; the 3 drawing methods' run_cv on the card alone (sync 1 epoch)
    and their draws' laws; each method's host synchronisations a step."""
    solver_errors = check_mtl_solvers(rng, dev)
    stop_mix = check_min_norm_stop(np.random.default_rng([seed, 22]), dev)
    syncs = check_step_syncs(seed, dev)
    runs = {}
    training_grams = []  # those of the MGDA and LOG_MGDA sync runs on the card
    for method in DRAWLESS_METHODS:
        check_one_step(seed, dev, mtl_method=method)
        modes = (("sync", 1), ("async", 1)) if method in ("famo", "mgda") else (("sync", 1),)
        per_step = {"stream_block_backward": 3, "stream_block_wide": 0,
                    "stream_block_backward_wide": 0, **solver_per_step(method)}
        own = METHOD_SOLVER.get(method)
        runs[method] = {}
        for mode in modes:
            with GramRecorder() as rec:
                runs[method].update(compare_run_cv(
                    method, dict(train_common(seed), mtl_method=method), (mode,), per_step,
                    ("stream_block",) + ((own,) if own else ())))
            if own == "min_norm_solver" and mode[0] == "sync":
                training_grams += rec.grams
    for method in DRAWING_METHODS:
        per_step = {"stream_block_backward": 3, **solver_per_step(method)}
        runs[method] = card_only_run_cv(method, dict(train_common(seed), mtl_method=method),
                                        (("sync", 1),), per_step=per_step)
    check_draws_on_card(dev)
    return {"solver_errors": solver_errors, "syncs": syncs, "runs": runs,
            "stop_mix": stop_mix, "training_grams": training_grams}


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
# sweep over key tiles forward, over 128 keys backward): FoG's d = 6 at the driver's batch and at 1024, FBG's
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
    """The cheap cross-attention (65-128 keys) and the stream block at
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
    for attempt in range(3):  # the profiler has come back without device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
        if us > 0:
            break
        log(f"[time] the profiler recorded no device time (attempt {attempt + 1})")
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
    call; then at the train steps' batches (64, 3 x 64)."""
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

    return out


# the wide variants' thresholds: every C_in from just above warp_tile's 16
# to just below the old threshold 64, at TILE_SIZES
WIDE_THRESHOLD_CINS = tuple(range(17, 64))
WIDE_THRESHOLD_BATCH = 1024


def time_wide_threshold(rng, dev, card) -> dict:
    """The wide forward and backward against what the wrapper takes without
    them (per_frame, warp_tile at C_in 36; the generic backward) at every C_in
    of WIDE_THRESHOLD_CINS, batch 1024 at TILE_SIZES, ReLU and GELU: device
    ms from a CUDA graph of 50 calls, in turns (wide, other, wide, other).
    Prints for each direction the least C_in from which wide is no slower at
    every larger C_in under both activations (the smaller of each design's
    two readings), beside the wrapper's constants."""
    t, cout, k, t_out = sb.TILE_SIZES
    out = {}
    for cin in WIDE_THRESHOLD_CINS:
        x, w, b, g = focal_block_inputs(rng, WIDE_THRESHOLD_BATCH, t, cin, k, cout, dev, t_out)
        other = sb.WARP_TILE if cin in sb.TILE_CIN else sb.PER_FRAME
        for act in ("relu", "gelu"):
            fwd = {v: (lambda v=v: sb._forward_kernel(x, w, b, t_out, act, v))
                   for v in (sb.WIDE, other)}
            bwd = {v: (lambda v=v: sb._backward_kernel(x, w, b, g, t_out, act, v))
                   for v in (sb.BWD_WIDE, sb.BWD_GENERIC)}
            row = {}
            with torch.inference_mode():
                turns = [time_cuda_graph(fwd[v], warmup=5, reps=50)
                         for v in (sb.WIDE, other, sb.WIDE, other)]
            row["forward"] = {"wide": turns[0::2], sb.VARIANT_NAMES[other]: turns[1::2]}
            turns = [time_cuda_graph(bwd[v], warmup=5, reps=50)
                     for v in (sb.BWD_WIDE, sb.BWD_GENERIC, sb.BWD_WIDE, sb.BWD_GENERIC)]
            row["backward"] = {"wide": turns[0::2], "generic": turns[1::2]}
            out[f"{cin} {act}"] = row
            log(f"[time] {card}: stream_block threshold x({WIDE_THRESHOLD_BATCH},{t},{cin}) "
                f"{act}, graph ms in turns: forward wide {row['forward']['wide']} "
                f"{sb.VARIANT_NAMES[other]} {row['forward'][sb.VARIANT_NAMES[other]]}; backward "
                f"wide {row['backward']['wide']} generic {row['backward']['generic']}")

    def no_slower(row):  # {"wide": [ms, ms], other: [ms, ms]}
        return min(row["wide"]) <= min(v for name, ms_ in row.items() if name != "wide"
                                       for v in ms_)

    found = {}
    for way in ("forward", "backward"):
        wins = {cin: all(no_slower(out[f"{cin} {act}"][way]) for act in ("relu", "gelu"))
                for cin in WIDE_THRESHOLD_CINS if not (way == "forward" and cin in sb.TILE_CIN)}
        least = 64
        for cin in sorted(wins, reverse=True):
            if not wins[cin]:
                break
            least = cin
        found[way] = least
    log(f"[time] {card}: stream_block wide thresholds read (least C_in in "
        f"{WIDE_THRESHOLD_CINS[0]}..{WIDE_THRESHOLD_CINS[-1]} from which wide is no slower "
        f"under both activations): forward {found['forward']}, backward {found['backward']}; "
        f"the wrapper's: {sb.WIDE_MIN_CIN} both ways")
    out["thresholds_read"] = found
    return out


def cheap_xattn_bound(n, tq, tk, d):
    """Read A and B once, write O once; two products of 2*N*Tq*Tk*d FLOP."""
    return _bound(4 * n * d * (2 * tq + tk), 2 * 2 * n * tq * tk * d)


def cheap_xattn_backward_bound(n, tq, tk, d):
    """Read A, B, dO once, write dA, dB once; five products (S, dP, dA, and
    dB's two), each 2*N*Tq*Tk*d FLOP."""
    return _bound(4 * n * d * (3 * tq + 2 * tk), 5 * 2 * n * tq * tk * d)


def time_cheap_xattn(rng, dev, card, shape=XATTN_CASES["main"], reps=200) -> dict:
    """The cross-attention's forward and backward at ``shape``: kernel,
    plain version, library call (scaled_dot_product_attention and its
    autograd) and bound, eager and each replayed from a CUDA graph, the
    device's time without the host's; ``reps`` calls a timing (a quarter of
    them for the plain backward and the library's; warm-up a tenth)."""
    n, tq, tk, d = shape
    a, b, g = xattn_inputs(rng, n, tq, tk, d, dev)
    few = dict(warmup=max(2, reps // 10), reps=reps)
    fewer = dict(warmup=max(2, reps // 40), reps=max(5, reps // 4))

    def library():  # its default scale is 1/sqrt(d): the same function
        return F.scaled_dot_product_attention(a, b, b)

    lib_err = (library() - cx.cheap_xattn_reference(a, b)).abs().max().item()
    if lib_err > (KERNEL_TOL if tk <= 64 else XATTN_LONG_ATOL):
        raise RuntimeError(f"library yardstick computes another function: {lib_err}")
    with torch.inference_mode():
        plain_ms = time_cuda(lambda: cx.cheap_xattn_reference(a, b), **few)
        kernel_ms = time_cuda(lambda: cx.cheap_xattn(a, b), **few)
        kernel_ms_2 = time_cuda(lambda: cx.cheap_xattn(a, b), **few)
        plain_ms_2 = time_cuda(lambda: cx.cheap_xattn_reference(a, b), **few)
        library_ms = time_cuda(library, **few)
        graph = {"graph_ms": time_cuda_graph(lambda: cx.cheap_xattn(a, b), **few),
                 "library_graph_ms": time_cuda_graph(library, **few),
                 "plain_graph_ms": time_cuda_graph(lambda: cx.cheap_xattn_reference(a, b),
                                                   **few)}
    bound_ms, bound_by = cheap_xattn_bound(n, tq, tk, d)
    variant = cx.VARIANT_NAMES[cx._variant(tq, tk, d)]
    log(f"[time] {card}: cheap_xattn N {n}, Tq {tq}, Tk {tk}, d {d} (variant {variant}): kernel "
        f"{kernel_ms:.4f}/{kernel_ms_2:.4f} ms, plain {plain_ms:.4f}/{plain_ms_2:.4f} ms, "
        f"library scaled_dot_product_attention {library_ms:.4f} ms (max abs diff "
        f"{lib_err:.2e}), bound {bound_ms:.5f} ms ({bound_by})"
        f"; from a CUDA graph (device only): kernel {graph['graph_ms']:.4f} ms, library "
        f"{graph['library_graph_ms']:.4f} ms, plain {graph['plain_graph_ms']:.4f} ms")

    leaves = [t.detach().clone().requires_grad_() for t in (a, b)]

    def library_backward():
        out = F.scaled_dot_product_attention(leaves[0], leaves[1], leaves[1])
        return torch.autograd.grad(out, leaves, g)

    want = cx.cheap_xattn_backward_reference(a, b, g)
    lib_b_err = max((p - q).abs().max().item() for p, q in zip(library_backward(), want))
    if lib_b_err > XATTN_GRAD_ATOL + XATTN_GRAD_RTOL * max(q.abs().max().item() for q in want):
        raise RuntimeError(f"library backward computes another function: {lib_b_err}")
    bwd_plain = time_cuda(lambda: cx.cheap_xattn_backward_reference(a, b, g), **fewer)
    bwd_kernel = time_cuda(lambda: cx.cheap_xattn_backward(a, b, g), **few)
    bwd_kernel_2 = time_cuda(lambda: cx.cheap_xattn_backward(a, b, g), **few)
    bwd_plain_2 = time_cuda(lambda: cx.cheap_xattn_backward_reference(a, b, g), **fewer)
    bwd_library = time_cuda(library_backward, **fewer)
    bwd_graph = {"graph_ms": time_cuda_graph(lambda: cx.cheap_xattn_backward(a, b, g), **few),
                 "library_graph_ms": time_cuda_graph(library_backward, **fewer)}
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
        f"library {bwd_graph['library_graph_ms']:.4f} ms")
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


def mtl_solver_resources() -> dict:
    """Registers and spills of each solver kernel at K = 3, from nvcc's
    -Xptxas -v lines: {kernel name: (registers, (spill stores, loads))}."""
    rows = kernel_resources(_build.build("mtl_solvers").log)
    return {name: (regs, spills) for name, regs, spills, _ in rows
            if "<3, " in name or "ILi3E" in name}


def graph_turns(new, old, reps=100) -> list:
    """Device ms a call of `new` and of `old` from CUDA graphs of `reps`
    calls, in turns: new, old, new, old."""
    return [time_cuda_graph(fn, reps=reps) for fn in (new, old, new, old)]


def time_min_norm_cases(dev, card, gram, worst_rng, training_grams) -> dict:
    """MGDA's kernel beside its thread design by name, from CUDA graphs in
    turns, on two more cases than the main path's matrix: the worst case
    (the first of mtl_solver_grams(worst_rng, 12, 3) that runs all 250
    steps) and the Gram matrices that phase 5f's MGDA and LOG_MGDA sync runs
    handed to the solver on the card (their solves' summed device time,
    one launch a matrix, as in training), with each case's stop steps."""
    out = {"stop_step": int(min_norm_element_stop(gram)[1])}
    worst_set = torch.from_numpy(mtl_solver_grams(worst_rng, 12, 3)).to(dev)
    stops = min_norm_element_stop(worst_set)[1].tolist()
    if ms.MIN_NORM_STEPS not in stops:
        raise RuntimeError(f"min_norm_solver: no seeded matrix runs all 250 steps ({stops})")
    worst = worst_set[stops.index(ms.MIN_NORM_STEPS)]
    graph = graph_turns(lambda: ms.min_norm_solve(worst),
                        lambda: ms._solve_kernel("min_norm_solver", worst, variant="thread"))
    out["worst_case"] = {"matrix": stops.index(ms.MIN_NORM_STEPS), "graph_turns": graph,
                         "graph_ms": min(graph[0], graph[2]),
                         "thread_graph_ms": min(graph[1], graph[3])}
    log(f"[time] {card}: min_norm_solver K=3, the worst case (matrix "
        f"{out['worst_case']['matrix']} of 12, 250 steps): from a CUDA graph in turns "
        f"new/thread/new/thread {graph[0]:.4f}/{graph[1]:.4f}/{graph[2]:.4f}/{graph[3]:.4f} ms")
    if not training_grams:
        raise RuntimeError("min_norm_solver: no Gram matrix was recorded from MGDA's training")
    train_stops = np.array([int(min_norm_element_stop(g)[1]) for g in training_grams])
    graph = graph_turns(lambda: [ms.min_norm_solve(g) for g in training_grams],
                        lambda: [ms._solve_kernel("min_norm_solver", g, variant="thread")
                                 for g in training_grams], reps=20)
    out["training"] = {"matrices": len(training_grams), "k": training_grams[0].shape[-1],
                       "stop_steps": train_stops.tolist(), "graph_turns": graph,
                       "graph_ms": min(graph[0], graph[2]),
                       "thread_graph_ms": min(graph[1], graph[3])}
    log(f"[time] {card}: min_norm_solver on the {len(training_grams)} Gram matrices (K = "
        f"{out['training']['k']}) of phase 5f's MGDA and LOG_MGDA sync runs: stop steps min/"
        f"median/max {train_stops.min()}/{np.median(train_stops):g}/{train_stops.max()} "
        f"({train_stops.tolist()}); summed device ms of their solves, one launch a matrix, "
        f"from a CUDA graph in turns new/thread/new/thread {graph[0]:.4f}/{graph[1]:.4f}/"
        f"{graph[2]:.4f}/{graph[3]:.4f}")
    return out


def time_mtl_solvers(rng, dev, card, worst_rng, training_grams) -> dict:
    """Each solver kernel at the main path's shape (K = 3, one matrix, a
    step's launch) beside its plain version on the card and its bound:
    eager, device time under the profiler and from a CUDA graph, with each
    design's launch (threads a block, lanes a matrix, registers and
    spills); MGDA's beside its one-thread design by name in the same call,
    in turns (new, thread, new, thread), and on time_min_norm_cases'
    cases."""
    raw = torch.from_numpy(mtl_solver_grams(rng, 1, 3)[0]).to(dev)
    resources = mtl_solver_resources()
    for name, (regs, spills) in sorted(resources.items()):
        log(f"[config] {card}: {name}: {regs} registers, spill stores/loads {spills[0]}/"
            f"{spills[1]} bytes")
    for name in MTL_SOLVER_NAMES:
        for variant in ms.designs(name):
            log(f"[config] {card}: {name}, {variant} design: "
                f"{[ms.launch_config(name, variant, k) for k in (3, 8)]}")
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
        entry = {"ms": min(kernel_ms, kernel_ms_2), "plain_ms": plain_ms,
                 "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
                 "device_ms": dev_ms}
        if name == "min_norm_solver":
            def thread():
                return ms._solve_kernel(name, gram, variant="thread")

            graph = graph_turns(lambda: run(gram), thread)
            entry.update(graph_ms=min(graph[0], graph[2]),
                         thread_graph_ms=min(graph[1], graph[3]),
                         thread_ms=time_cuda(thread, warmup=10, reps=200),
                         thread_device_ms=device_ms(thread))
            turns = (f"; from a CUDA graph in turns new/thread/new/thread {graph[0]:.4f}/"
                     f"{graph[1]:.4f}/{graph[2]:.4f}/{graph[3]:.4f} ms; the thread design "
                     f"eager {entry['thread_ms']:.4f} ms, device "
                     f"{entry['thread_device_ms']:.4f} ms under the profiler")
            entry.update(time_min_norm_cases(dev, card, gram, worst_rng, training_grams))
            turns += f"; the matrix stops at step {entry['stop_step']}"
        else:
            entry["graph_ms"] = time_cuda_graph(lambda: run(gram), reps=100)
            turns = f"; from a CUDA graph {entry['graph_ms']:.4f} ms"
        log(f"[time] {card}: {name} K=3 (one Gram matrix): kernel {kernel_ms:.4f}/"
            f"{kernel_ms_2:.4f} ms eager (device {dev_ms:.4f} ms under the profiler), plain "
            f"(eager torch on the card, 3 calls) {plain_ms:.2f} ms, bound {bound_ms:.3e} ms "
            f"({bound_by}: {ops} f32 operations)" + turns)
        out[name] = entry
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
                    recipe=False, remat="none", sharding=None, **widths):
    """A flagship model with its SGD and ``mtl_method`` step (CAGrad at
    c = 0.5 by default), or a baseline with SGD on the mean of its branch
    losses (sync; DeepAV-Lite and TACA with their dropout, or at rate 0 with
    ``no_dropout``), one card-resident batch of ``bsz`` window tuples, and
    the step's generator. With ``recipe`` the step augments and drops
    modalities as RECIPE sets them; ``remat`` is StepSettings.remat,
    ``sharding`` make_train_step's; ``widths`` sets WearGaitArgs' sizes
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
                            modality_dropout=args.modality_dropout, augment=aug_specs,
                            remat=remat)
    if baseline is None:
        kwargs = {"c": 0.5} if mtl_method in ("cagrad", "log_cagrad") else {}
        mtl = make_method(mtl_method, 3, **kwargs)
        step = make_train_step(settings, mtl, build_flat_partition(
            model, model.shared_modules, model.task_modules), sharding=sharding)
        mtl_state = mtl.init_state(dev)
    else:
        step = make_train_step(settings, train_apply=wg.baseline_adapters(args)[0],
                               sharding=sharding)
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


def time_train_step(seed, dev, card, baseline=None, mtl_method="cagrad", recipe=False,
                    **widths) -> dict:
    """One train step at each of TRAIN_BATCHES: host clock around 20
    synchronised steps after 3; ``widths`` as make_step_setup takes them."""
    out = {}
    label = baseline or ("CAGrad" if mtl_method == "cagrad" else mtl_method)
    label += " recipe" if recipe else ""
    label += "".join(f", {k} {v}" for k, v in widths.items())
    for bsz in TRAIN_BATCHES:
        step, state, ctx, batch, gen = make_step_setup(seed, dev, bsz, baseline,
                                                       mtl_method=mtl_method, recipe=recipe,
                                                       **widths)
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
            for _ in range(PROFILE_REPS):
                step(state, batch, gen, ctx)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        out[f"batch{bsz}"] = {
            "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3 / PROFILE_REPS,
            "kernels": sum(e.count for e in kernels) / PROFILE_REPS,
            "wall_ms_profiled": wall_ms / PROFILE_REPS}
        if bsz == FF_BATCH:
            profile_table(prof, f"{PROFILE_REPS} x {label} train step batch {bsz}", wall_ms, card)
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
            for _ in range(PROFILE_REPS):
                step(state, batch, gen, ctx)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        runs[label].append((sum(e.self_device_time_total for e in kernels) / 1e3 / PROFILE_REPS,
                            sum(e.count for e in kernels) / PROFILE_REPS))
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
    """Device time by kernel over PROFILE_REPS batch-1024 predict_windows
    calls, CAGrad train steps and cheap-xattn train steps."""
    from torch.profiler import ProfilerActivity, profile

    batch = {m: np.random.default_rng(0).normal(size=(N_WINDOWS, WIN, c)).astype(np.float32)
             for m, c in CHANNELS.items()}
    engine.predict_windows(batch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_REPS):
            engine.predict_windows(batch)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    profile_table(prof, f"{PROFILE_REPS} x predict_windows batch {N_WINDOWS}", wall_ms, card)

    step, state, ctx, tbatch, _ = make_step_setup(seed, dev, 1024)
    step(state, tbatch, None, ctx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_REPS):
            step(state, tbatch, None, ctx)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    profile_table(prof, f"{PROFILE_REPS} x CAGrad train step batch 1024", wall_ms, card)

    step, state, ctx, tbatch, _ = make_step_setup(seed, dev, 1024, "cheap_xattn")
    step(state, tbatch, None, ctx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_REPS):
            step(state, tbatch, None, ctx)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    profile_table(prof, f"{PROFILE_REPS} x cheap_xattn train step batch 1024", wall_ms, card)


def phase_sota_profiles(seed, dev, card) -> None:
    """Device time by kernel over PROFILE_REPS batch-1024 train steps of
    each SOTA baseline, at its dropout."""
    from torch.profiler import ProfilerActivity, profile

    for baseline in wg.SOTA_BASELINES:
        step, state, ctx, tbatch, gen = make_step_setup(seed, dev, 1024, baseline)
        step(state, tbatch, gen, ctx)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_REPS):
                step(state, tbatch, gen, ctx)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        profile_table(prof, f"{PROFILE_REPS} x {baseline} train step batch 1024", wall_ms, card)


# ---------------------------------------------------------------------------
# 7. the CLI and WearGait's folds in one step (--vmap_folds)
# ---------------------------------------------------------------------------

VMAP_FOLDS = 10
VMAP_CV = dict(n_folds=VMAP_FOLDS, test_per_class=8)  # the CLI's defaults
# the runs held against sequential ones but phase 9's: the CLI's splits,
# their first 4 folds (the timed steps keep all 10)
VMAP_RUN_FOLDS = 4
VMAP_RUN_CV = dict(VMAP_CV, n_folds_cap=VMAP_RUN_FOLDS)
# (F, B a fold, T, C_in, K, C_out, t_out, act) of the fold-stacked stream
# block: the flagship's (3 streams x 64 windows a fold), the fusion's at
# --enc_out_ch 96 (wide) and the flagship's at --win_len 101 (per_frame)
FOLD_SHAPES = {
    "flagship": (VMAP_FOLDS, 3 * 64, 64, 12, 3, 16, 8, "relu"),
    "enc_out_ch96": (VMAP_FOLDS, 3 * 64, 64, 96, 3, 16, 8, "relu"),
    "win_len101": (VMAP_FOLDS, 3 * 64, 101, 12, 3, 16, 8, "relu"),
}


def fold_inputs(rng, folds, bsz, t, cin, k, cout, dev, t_out):
    """x (F·B, T, C_in), w (F, K, C_in, C_out), b (F, C_out), g (F·B, t_out,
    C_out): each fold's drawn as stream_block_inputs draws one."""
    parts = [stream_block_inputs(rng, bsz, t, cin, k, cout, dev, t_out) for _ in range(folds)]
    return (torch.cat([p[0] for p in parts]), torch.stack([p[1] for p in parts]),
            torch.stack([p[2] for p in parts]), torch.cat([p[3] for p in parts]))


def relu_kink_rows(x, w, b, act, folds) -> torch.Tensor:
    """The windows whose pre-activation lies within two f32 rounding units
    of 0 under ReLU (in f64 on the CPU), where the kernel and the plain
    version may take ReLU' on either side, both right: a bool (F·B,)."""
    kink = torch.zeros(x.shape[0], dtype=torch.bool)
    if act != "relu":
        return kink
    xd, wd, bd = (v.detach().double().cpu() for v in (x, w, b))
    k, t = wd.shape[1], xd.shape[1]
    xs = F.pad(xd, (0, 0, k // 2, k // 2)).reshape(folds, -1, t + k - 1, xd.shape[2])
    z = bd[:, None, None, :].expand(folds, xs.shape[1], t, bd.shape[1]).clone()
    terms = z.abs()
    for i in range(k):
        z += xs[:, :, i:i + t] @ wd[:, i][:, None]
        terms += xs[:, :, i:i + t].abs() @ wd[:, i][:, None].abs()
    near = z.abs() <= 2 * np.finfo(np.float32).eps * terms
    return near.reshape(x.shape[0], -1).any(1)


def check_fold_kernels(rng, dev, card, shapes=FOLD_SHAPES) -> dict:
    """The fold-stacked forward and backward at ``shapes``: one launch each
    way for all folds; each fold's output and gradients bitwise equal to a
    launch of that fold alone; against the plain version
    (stream_block_folds_reference) within KERNEL_TOL (gw, gb of their
    largest value), the ReLU kink windows' cotangents set to 0 in both;
    each launch's config beside the single fold's."""
    errors = {}
    for name, (folds, bsz, t, cin, k, cout, t_out, act) in shapes.items():
        x, w, b, g = fold_inputs(rng, folds, bsz, t, cin, k, cout, dev, t_out)
        before = (sb.fold_launches, sb.fold_backward_launches)
        out = sb.stream_block_folds(x, w, b, t_out, act)
        grads = sb.stream_block_folds_backward(x, w, b, g, t_out, act)
        torch.cuda.synchronize()
        if (sb.fold_launches, sb.fold_backward_launches) != (before[0] + 1, before[1] + 1):
            raise RuntimeError(f"stream_block_folds[{name}]: not one launch each way")
        same_fwd = same_bwd = True
        for f in range(folds):
            rows = slice(f * bsz, (f + 1) * bsz)
            same_fwd &= torch.equal(out[rows], sb.stream_block(x[rows], w[f], b[f], t_out, act))
            single = sb.stream_block_backward(x[rows], w[f], b[f], g[rows], t_out, act)
            same_bwd &= all(torch.equal(a, c) for a, c in
                            zip((grads[0][rows], grads[1][f], grads[2][f]), single))
        err = (out - sb.stream_block_folds_reference(x, w, b, t_out, act)).abs().max().item()
        kinks = relu_kink_rows(x, w, b, act, folds).to(dev)
        g_safe = torch.where(kinks[:, None, None], torch.zeros_like(g), g)
        got = sb.stream_block_folds_backward(x, w, b, g_safe, t_out, act)
        want = sb.stream_block_folds_backward_reference(x, w, b, g_safe, t_out, act)
        errs = [(a - c).abs().max().item() for a, c in zip(got, want)]
        tols = [KERNEL_TOL] + [KERNEL_TOL * max(1.0, c.abs().max().item()) for c in want[1:]]
        fwd_cfg = sb.forward_config(bsz, t, cin, cout, k, t_out, act, folds=folds)
        bwd_cfg = sb.backward_config(bsz, t, cin, cout, k, t_out, act, folds=folds)
        log(f"[kernel] stream_block_folds {name}: {folds} folds x{(folds * bsz, t, cin)} "
            f"w{tuple(w.shape)} {act} (variant {fwd_cfg['variant']}): forward max abs err "
            f"{err:.3e} (tol {KERNEL_TOL}); each fold bitwise equal to its own launch: "
            f"{same_fwd}; backward (variant {bwd_cfg['variant']}) gx/gw/gb max abs err "
            f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (tol {tols[0]:.1e}/{tols[1]:.2e}/"
            f"{tols[2]:.2e}; {int(kinks.sum())} ReLU kink window(s) left out), each fold "
            f"bitwise equal to its own launch: {same_bwd}")
        log(f"[config] stream_block_folds {name}: forward {fwd_cfg}; backward {bwd_cfg}; one "
            f"fold's forward {sb.forward_config(bsz, t, cin, cout, k, t_out, act)}")
        if not (np.isfinite(err) and err <= KERNEL_TOL
                and all(np.isfinite(e) and e <= tol for e, tol in zip(errs, tols))):
            raise RuntimeError(f"stream_block_folds[{name}] disagrees with its plain version: "
                               f"{err}, {errs}")
        if not (same_fwd and same_bwd):
            raise RuntimeError(f"stream_block_folds[{name}]: a fold differs from its own launch")
        errors[name] = (err, max(errs))
    return errors


def fold_block_bound(folds, bsz, t, cin, k, cout, t_out, backward=False):
    """The fold-stacked block's bound: F·B windows and F weight sets, read or
    written once; the backward also writes gx, gw, gb once and recomputes z,
    then gx and gw (stream_block_backward_bound's count)."""
    n = folds * bsz
    if backward:
        moved = 4 * (2 * n * t * cin + 2 * folds * (k * cin * cout + cout) + n * t_out * cout)
        flop = 3 * 2 * n * t * cin * cout * k + 4 * n * t * cout
    else:
        moved = 4 * (n * t * cin + folds * (k * cin * cout + cout) + n * t_out * cout)
        flop = 2 * n * t * cin * cout * k
    return _bound(moved, flop)


def time_fold_block(rng, dev, card, shape=FOLD_SHAPES["flagship"]) -> dict:
    """The fold-stacked forward and backward at a ReLU fold ``shape`` (the
    flagship's by default): eager and from a CUDA graph, beside the plain
    version, the library call (one grouped F.conv1d + ReLU +
    F.adaptive_avg_pool1d over the folds' channels; the port never calls
    it) and the bound."""
    folds, bsz, t, cin, k, cout, t_out, act = shape
    x, w, b, g = fold_inputs(rng, folds, bsz, t, cin, k, cout, dev, t_out)
    xg = x.reshape(folds, bsz, t, cin).permute(1, 0, 3, 2).reshape(bsz, folds * cin, t)
    wg_ = w.permute(0, 3, 2, 1).reshape(folds * cout, cin, k).contiguous()

    def library(xl=xg, wl=wg_, bl=b):
        y = torch.relu(F.conv1d(xl, wl, bl.reshape(-1), padding=k // 2, groups=folds))
        pooled = F.adaptive_avg_pool1d(y, t_out)  # (B, F·C_out, t_out)
        return pooled.reshape(bsz, folds, cout, t_out).permute(1, 0, 3, 2).reshape(-1, t_out,
                                                                                  cout)

    want = sb.stream_block_folds_reference(x, w, b, t_out, act)
    lib_err = (library() - want).abs().max().item()
    if lib_err > KERNEL_TOL:
        raise RuntimeError(f"fold library yardstick computes another function: {lib_err}")

    def kernel():
        return sb.stream_block_folds(x, w, b, t_out, act)

    def plain():
        return sb.stream_block_folds_reference(x, w, b, t_out, act)

    with torch.inference_mode():
        fwd = {"kernel": time_cuda(kernel), "plain": time_cuda(plain, warmup=5, reps=50),
               "kernel_2": time_cuda(kernel), "library": time_cuda(library),
               "graph": time_cuda_graph(kernel), "library_graph": time_cuda_graph(library),
               "graph_2": time_cuda_graph(kernel)}
    leaves = [v.detach().clone().requires_grad_() for v in (xg, wg_, b)]

    def library_backward():
        return torch.autograd.grad(library(*leaves), leaves, g)

    def kernel_backward():
        return sb.stream_block_folds_backward(x, w, b, g, t_out, act)

    def plain_backward():
        return sb.stream_block_folds_backward_reference(x, w, b, g, t_out, act)

    bwd = {"kernel": time_cuda(kernel_backward),
           "plain": time_cuda(plain_backward, warmup=3, reps=10),
           "kernel_2": time_cuda(kernel_backward),
           "library": time_cuda(library_backward, warmup=5, reps=50),
           "graph": time_cuda_graph(kernel_backward)}
    bound = fold_block_bound(folds, bsz, t, cin, k, cout, t_out)
    bwd_bound = fold_block_bound(folds, bsz, t, cin, k, cout, t_out, backward=True)
    log(f"[time] {card}: stream_block_folds {folds} folds x({folds * bsz},{t},{cin}) k{k} -> "
        f"({folds * bsz},{t_out},{cout}): eager kernel {fwd['kernel']:.4f}/{fwd['kernel_2']:.4f} "
        f"ms, plain {fwd['plain']:.4f} ms, library (grouped conv1d+relu+pool) "
        f"{fwd['library']:.4f} ms; from a CUDA graph kernel {fwd['graph']:.4f}/"
        f"{fwd['graph_2']:.4f} ms, library {fwd['library_graph']:.4f} ms; bound "
        f"{bound[0]:.5f} ms ({bound[1]}); backward: kernel {bwd['kernel']:.4f}/"
        f"{bwd['kernel_2']:.4f} ms, plain {bwd['plain']:.4f} ms, library (autograd, forward "
        f"included) {bwd['library']:.4f} ms, graph {bwd['graph']:.4f} ms; bound "
        f"{bwd_bound[0]:.5f} ms ({bwd_bound[1]})")
    return {
        "stream_block_folds": {
            "ms": min(fwd["kernel"], fwd["kernel_2"]), "plain_ms": fwd["plain"],
            "library_ms": fwd["library"], "bound_ms": bound[0], "bound_by": bound[1],
            "graph_ms": min(fwd["graph"], fwd["graph_2"]),
            "library_graph_ms": fwd["library_graph"], "folds": folds},
        "stream_block_backward_folds": {
            "ms": min(bwd["kernel"], bwd["kernel_2"]), "plain_ms": bwd["plain"],
            "library_ms": bwd["library"], "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
            "graph_ms": bwd["graph"], "folds": folds},
    }


class VmapStepCounter:
    """Counts the stacked runner's train steps and eval forwards while
    installed (VmapEpochRunner's methods wrapped, then put back)."""

    def __enter__(self):
        self.steps = self.evals = 0
        self._train, self._eval = vc.VmapEpochRunner.train_step, vc.VmapEpochRunner.eval_step_folds
        counter = self

        def train_step(runner, *a, **k):
            counter.steps += 1
            return counter._train(runner, *a, **k)

        def eval_step_folds(runner, *a, **k):
            counter.evals += 1
            return counter._eval(runner, *a, **k)

        vc.VmapEpochRunner.train_step = train_step
        vc.VmapEpochRunner.eval_step_folds = eval_step_folds
        return self

    def __exit__(self, *exc):
        vc.VmapEpochRunner.train_step = self._train
        vc.VmapEpochRunner.eval_step_folds = self._eval


def sequential_folds(args, perturb=0.0, generators=None) -> tuple:
    """run_cv on ``args``: per fold, its per-epoch train losses and its
    (best macro, per-mod accuracies, 7-subset scores); and the seconds.
    With ``perturb``, each fold's initial parameters are scaled by
    1 + perturb N(0, 1) (a draw of its own a fold). A ``generators`` list
    receives each fold's torch.Generator, in fold order."""
    losses, results = {}, []
    run_fold, init, run_eval = wg.run_fold, wg.init_train_state, wg.run_eval_epoch
    gen = torch.Generator().manual_seed(7)

    def eval_epoch(runner, state, data, bsz, generator, *a, **k):
        if generators is not None and (not generators or generators[-1] is not generator):
            generators.append(generator)
        return run_eval(runner, state, data, bsz, generator, *a, **k)

    def keep(*a, **k):
        out = run_fold(*a, **k)
        results.append(out)
        return out

    def perturbed(model, *a, **k):
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.0 + perturb * torch.randn(p.shape, generator=gen))
        return init(model, *a, **k)

    wg.run_fold, wg.run_eval_epoch = keep, eval_epoch
    if perturb:
        wg.init_train_state = perturbed
    try:
        t0 = time.perf_counter()
        wg.run_cv(args, on_epoch=lambda fi, ep, st, tr, ev:
                  losses.setdefault(fi, []).append(np.asarray(tr.loss)))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        wg.run_fold, wg.init_train_state, wg.run_eval_epoch = run_fold, init, run_eval
    return losses, results, seconds


def loss_gaps(got, want, n_folds) -> list:
    """Per epoch, the largest relative gap between two runs' per-fold train
    losses (``got[ep][f]`` or ``got[f + 1][ep]`` as the runs record them)."""
    gaps = []
    for ep in range(len(want[1])):
        gap = 0.0
        for f in range(n_folds):
            a = got[ep][f] if isinstance(got, list) else got[f + 1][ep]
            b = want[f + 1][ep]
            if not np.all(np.isfinite(a)):
                raise RuntimeError(f"fold {f + 1} epoch {ep + 1}: non-finite losses")
            gap = max(gap, float((np.abs(a - b) / np.abs(b)).max()))
        gaps.append(gap)
    return gaps


def vmap_share(args) -> float:
    """One eval window's share, in points, of the fold with the fewest eval
    windows (the sync table pools them; async averages per-batch accuracies,
    where one window weighs most in the smallest batch)."""
    shares = []
    for split in vc._folds_and_splits(args):
        pool = wg.split_to_device(split, args.async_loading, args.seed, "cpu").eval_pool
        n = len(pool)
        batches = [min(args.batch_size, n - i) for i in range(0, n, args.batch_size)]
        shares.append(100.0 / n if not args.async_loading
                      else 100.0 / (len(batches) * min(batches)))
    return max(shares)


# the relative size of the yardstick run's perturbation: f32 rounding
ROUNDING_PERTURBATION = 1e-7
# how far beyond the yardstick's gap the vmapped run's may lie from the
# first epoch on (its rounding differs every step, the yardstick's once)
ROUNDING_GAP_FACTOR = 10.0


def method_launches(method):
    """A vmapped flagship run's launches under ``method``: a stacked train
    step launches the stream block's forward once, its backward 3 times (one
    a task pass) and the method's own solver (if it has one) once for all
    the folds, no other solver; each eval forward the stream block once."""
    own = METHOD_SOLVER.get(method)

    def want(steps, evals):
        out = {"stream_block": steps + evals, "stream_block_folds": steps + evals,
               "stream_block_backward": 3 * steps, "stream_block_backward_folds": 3 * steps,
               "stream_block_wide": 0, "stream_block_backward_wide": 0}
        for name in ("cagrad_solver",) + MTL_SOLVER_NAMES:
            out[name] = out[f"{name}_folds"] = steps if name == own else 0
        return out
    return want


def flagship_launches(steps, evals) -> dict:
    """The vmapped flagship's launches under CAGrad (method_launches)."""
    return method_launches("cagrad")(steps, evals)


def compare_vmapped_run(args, tag, want_launches, yardstick_epoch1=False) -> dict:
    """run_cv_vmapped on ``args`` on the card, fold by fold against the
    port's sequential run_cv on the card: the first epoch's train losses
    within TRAIN_LOSS_RTOL (phase 4's), each fold's best macro accuracy and
    7-subset scores within one eval window's share, and each fold's
    torch.Generator in the same state at the end of both runs, bitwise (the
    same draws). Training amplifies rounding (14 steps an epoch here, 3 in
    phase 4): after the first epoch the losses are held against a
    yardstick, the sequential run again from initial parameters scaled by 1
    + 1e-7 N(0, 1), within ROUNDING_GAP_FACTOR of its gap; with
    ``yardstick_epoch1``, the first epoch too (at least TRAIN_LOSS_RTOL),
    for a method whose weights amplify rounding within an epoch. The vmapped run
    is a main path: every launch count set to 0 just before it and read just
    after, and held to ``want_launches(steps, eval forwards)``."""
    epochs = args.epochs
    n_folds = args.n_folds_cap or args.n_folds
    seq_gens, vm_gens = [], []
    seq_losses, seq_results, seq_s = sequential_folds(args, generators=seq_gens)
    yard = [0.0] * epochs
    if epochs > 1:
        yard = loss_gaps(sequential_folds(args, ROUNDING_PERTURBATION)[0], seq_losses,
                         n_folds)
    vm_losses = []
    streams = vc._random_streams

    def keep_streams(*a):
        rngs, gens = streams(*a)
        vm_gens.extend(gens)
        return rngs, gens

    vc._random_streams = keep_streams
    try:
        with VmapStepCounter() as counter:
            reset_launches()
            t0 = time.perf_counter()
            res = vc.run_cv_vmapped(args, on_epoch=lambda ep, tr, ev: vm_losses.append(tr["loss"]))
            torch.cuda.synchronize()
            vm_s = time.perf_counter() - t0
            launches = read_launches()
    finally:
        vc._random_streams = streams
    log(f"[vmap] {tag}: {epochs} epoch(s) of {n_folds} folds: {counter.steps} stacked "
        f"train steps and {counter.evals} eval forwards in {vm_s:.2f} s; sequential run_cv "
        f"{seq_s:.2f} s; launches {launches}")
    gaps = loss_gaps(vm_losses, seq_losses, n_folds)
    tols = [max(TRAIN_LOSS_RTOL, ROUNDING_GAP_FACTOR * y) for y in yard]
    if not yardstick_epoch1:
        tols[0] = TRAIN_LOSS_RTOL
    share = vmap_share(args)
    mask_gap = max(abs(res["per_fold_masks"][mk][f] - seq_results[f][2][mk])
                   for f in range(n_folds) for mk in wg.MASK_COMBOS)
    macro_gap = max(abs(res["per_fold_macro"][f] - seq_results[f][0])
                    for f in range(n_folds))
    flips = sum(abs(res["per_fold_masks"][mk][f] - seq_results[f][2][mk]) > 1e-6
                for f in range(n_folds) for mk in wg.MASK_COMBOS)
    same_draws = [torch.equal(a.get_state(), b.get_state()) for a, b in zip(vm_gens, seq_gens)]
    drew = [not torch.equal(g.get_state(), torch.Generator(device=g.device).manual_seed(
        args.seed + f + 1).get_state()) for f, g in enumerate(vm_gens)]
    log(f"[vmap] {tag}: per-epoch train losses vs sequential, max rel gap by epoch "
        f"{[f'{g:.3e}' for g in gaps]} (tol {[f'{t:.1e}' for t in tols]}; the yardstick "
        f"run's gap {[f'{y:.3e}' for y in yard]}); best macro max gap {macro_gap:.4f}, "
        f"7-subset scores max gap {mask_gap:.4f} points ({flips} of {7 * n_folds} "
        f"differ; one eval window {share:.4f}); each fold's generator state bitwise equal "
        f"to the sequential run's: {sum(same_draws)}/{len(same_draws)} (folds that drew: "
        f"{sum(drew)}); macro vmapped {res['macro'][0]:.4f} %, masks {res['masks']}")
    if (any(g > t for g, t in zip(gaps, tols)) or mask_gap > share + 1e-4
            or macro_gap > share + 1e-4):
        raise RuntimeError(f"{tag}: the vmapped run differs from the sequential one")
    if len(same_draws) != n_folds or not all(same_draws):
        raise RuntimeError(f"{tag}: the folds' draws differ from the sequential run's")
    want = want_launches(counter.steps, counter.evals)
    wrong = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    if counter.steps == 0 or wrong:
        raise RuntimeError(f"{tag}: launches (got, want) {wrong} for {counter.steps} steps")
    return {"launches": launches, "steps": counter.steps, "eval_forwards": counter.evals,
            "seconds": vm_s, "sequential_seconds": seq_s, "loss_gaps": gaps,
            "yardstick_gaps": yard, "mask_gap": mask_gap, "same_draws": sum(same_draws),
            "folds_that_drew": sum(drew)}


def compare_vmapped_cv(seed, dev, card) -> dict:
    """run_cv_vmapped on the first VMAP_RUN_FOLDS folds of the CLI's
    defaults (10 folds, test_per_class 8) on the card, sync for 2 epochs
    then async for 1, against the sequential run_cv on the card
    (compare_vmapped_run), with the flagship's launches."""
    common = dict(synthetic=True, seed=seed, batch_size=64, wm="gcl", alpha=0.5,
                  noise_mul=0.0, verbose=False, patience=50, **VMAP_RUN_CV)
    return {mode: compare_vmapped_run(
        wg.WearGaitArgs(epochs=epochs, async_loading=mode == "async", **common),
        f"vmap_folds {mode}", flagship_launches) for mode, epochs in (("sync", 2), ("async", 1))}


@functools.lru_cache(maxsize=None)
def vmap_step_data(seed, dev, bsz):
    """The stacked step's data at the CLI's defaults: every fold's on the
    card, their first sync batch of ``bsz`` window tuples a fold, each
    fold's class counts, and the args that made them (built once a seed)."""
    args = wg.WearGaitArgs(synthetic=True, seed=seed, batch_size=bsz, device=dev, **VMAP_CV)
    datas = [wg.split_to_device(s, False, seed, "cpu") for s in vc._folds_and_splits(args)]
    data = vc.stack_folds(datas, dev)
    idx, valid = vc.stack_index_batches([d.train_pool for d in datas],
                                        [np.arange(len(d.train_pool)) for d in datas], bsz)
    batch = vc._gather(data.xs, data.ys, torch.from_numpy(idx[:, 0]).to(dev),
                       torch.from_numpy(valid[:, 0]).to(dev), (0, 1, 2))
    counts = [[np.bincount(d.ys[k].numpy()[d.train_pool[:, k]], minlength=2) for k in range(3)]
              for d in datas]
    return args, batch, counts


def vmap_step_setup(seed, dev, bsz=64, baseline=None, mtl_method="cagrad", draws=False,
                    fused=False):
    """The stacked step at the CLI's defaults, the flagship's (under
    ``mtl_method``, CAGrad at c 0.5 by default; with ``fused`` the fused
    forward) or a baseline's (SGD on the
    mean of its branch losses; DeepAV-Lite and TACA with their dropout):
    the runner, the stacked state of 10 folds, their first sync batch of
    ``bsz`` window tuples a fold, the stacked loss context, and the folds'
    generators (None for the flagship unless ``draws`` or its method draws:
    CAGrad's step draws nothing)."""
    args, batch, counts = vmap_step_data(seed, dev, bsz)
    args = dataclasses.replace(args, baseline=baseline, fused=fused)
    settings = StepSettings(n_streams=3, wm="gcl", synchronized=True,
                            private_grads="sum_plus_own",
                            dropout=baseline in wg.DROPOUT_BASELINES)
    ctx = vc.stack_ctx([make_loss_ctx(settings, c, device=dev) for c in counts])
    mtl = None
    if baseline is None:
        kwargs = {"c": 0.5} if mtl_method in ("cagrad", "log_cagrad") else {}
        mtl = make_method(mtl_method, 3, **kwargs)
    state, partition = vc.init_stacked_state(wg.build_model(args, True),
                                             lambda p: sgd_torch(p, 1e-3), mtl, len(counts), dev)
    drawing = baseline is not None or draws or mtl_method in DRAWING_METHODS
    gens = vc._random_streams(args, len(counts), dev)[1] if drawing else None
    runner = vc.VmapEpochRunner(settings, mtl, partition, *wg.baseline_adapters(args))
    return runner, state, batch, ctx, gens


# calls a profiler session traces: a session's cost grows with its events;
# the host clock's timed reps are counted apart
PROFILE_REPS = 3


def profile_steps(fn, reps=None, table=None) -> dict:
    """Device time and kernel launches a call of ``fn`` (torch.profiler
    over ``reps`` calls after one), and the profiled wall time a call; with
    ``table`` = (label, card), the profile's table by kernel too."""
    from torch.autograd import DeviceType

    reps = PROFILE_REPS if reps is None else reps
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    if table is not None:
        profile_table(prof, f"{reps} x {table[0]}", wall_ms * reps, table[1])
    return {"device_ms": device_ms, "kernels": sum(e.count for e in kernels) / reps,
            "wall_ms_profiled": wall_ms, "idle": max(0.0, 1 - device_ms / wall_ms)}


def check_vmap_step(seed, dev, card, baseline=None, reps=20, table=True,
                    mtl_method="cagrad") -> dict:
    """One stacked step at 10 folds x 64, the flagship's (under
    ``mtl_method``) or ``baseline``'s: its launches (one train step's of
    method_launches or baseline_launches), its host synchronisations (0),
    and its wall time
    (host clock around ``reps`` synchronised steps after 3) beside the 10
    sequential batch-64 steps it replaces, in turns (stacked, ten, stacked:
    phase 6 times the batch-64 step too); then the device time, kernel
    launches and idle share of each under the profiler, over at most
    PROFILE_REPS steps (with ``table``, the stacked step's table by kernel
    too). A baseline's stacked step draws from the
    folds' generators, one draw a fold a site."""
    runner, state, batch, ctx, gens = vmap_step_setup(seed, dev, baseline=baseline,
                                                      mtl_method=mtl_method)
    label = baseline or ("CAGrad" if mtl_method == "cagrad" else mtl_method)

    def stacked():
        return runner.train_step(state, batch, ctx, False, gens)

    stacked()
    torch.cuda.synchronize()
    reset_launches()
    stacked()
    torch.cuda.synchronize()
    launches = read_launches()
    want = (method_launches(mtl_method) if baseline is None else baseline_launches(baseline))(1, 0)
    syncs = []
    for _ in range(2):  # a first count of a process may read one more
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                stacked()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        syncs.append(sum("synchroniz" in str(w.message) for w in caught))
    log(f"[vmap] one stacked {label} step of {VMAP_FOLDS} folds x 64: launches {launches} "
        f"(want {want}); host synchronisations {syncs[-1]} (counts {syncs})")
    wrong = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    if wrong or syncs[-1] != 0:
        raise RuntimeError(f"stacked {label} step: launches (got, want) {wrong}, syncs {syncs}")

    step, seq_state, seq_ctx, seq_batch, gen = make_step_setup(seed, dev, 64, baseline,
                                                               mtl_method=mtl_method)

    def ten():
        for _ in range(VMAP_FOLDS):
            step(seq_state, seq_batch, gen, seq_ctx)

    def host_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps

    turns = {"stacked": [], "ten": []}
    for name in ("stacked", "ten", "stacked"):
        turns[name].append(host_ms(stacked if name == "stacked" else ten))
    prof = {"stacked": profile_steps(stacked, min(PROFILE_REPS, reps), table=(
        f"stacked {label} step of {VMAP_FOLDS} folds x 64", card) if table else None),
            "one": profile_steps(lambda: step(seq_state, seq_batch, gen, seq_ctx),
                                 min(PROFILE_REPS, reps))}
    out = {"stacked_ms": turns["stacked"], "ten_sequential_ms": turns["ten"],
           "one_sequential_ms": [v / VMAP_FOLDS for v in turns["ten"]],
           "profile": prof, "launches": launches, "syncs": syncs[-1]}
    log(f"[time] {card}: one stacked {label} step of {VMAP_FOLDS} folds x 64 window tuples: "
        f"{turns['stacked'][0]:.3f}/{turns['stacked'][1]:.3f} ms (host clock, synchronised); "
        f"the {VMAP_FOLDS} sequential batch-64 steps it replaces: {turns['ten'][0]:.3f} ms "
        f"({turns['ten'][0] / VMAP_FOLDS:.3f} ms a step, one turn between the stacked ones: "
        f"phase 6 times the batch-64 step too); profiler, a step: stacked "
        f"{prof['stacked']}, sequential {prof['one']}")
    return out


def check_cli_runs(card) -> dict:
    """python -m gaitpd_torch.cli --mode weargait on synthetic data, with
    and without --vmap_folds, as subprocesses on the card: each exits 0 and
    prints the 7-subset table."""
    out = {}
    base = [sys.executable, "-m", "gaitpd_torch.cli", "--mode", "weargait", "--synthetic",
            "--epochs", "1", "--n_folds", "2", "--test_per_class", "3"]
    root = Path(__file__).resolve().parent
    runs = {"sequential": [], "vmap_folds": ["--vmap_folds"]}
    t0 = time.perf_counter()
    # both at once; each ends (or is killed) before this returns
    procs = {name: subprocess.Popen(base + extra, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True, cwd=root)
             for name, extra in runs.items()}
    try:
        results = {name: p.communicate(timeout=600) for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    for name, (stdout, stderr) in results.items():
        rc = procs[name].returncode
        table = "=== Masked accuracy at best epoch" in stdout and all(
            f"[{mk:5}]" in stdout for mk in wg.MASK_COMBOS)
        lines = [ln for ln in stdout.splitlines() if ln.startswith("[") and "folds" in ln]
        log(f"[cli] {' '.join(base[1:] + runs[name])}: exit {rc} ({seconds:.1f} s for both "
            f"runs at once); 7-subset table printed: {table}; {lines}")
        if rc != 0 or not table:
            raise RuntimeError(f"the CLI ({name}) failed: exit {rc}\n{stdout[-2000:]}\n"
                               f"{stderr[-4000:]}")
        out[name] = {"exit": rc}
    out["seconds"] = seconds
    return out


def phase_vmap_cv(seed, dev, card, rng, commands) -> dict:
    """Phase 7: the fold-stacked kernels against their plain versions, the
    vmapped CV against the sequential one at the CLI's defaults (the main
    path's launches), one stacked step's launches, syncs and time, and the
    CLI end to end (check_cli_runs, run with the other phases' subprocesses:
    ``commands``)."""
    t0 = time.perf_counter()
    errors = check_fold_kernels(rng, dev, card)
    runs = compare_vmapped_cv(seed, dev, card)
    step = check_vmap_step(seed, dev, card, reps=10)
    cli = commands["cli"]
    log(f"[vmap] phase 7: {time.perf_counter() - t0:.1f} s")
    return {"errors": errors, "runs": runs, "step": step, "cli": cli}


# ---------------------------------------------------------------------------
# 8. WearGait's baselines and the recipe's draws under --vmap_folds
# ---------------------------------------------------------------------------

# (F, N a fold, Tq, Tk, d) of the fold-stacked cross-attention: the six
# directed pairs of a batch of 64 window tuples a fold at each variant's
# shape on a path: the WearGait fusion (sweep_d12), --enc_out_ch 16
# (sweep), --win_len 101 (sweep_long forward, sweep_128 backward) and
# --enc_out_ch 96 (tiled)
FOLD_XATTN_SHAPES = {
    "main": (VMAP_FOLDS, 6 * 64, 64, 64, 12),
    "enc_out_ch16": (VMAP_FOLDS, 6 * 64, 64, 64, 16),
    "win_len101": (VMAP_FOLDS, 6 * 64, 101, 101, 12),
    "enc_out_ch96": (VMAP_FOLDS, 6 * 64, 64, 64, 96),
}


def check_fold_xattn(rng, dev, card) -> dict:
    """The cross-attention under torch.func.vmap over 10 folds at
    FOLD_XATTN_SHAPES: one forward launch for all folds, one backward launch
    through autograd outside the vmap, one forward launch under no_grad;
    each fold's output and gradients bitwise equal to a launch of that fold
    alone, and within phase 5's tolerances of the plain version."""
    errors = {}
    attend = torch.func.vmap(cx.cheap_xattn)
    for name, (folds, n, tq, tk, d) in FOLD_XATTN_SHAPES.items():
        a, b, g = (t.reshape(folds, n, -1, d) for t in xattn_inputs(rng, folds * n, tq, tk, d,
                                                                     dev))
        leaves = [t.clone().requires_grad_() for t in (a, b)]
        before = (cx.launches, cx.backward_launches)
        out = attend(*leaves)
        grads = torch.autograd.grad(out, leaves, g)
        torch.cuda.synchronize()
        each_way = (cx.launches - before[0], cx.backward_launches - before[1])
        with torch.no_grad():
            before_ng = cx.launches
            same_no_grad = torch.equal(attend(a, b), out)
            no_grad_launches = cx.launches - before_ng
        same_fwd = same_bwd = True
        for f in range(folds):
            same_fwd &= torch.equal(out[f], cx.cheap_xattn(a[f], b[f]))
            single = cx.cheap_xattn_backward(a[f], b[f], g[f])
            same_bwd &= torch.equal(grads[0][f], single[0]) and torch.equal(grads[1][f], single[1])
        flat = [t.reshape(folds * n, -1, d) for t in (a, b, g)]
        want = cx.cheap_xattn_reference(*flat[:2]).reshape(out.shape)
        atol, rtol = (KERNEL_TOL, 0.0) if tk <= 64 else (XATTN_LONG_ATOL, XATTN_LONG_RTOL)
        err = (out - want).abs().max().item()
        ok = bool(((out - want).abs() <= atol + rtol * want.abs()).all())
        wants = [w.reshape(t.shape) for w, t in
                 zip(cx.cheap_xattn_backward_reference(*flat), grads)]
        errs = [(gk - wk).abs().max().item() for gk, wk in zip(grads, wants)]
        ok_g = all(bool(((gk - wk).abs() <= XATTN_GRAD_ATOL + XATTN_GRAD_RTOL * wk.abs()).all())
                   for gk, wk in zip(grads, wants))
        variants = "/".join(cx.VARIANT_NAMES[cx._variant(tq, tk, d, bw)] for bw in (False, True))
        log(f"[kernel] cheap_xattn under vmap {name}: {folds} folds x (N {n}, Tq {tq}, Tk {tk}, "
            f"d {d}) (variants {variants}): launches forward/backward {each_way} (no_grad "
            f"{no_grad_launches}, its output bitwise equal: {same_no_grad}); forward max abs "
            f"err {err:.3e}, dA/dB {errs[0]:.3e}/{errs[1]:.3e} (tol {atol:.0e} + {rtol:.0e} "
            f"rel; {XATTN_GRAD_ATOL:.0e} + {XATTN_GRAD_RTOL:.0e} rel); each fold bitwise equal "
            f"to its own launch: forward {same_fwd}, backward {same_bwd}")
        if each_way != (1, 1) or no_grad_launches != 1 or not same_no_grad:
            raise RuntimeError(f"cheap_xattn under vmap [{name}]: launches {each_way}, no_grad "
                               f"{no_grad_launches}")
        if not (ok and ok_g and same_fwd and same_bwd):
            raise RuntimeError(f"cheap_xattn under vmap [{name}]: errors {err}, {errs}; "
                               f"bitwise per fold {same_fwd}, {same_bwd}")
        errors[name] = (err, max(errs))
    return errors


def time_fold_xattn(rng, dev, card) -> dict:
    """The fold-stacked cross-attention at 10 x 6 x 64 problems: the merged
    launch's kernel, plain version, SDPA and bound both ways
    (time_cheap_xattn on the merged batch), and the vmapped forward itself
    (the fold axis moved and merged, then the launch), eager and from a CUDA
    graph."""
    folds, n, tq, tk, d = FOLD_XATTN_SHAPES["main"]
    times = time_cheap_xattn(rng, dev, card, (folds * n, tq, tk, d))
    a, b, _ = (t.reshape(folds, n, -1, d) for t in xattn_inputs(rng, folds * n, tq, tk, d, dev))
    attend = torch.func.vmap(cx.cheap_xattn)
    with torch.inference_mode():
        vm = {"vmap_ms": time_cuda(lambda: attend(a, b)),
              "vmap_graph_ms": time_cuda_graph(lambda: attend(a, b))}
    log(f"[time] {card}: cheap_xattn under vmap, {folds} folds x (N {n}, Tq {tq}, Tk {tk}, d "
        f"{d}): eager {vm['vmap_ms']:.4f} ms, from a CUDA graph {vm['vmap_graph_ms']:.4f} ms "
        f"(the merged launch alone: {times['cheap_xattn']['graph_ms']:.4f} ms from a graph)")
    times["cheap_xattn"].update(vm, folds=folds)
    times["cheap_xattn_backward"]["folds"] = folds
    return {f"{name}_folds": t for name, t in times.items()}


def baseline_launches(baseline):
    """A vmapped baseline run's launches for its stacked train steps and
    eval forwards: the cheap-xattn fusion launches the stream block and the
    cross-attention once each way a step (one backward pass), once each an
    eval forward; TACA launches no kernel of the port."""
    def want(steps, evals):
        if baseline == "cheap_xattn":
            return {"stream_block": steps + evals, "stream_block_folds": steps + evals,
                    "stream_block_backward": steps, "stream_block_backward_folds": steps,
                    "cheap_xattn": steps + evals, "cheap_xattn_backward": steps,
                    "cagrad_solver": 0, "stream_block_wide": 0, "stream_block_backward_wide": 0}
        return {name: 0 for name in COUNTERS}
    return want


# run_cv_vmapped's baselines at the CLI's defaults (10 folds, test_per_class
# 8), each against the sequential run on the card
VMAP_BASELINE_RUNS = {"cheap_xattn sync": ("cheap_xattn", False, 2),
                      "taca async": ("taca", True, 2)}


def phase_vmap_baselines(seed, dev, card, rng) -> dict:
    """Phase 8: the fold-stacked cross-attention against single-fold
    launches and its plain version, run_cv_vmapped of the cheap-xattn fusion
    (sync) and TACA (async, with its dropout drawn from each fold's
    generator) against the sequential run_cv on the card under phase 7's
    rule, the draws bitwise equal per fold, and a stacked step of the
    cheap-xattn fusion and of DeepAV-Lite (the most dropout sites) beside
    the 10 sequential steps it replaces, with its launches and host
    synchronisations (0)."""
    t0 = time.perf_counter()
    parts = {}

    def done(part):
        parts[part] = time.perf_counter() - t0 - sum(parts.values())

    errors = check_fold_xattn(rng, dev, card)
    done("kernels")
    runs = {}
    for tag, (baseline, async_mode, epochs) in VMAP_BASELINE_RUNS.items():
        args = wg.WearGaitArgs(synthetic=True, seed=seed, batch_size=64, wm="gcl", alpha=0.5,
                               noise_mul=0.0, verbose=False, patience=50, epochs=epochs,
                               async_loading=async_mode, baseline=baseline, **VMAP_RUN_CV)
        runs[tag] = compare_vmapped_run(args, f"vmap_folds {tag}", baseline_launches(baseline))
        done(tag)
    if runs["taca async"]["folds_that_drew"] != VMAP_RUN_FOLDS:
        raise RuntimeError("taca async: a fold drew no dropout mask")
    # DeepAV-Lite's sequential step takes ~0.1 s and ~1700 kernels: fewer
    # timed and profiled steps, no table
    steps = {"cheap_xattn": check_vmap_step(seed, dev, card, "cheap_xattn", reps=10)}
    done("cheap_xattn step")
    steps["deepav_lite"] = check_vmap_step(seed, dev, card, "deepav_lite", reps=3, table=False)
    done("deepav_lite step")
    times = time_fold_xattn(rng, dev, card)
    done("times")
    seconds = time.perf_counter() - t0
    log(f"[vmap] phase 8: {seconds:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in parts.items())})")
    return {"errors": errors, "runs": runs, "steps": steps, "times": times, "seconds": seconds}


# ---------------------------------------------------------------------------
# 9. the 16 other MTL methods under --vmap_folds: the solvers with a fold axis
# ---------------------------------------------------------------------------

# the methods whose state a stacked step carries: one stacked step first,
# so that the compared step starts from a state that has moved (FAMO's
# deferred update runs from the second step on)
STATEFUL_METHODS = ("uw", "dwa", "famo", "nashmtl")
# the stacked steps timed beside the 10 sequential steps: one of each
# solver kernel's methods and FAMO, the largest state
TIMED_VMAP_METHODS = ("mgda", "fairgrad", "nashmtl", "famo")
# run_cv_vmapped against the sequential run_cv on the card: PCGrad draws a
# permutation a step (after the GCL noise), NashMTL a solver and a state.
# NashMTL's Newton weights (up to ~7e4 on these Gram matrices) amplify
# rounding within the first epoch: the yardstick run, the sequential run
# from parameters scaled by 1 + 1e-7 N(0, 1), moved its epoch-1 losses by
# 1.4e-4 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6), so phase 7's
# yardstick rule holds epoch 1 too in these runs
VMAP_MTL_RUNS = {"pcgrad sync": ("pcgrad", 0.5), "nashmtl sync": ("nashmtl", 0.0)}
# and on the card alone, for their solvers' launches on a main path
VMAP_MTL_CARD_RUNS = ("mgda", "fairgrad")


def fold_solver_calls():
    """(name, solver on one fold's (K, K) matrix, its plain version, the
    input map) of the four solvers a stacked step launches."""
    return [
        ("cagrad_solver", lambda g: cs.cagrad_solve(g, 0.5),
         lambda g: cs.cagrad_solve_reference(g, 0.5), lambda g: g),
        ("min_norm_solver", ms.min_norm_solve, ms.min_norm_solve_reference, lambda g: g),
        ("fairgrad_solver", lambda g: ms.fairgrad_solve(g, 1.0),
         lambda g: ms.fairgrad_solve_reference(g, 1.0), lambda g: g),
        ("nashmtl_solver", ms.nashmtl_solve, ms.nashmtl_solve_reference, nash_normalised),
    ]


def fold_solver_grams(rng, dev, name):
    """VMAP_FOLDS Gram matrices at K = 3, one a fold, of mtl_solver_grams'
    law; MGDA's half correlated, so that solves that stop early and solves
    of 250 steps share the launch."""
    n = VMAP_FOLDS
    raw = mtl_solver_grams(rng, n, 3)[:n]
    if name == "min_norm_solver":
        raw = np.concatenate([raw[: n // 2], correlated_grams(rng, n - n // 2, 3)])
    return torch.from_numpy(raw).to(dev)


def check_fold_solvers(rng, dev, card) -> dict:
    """The four solvers under torch.func.vmap over 10 folds at K = 3: one
    launch for every fold (the solver's counter and its fold counter up by
    one), each fold's weights bitwise equal to a launch of its own and to
    the plain version's (phase 5f's rule). Returns each solver's max abs
    error against the plain version."""
    errors = {}
    for name, run, plain, prep in fold_solver_calls():
        grams = prep(fold_solver_grams(rng, dev, name))
        before = read_launches()
        got = torch.func.vmap(run)(grams)
        torch.cuda.synchronize()
        after = read_launches()
        launched = (after[name] - before[name], after[f"{name}_folds"] - before[f"{name}_folds"])
        alone = torch.stack([run(g) for g in grams])
        want = plain(grams)
        same_alone, same_plain = bitwise_rows(got, alone), bitwise_rows(got, want)
        err = (got - want).abs().max().item()
        stops = ""
        if name == "min_norm_solver":
            stops = f" (stop steps {min_norm_element_stop(grams)[1].tolist()})"
        log(f"[kernel] {name} under vmap: {VMAP_FOLDS} folds' Gram matrices (K = 3){stops}: "
            f"launches (counter, fold counter) {launched}; each fold bitwise equal to its own "
            f"launch {same_alone}/{VMAP_FOLDS}, to the plain version {same_plain}/{VMAP_FOLDS}; "
            f"max abs err {err:.3e}")
        if launched != (1, 1) or same_alone != VMAP_FOLDS or same_plain != VMAP_FOLDS:
            raise RuntimeError(f"{name} under vmap: launches {launched}, bitwise per fold "
                               f"{same_alone}, against the plain version {same_plain}")
        errors[name] = err
    return errors


def fold_slice(tree, f):
    """Fold f's entries of a tree of tuples and dicts of stacked tensors."""
    if isinstance(tree, dict):
        return {k: fold_slice(v, f) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(fold_slice(v, f) for v in tree)
    return tree[f]


def clone_generator(gen):
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def largest_gap(got, want) -> tuple:
    """The largest absolute gap between two lists of tensors, and phase 4's
    tolerance for it: STEP_MOMENTUM_TOL of the largest value (at least 1)."""
    gap = max((g.double() - w.double()).abs().max().item() for g, w in zip(got, want))
    largest = max(w.double().abs().max().item() for w in want)
    return gap, STEP_MOMENTUM_TOL * max(1.0, largest)


def check_stacked_method_step(seed, dev, method) -> dict:
    """One stacked step of ``method`` at 10 folds x 64 (after one step for a
    stateful method) against the 10 sequential steps it replaces, each
    fold's mtl_grads on its own parameters, batch, context, state and
    generator on the card: final gradients and new states within phase 4's
    tolerance, every fold's generator bitwise equal afterwards; the step is
    a main path (counts set to 0 just before it): the method's solver once
    for all folds and the stream block's kernels as in phase 7; then 0 host
    synchronisations in a stacked step."""
    runner, state, batch, ctx, gens = vmap_step_setup(seed, dev, mtl_method=method, draws=True)
    if method in STATEFUL_METHODS:
        state, _ = runner.train_step(state, batch, ctx, False, gens)
    names = list(state.params)
    params0 = {n: p.detach().clone() for n, p in state.params.items()}
    mtl_state0 = {k: v.clone() for k, v in state.mtl_state.items()}
    gens0 = [clone_generator(g) for g in gens]
    torch.cuda.synchronize()
    reset_launches()
    state, _ = runner.train_step(state, batch, ctx, False, gens)
    torch.cuda.synchronize()
    launches = read_launches()
    grad_gap = state_gap = (0.0, 0.0)
    same_draws = 0
    for f in range(VMAP_FOLDS):
        params = [params0[n][f].clone().requires_grad_() for n in names]
        module = vc._FoldModule(state.model, dict(zip(names, params)))
        xs, ys, valid = fold_slice(batch["xs"], f), fold_slice(batch["ys"], f), batch["valid"][f]
        ctx_f = fold_slice(ctx, f)
        grads, _, _, new_state, _ = mtl_lib.mtl_grads(
            runner.mtl_method,
            lambda: runner.loss_fn(module, xs, ys, valid, ctx_f, gens0[f], state.epoch),
            params, runner.partition, fold_slice(mtl_state0, f),
            private_grads="sum_plus_own", generator=gens0[f])
        gap = largest_gap([state.params[n].grad[f] for n in names], grads)
        grad_gap = max(grad_gap, gap)
        if new_state:
            keys = sorted(new_state)
            gap = largest_gap([state.mtl_state[k][f].float() for k in keys],
                              [new_state[k].float() for k in keys])
            state_gap = max(state_gap, gap)
        same_draws += torch.equal(gens[f].get_state(), gens0[f].get_state())
    want = method_launches(method)(1, 0)
    wrong = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    syncs = []
    for _ in range(2):  # a first count of a process may read one more
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                runner.train_step(state, batch, ctx, False, gens)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        syncs.append(sum("synchroniz" in str(w.message) for w in caught))
    log(f"[vmap] one stacked {method} step of {VMAP_FOLDS} folds x 64 against the "
        f"{VMAP_FOLDS} sequential steps: final gradients max abs gap {grad_gap[0]:.3e} (tol "
        f"{grad_gap[1]:.2e}), new states {state_gap[0]:.3e} (tol {state_gap[1]:.2e}); each "
        f"fold's generator bitwise equal {same_draws}/{VMAP_FOLDS}; launches (those not 0) "
        f"{ {k: n for k, n in launches.items() if n} }; host synchronisations {syncs[-1]} "
        f"(counts {syncs})")
    if grad_gap[0] > grad_gap[1] or state_gap[0] > state_gap[1]:
        raise RuntimeError(f"stacked {method} step: gradients {grad_gap}, states {state_gap}")
    if same_draws != VMAP_FOLDS or wrong or syncs[-1] != 0:
        raise RuntimeError(f"stacked {method} step: draws {same_draws}, launches (got, want) "
                           f"{wrong}, syncs {syncs}")
    return {"grad_gap": grad_gap[0], "state_gap": state_gap[0], "launches": launches,
            "syncs": syncs[-1]}


def card_only_vmapped_run(args, tag, want_launches) -> dict:
    """run_cv_vmapped on ``args`` on the card alone, a main path: every
    launch count set to 0 just before it and read just after, held to
    ``want_launches(steps, eval forwards)``; finite losses."""
    losses = []
    with VmapStepCounter() as counter:
        reset_launches()
        t0 = time.perf_counter()
        res = vc.run_cv_vmapped(args, on_epoch=lambda ep, tr, ev: losses.append(tr["loss"]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
    want = want_launches(counter.steps, counter.evals)
    wrong = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    finite = all(np.all(np.isfinite(v)) for v in losses)
    log(f"[vmap] {tag}: {counter.steps} stacked train steps and {counter.evals} eval forwards "
        f"in {seconds:.2f} s on the card alone; launches {launches}; losses finite {finite}; "
        f"macro {res['macro'][0]:.4f} %")
    if counter.steps == 0 or wrong or not finite:
        raise RuntimeError(f"{tag}: launches (got, want) {wrong}, finite losses {finite}")
    return {"launches": launches, "steps": counter.steps, "seconds": seconds}


def time_fold_solvers(rng, dev, card) -> dict:
    """Each solver's merged launch of 10 folds' matrices (K = 3), the
    stacked step's, eager and from a CUDA graph: the kernel on the 10
    matrices, the vmapped call (the fold axis merged, then the launch), and
    the 10 single launches it replaces, beside its plain version and its
    bound (10 times a matrix's operations; MGDA's at each matrix's stop
    step)."""
    out = {}
    for name, run, plain, prep in fold_solver_calls():
        grams = prep(fold_solver_grams(rng, dev, name))

        def ten():
            return [run(g) for g in grams]

        def vmapped():
            return torch.func.vmap(run)(grams)

        t = {"kernel": time_cuda(lambda: run(grams), warmup=10, reps=200),
             "plain": time_cuda(lambda: plain(grams), warmup=0, reps=2),  # CAGrad's: ~2.4 s
             "kernel_2": time_cuda(lambda: run(grams), warmup=10, reps=200),
             "ten": time_cuda(ten, warmup=3, reps=50),
             "vmap": time_cuda(vmapped, warmup=10, reps=100),
             "graph": time_cuda_graph(lambda: run(grams), reps=100),
             "ten_graph": time_cuda_graph(ten, reps=20),
             "vmap_graph": time_cuda_graph(vmapped, reps=100)}
        if name == "cagrad_solver":
            ops = VMAP_FOLDS * solver_ops(3)
        elif name == "min_norm_solver":
            stops = int(min_norm_element_stop(grams)[1].sum())
            ops = mtl_solver_ops(name, 3) * stops // ms.MIN_NORM_STEPS
        else:
            ops = VMAP_FOLDS * mtl_solver_ops(name, 3)
        bound_ms, bound_by = _bound(VMAP_FOLDS * 4 * (9 + 3), ops)
        log(f"[time] {card}: {name} on {VMAP_FOLDS} folds' Gram matrices (K = 3): one launch "
            f"{t['kernel']:.4f}/{t['kernel_2']:.4f} ms eager, {t['graph']:.4f} ms from a CUDA "
            f"graph; under vmap {t['vmap']:.4f} ms eager, {t['vmap_graph']:.4f} from a graph; the "
            f"{VMAP_FOLDS} single launches it replaces {t['ten']:.4f} ms eager, "
            f"{t['ten_graph']:.4f} from a graph; plain (eager torch on the card, 2 calls) "
            f"{t['plain']:.2f} ms; bound {bound_ms:.3e} ms ({bound_by}: {ops} f32 operations); "
            f"launches a stacked step: 1")
        out[f"{name}_folds"] = {
            "ms": min(t["kernel"], t["kernel_2"]), "plain_ms": t["plain"], "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by, "graph_ms": t["graph"],
            "vmap_ms": t["vmap"], "vmap_graph_ms": t["vmap_graph"], "ten_single_ms": t["ten"],
            "ten_single_graph_ms": t["ten_graph"], "folds": VMAP_FOLDS}
    return out


def phase_vmap_mtl(seed, dev, card, rng) -> dict:
    """Phase 9: the four solvers under vmap against single-fold launches and
    their plain versions; a stacked step of each of the 17 methods against
    the 10 sequential steps (launches, draws, 0 host synchronisations);
    run_cv_vmapped of PCGrad and NashMTL against the sequential run_cv on
    the card under phase 7's rule, every fold's generator bitwise equal at
    the end, and of MGDA and FairGrad on the card alone (their solvers'
    launches on a main path); the stacked MGDA, FairGrad, NashMTL and FAMO
    steps beside the 10 sequential steps; each merged solver launch timed."""
    t0 = time.perf_counter()
    parts = {}

    def done(part):
        parts[part] = time.perf_counter() - t0 - sum(parts.values())

    errors = check_fold_solvers(rng, dev, card)
    done("kernels")
    steps = {m: check_stacked_method_step(seed, dev, m) for m in sorted(METHODS)}
    done("stacked steps")
    runs = {}
    # the compared runs at all 10 folds: NashMTL's Newton weights amplify
    # rounding within an epoch, and the yardstick's gap, a largest over
    # the folds, is steadier over 10
    common = dict(synthetic=True, seed=seed, batch_size=64, wm="gcl", alpha=0.5, verbose=False,
                  patience=50, **VMAP_CV)
    for tag, (method, noise) in VMAP_MTL_RUNS.items():
        args = wg.WearGaitArgs(epochs=2, mtl_method=method, noise_mul=noise, **common)
        runs[tag] = compare_vmapped_run(args, f"vmap_folds {tag}", method_launches(method),
                                        yardstick_epoch1=True)
        done(tag)
    if runs["pcgrad sync"]["folds_that_drew"] != VMAP_FOLDS:
        raise RuntimeError("pcgrad sync: a fold drew no permutation")
    common.update(VMAP_RUN_CV)  # the card-only runs on the first 4 folds
    for method in VMAP_MTL_CARD_RUNS:
        args = wg.WearGaitArgs(epochs=1, mtl_method=method, noise_mul=0.0, **common)
        runs[f"{method} sync"] = card_only_vmapped_run(args, f"vmap_folds {method} sync",
                                                       method_launches(method))
    done("card-only runs")
    # 5 timed steps a turn: the ten sequential steps take ~0.25 s a call
    timed = {m: check_vmap_step(seed, dev, card, reps=5, table=False, mtl_method=m)
             for m in TIMED_VMAP_METHODS}
    done("timed steps")
    times = time_fold_solvers(rng, dev, card)
    done("times")
    seconds = time.perf_counter() - t0
    log(f"[vmap] phase 9: {seconds:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in parts.items())})")
    return {"errors": errors, "steps": steps, "runs": runs, "timed": timed, "times": times,
            "seconds": seconds}


# ---------------------------------------------------------------------------
# 10. FBG/FoG's folds and the baseline seed sweeps under --vmap_folds
# ---------------------------------------------------------------------------

FF_VMAP_FOLDS = 3
# (F, B a fold, T, C_in, K, C_out, t_out, act) of the fold-stacked stream
# block at the FBG/FoG drivers' batch: FoG's and FBG's multitask backbones
# (both streams' windows, 8 bins) and FOCAL's 2-mod one (32 -> 4 channels,
# 4 bins; ReLU on its path, GELU beside it)
FF_FOLD_SHAPES = {
    "fog": (FF_VMAP_FOLDS, 2 * FF_BATCH, 101, 6, 3, 16, 8, "relu"),
    "fbg": (FF_VMAP_FOLDS, 2 * FF_BATCH, 101, 3, 3, 16, 8, "relu"),
    "focal": (FF_VMAP_FOLDS, 2 * FF_BATCH, 101, 32, 3, 4, 4, "relu"),
    "focal_gelu": (FF_VMAP_FOLDS, 2 * FF_BATCH, 101, 32, 3, 4, 4, "gelu"),
}
FF_CAGRAD_C = 0.1  # FbgFogArgs.alpha: CAGrad's c at K = 2
# the seed sweeps held against the sequential driver run once a seed: the
# cheap-xattn fusion (synced, one joint head, Adam) and FOCAL (async, two
# heads, AdamW with the clip)
FF_SEEDS = (0, 1)
FF_SEED_RUNS = {"cheap_xattn fusion sync (Adam)": ("fusion", "cheap_xattn", True),
                "focal async (AdamW, clip)": ("focal", "cheap_xattn", False)}


def check_ff_fold_kernels(rng, dev) -> dict:
    """The stream block under torch.func.vmap over FF_VMAP_FOLDS folds at
    FF_FOLD_SHAPES, as the stacked FBG/FoG step calls it: one fold-stacked
    launch forward, one backward through autograd outside the vmap; each
    fold's output and gradients bitwise those of a launch of its own;
    against the plain version within phase 2's tolerances (the ReLU kink
    windows' cotangents set to 0). Returns each shape's (forward, backward)
    max abs error."""
    errors = {}
    for name, (folds, bsz, t, cin, k, cout, t_out, act) in FF_FOLD_SHAPES.items():
        x, w, b, g = fold_inputs(rng, folds, bsz, t, cin, k, cout, dev, t_out)
        xs = x.reshape(folds, bsz, t, cin).clone().requires_grad_()
        wl, bl = w.clone().requires_grad_(), b.clone().requires_grad_()
        block = torch.func.vmap(lambda xf, wf, bf: sb.stream_block(xf, wf, bf, t_out, act))
        before = read_launches()
        out = block(xs, wl, bl)
        grads = torch.autograd.grad(out, (xs, wl, bl), g.reshape(out.shape))
        torch.cuda.synchronize()
        after = read_launches()
        launched = tuple(after[n] - before[n] for n in (
            "stream_block", "stream_block_folds", "stream_block_backward",
            "stream_block_backward_folds"))
        out = out.reshape(folds * bsz, t_out, cout)
        grads = (grads[0].reshape(x.shape), grads[1], grads[2])
        same_fwd = same_bwd = 0
        for f in range(folds):
            rows = slice(f * bsz, (f + 1) * bsz)
            same_fwd += torch.equal(out[rows], sb.stream_block(x[rows], w[f], b[f], t_out, act))
            single = sb.stream_block_backward(x[rows], w[f], b[f], g[rows], t_out, act)
            same_bwd += all(torch.equal(a, c) for a, c in
                            zip((grads[0][rows], grads[1][f], grads[2][f]), single))
        err = (out - sb.stream_block_folds_reference(x, w, b, t_out, act)).abs().max().item()
        kinks = relu_kink_rows(x, w, b, act, folds).to(dev)
        g_safe = torch.where(kinks[:, None, None], torch.zeros_like(g), g)
        got = sb.stream_block_folds_backward(x, w, b, g_safe, t_out, act)
        want = sb.stream_block_folds_backward_reference(x, w, b, g_safe, t_out, act)
        errs = [(a - c).abs().max().item() for a, c in zip(got, want)]
        tols = [KERNEL_TOL] + [KERNEL_TOL * max(1.0, c.abs().max().item()) for c in want[1:]]
        fwd_cfg = sb.forward_config(bsz, t, cin, cout, k, t_out, act, folds=folds)
        bwd_cfg = sb.backward_config(bsz, t, cin, cout, k, t_out, act, folds=folds)
        log(f"[kernel] stream_block under vmap fbg_fog {name}: {folds} folds x{(bsz, t, cin)} "
            f"w{tuple(w.shape[1:])} {act} (variants {fwd_cfg['variant']}/{bwd_cfg['variant']}): "
            f"launches (forward, its fold counter, backward, its fold counter) {launched}; "
            f"each fold bitwise equal to its own launch: forward {same_fwd}/{folds}, backward "
            f"{same_bwd}/{folds}; forward max abs err {err:.3e} (tol {KERNEL_TOL}); backward "
            f"gx/gw/gb max abs err {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (tol "
            f"{tols[0]:.1e}/{tols[1]:.2e}/{tols[2]:.2e}; {int(kinks.sum())} ReLU kink "
            f"window(s) left out)")
        log(f"[config] stream_block under vmap fbg_fog {name}: forward {fwd_cfg}; backward "
            f"{bwd_cfg}")
        if launched != (1, 1, 1, 1):
            raise RuntimeError(f"stream_block under vmap [{name}]: launches {launched}")
        if same_fwd != folds or same_bwd != folds:
            raise RuntimeError(f"stream_block under vmap [{name}]: a fold differs from its "
                               "own launch")
        if not (np.isfinite(err) and err <= KERNEL_TOL
                and all(np.isfinite(e) and e <= tol for e, tol in zip(errs, tols))):
            raise RuntimeError(f"stream_block under vmap [{name}] disagrees with its plain "
                               f"version: {err}, {errs}")
        errors[name] = (err, max(errs))
    return errors


def check_ff_fold_solver(rng, dev, card) -> dict:
    """The CAGrad solver under torch.func.vmap over FF_VMAP_FOLDS folds'
    Gram matrices at K = 2 (the stacked FBG/FoG step's, c 0.1): one launch
    (the counter and its fold counter up by one), each fold's weights
    bitwise those of its own launch and of the plain version; then timed:
    the merged launch, the vmapped call and the single launches it
    replaces, eager and from a CUDA graph, beside the plain version and the
    bound."""
    grams = torch.from_numpy(mtl_solver_grams(rng, FF_VMAP_FOLDS, 2)[:FF_VMAP_FOLDS]).to(dev)

    def run(gram):
        return cs.cagrad_solve(gram, FF_CAGRAD_C)

    def vmapped():
        return torch.func.vmap(run)(grams)

    def singles():
        return [run(gram) for gram in grams]

    before = read_launches()
    got = vmapped()
    torch.cuda.synchronize()
    after = read_launches()
    launched = tuple(after[n] - before[n] for n in ("cagrad_solver", "cagrad_solver_folds"))
    want = cs.cagrad_solve_reference(grams, FF_CAGRAD_C)
    same_alone = bitwise_rows(got, torch.stack(singles()))
    same_plain = bitwise_rows(got, want)
    err = (got - want).abs().max().item()
    log(f"[kernel] cagrad_solver under vmap: {FF_VMAP_FOLDS} folds' Gram matrices (K = 2, c "
        f"{FF_CAGRAD_C}): launches (counter, fold counter) {launched}; each fold bitwise equal "
        f"to its own launch {same_alone}/{FF_VMAP_FOLDS}, to the plain version "
        f"{same_plain}/{FF_VMAP_FOLDS}; max abs err {err:.3e}")
    if launched != (1, 1) or same_alone != FF_VMAP_FOLDS or same_plain != FF_VMAP_FOLDS:
        raise RuntimeError(f"cagrad_solver under vmap at K = 2: launches {launched}, bitwise "
                           f"per fold {same_alone}, against the plain version {same_plain}")
    t = {"kernel": time_cuda(lambda: run(grams), warmup=10, reps=200),
         "plain": time_cuda(lambda: cs.cagrad_solve_reference(grams, FF_CAGRAD_C), warmup=0,
                            reps=2),
         "kernel_2": time_cuda(lambda: run(grams), warmup=10, reps=200),
         "singles": time_cuda(singles, warmup=3, reps=50),
         "vmap": time_cuda(vmapped, warmup=10, reps=100),
         "graph": time_cuda_graph(lambda: run(grams), reps=100),
         "singles_graph": time_cuda_graph(singles, reps=20),
         "vmap_graph": time_cuda_graph(vmapped, reps=100)}
    bound_ms, bound_by = _bound(FF_VMAP_FOLDS * 4 * (4 + 2), FF_VMAP_FOLDS * solver_ops(2))
    log(f"[time] {card}: cagrad_solver on {FF_VMAP_FOLDS} folds' Gram matrices (K = 2): one "
        f"launch {t['kernel']:.4f}/{t['kernel_2']:.4f} ms eager, {t['graph']:.4f} ms from a "
        f"CUDA graph; under vmap {t['vmap']:.4f} ms eager, {t['vmap_graph']:.4f} from a graph; "
        f"the {FF_VMAP_FOLDS} single launches it replaces {t['singles']:.4f} ms eager, "
        f"{t['singles_graph']:.4f} from a graph; plain (eager torch on the card, 2 calls) "
        f"{t['plain']:.2f} ms; bound {bound_ms:.3e} ms ({bound_by})")
    return {"max_abs_err": err, "times": {
        "ms": min(t["kernel"], t["kernel_2"]), "plain_ms": t["plain"], "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by, "graph_ms": t["graph"],
        "vmap_ms": t["vmap"], "vmap_graph_ms": t["vmap_graph"], "single_launches_ms":
        t["singles"], "single_launches_graph_ms": t["singles_graph"], "folds": FF_VMAP_FOLDS,
        "k": 2}}


@contextlib.contextmanager
def perturbed_init(module, perturb):
    """While installed, ``module.init_train_state`` first scales each
    parameter of the model it is given by 1 + perturb N(0, 1) (a yardstick
    run: rounding-sized changes of the initial weights)."""
    if not perturb:
        yield
        return
    init, gen = module.init_train_state, torch.Generator().manual_seed(7)

    def perturbed(model, *a, **k):
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.0 + perturb * torch.randn(p.shape, generator=gen))
        return init(model, *a, **k)

    module.init_train_state = perturbed
    try:
        yield
    finally:
        module.init_train_state = init


@contextlib.contextmanager
def sequential_generators(module, store):
    """While installed, each fold's generator that ``module``'s sequential
    driver evaluates with is appended to ``store`` (in fold order)."""
    run_eval = module.run_eval_epoch

    def eval_epoch(runner, state, data, bsz, generator, *a, **k):
        if not store or store[-1] is not generator:
            store.append(generator)
        return run_eval(runner, state, data, bsz, generator, *a, **k)

    module.run_eval_epoch = eval_epoch
    try:
        yield
    finally:
        module.run_eval_epoch = run_eval


@contextlib.contextmanager
def stacked_generators(store):
    """While installed, the stacked run's generators go to ``store``."""
    streams = vc._instance_streams

    def keep(*a):
        rngs, gens = streams(*a)
        store.extend(gens)
        return rngs, gens

    vc._instance_streams = keep
    try:
        yield
    finally:
        vc._instance_streams = streams


def ff_vmap_launches(kind):
    """A stacked FBG/FoG run's launches: a CAGrad multimodal step (``kind``
    None) 1 stream-block forward, 2 backward (one a task pass) and 1 solver
    launch for every fold; a fusion or FOCAL step 1 forward and 1
    backward, the cheap-xattn fusion also 1 cross-attention forward and 1
    backward; an eval forward one forward of each kernel its model uses."""

    def want(steps, evals):
        out = {name: 0 for name in COUNTERS}
        backward = steps if kind else 2 * steps
        out.update(stream_block=steps + evals, stream_block_folds=steps + evals,
                   stream_block_backward=backward, stream_block_backward_folds=backward)
        if kind is None:
            out.update(cagrad_solver=steps, cagrad_solver_folds=steps)
        if kind == "cheap_xattn":
            out.update(cheap_xattn=steps + evals, cheap_xattn_backward=steps)
        return out
    return want


def compare_ff_stacked(tag, seq, yard, stacked, share, want_launches) -> dict:
    """A stacked FBG/FoG run against the sequential runs it replaces, on the
    card, under phase 7's rule. ``seq`` and ``yard``: the sequential runs'
    (per-fold per-epoch train losses {fold: [...]}, per-fold (skel, sensor,
    avg), the folds' generators, seconds), ``yard`` from initial parameters
    scaled by 1 + 1e-7 N(0, 1); ``stacked()`` -> (per-epoch (F, K) losses,
    per-fold (skel, sensor, avg), generators, seconds). The first epoch's
    losses within TRAIN_LOSS_RTOL, later ones within ROUNDING_GAP_FACTOR of
    the yardstick's gap; the accuracies within one eval sample's ``share``;
    every fold's generator bitwise equal at the end; the stacked run a main
    path (counts set to 0 just before it, read just after), its launches
    ``want_launches(steps, evals)``."""
    seq_losses, seq_results, seq_gens, seq_s = seq
    n_folds = len(seq_losses)
    with VmapStepCounter() as counter:
        reset_launches()
        vm_losses, vm_results, vm_gens, vm_s = stacked()
        torch.cuda.synchronize()
        launches = read_launches()
    yard_gaps = loss_gaps(yard[0], seq_losses, n_folds)
    gaps = loss_gaps(vm_losses, seq_losses, n_folds)
    tols = [TRAIN_LOSS_RTOL] + [max(TRAIN_LOSS_RTOL, ROUNDING_GAP_FACTOR * y)
                                for y in yard_gaps[1:]]
    acc_gap = max(abs(a - b) for r, s in zip(vm_results, seq_results) for a, b in zip(r, s))
    same = [torch.equal(a.get_state(), b.get_state()) for a, b in zip(vm_gens, seq_gens)]
    want = want_launches(counter.steps, counter.evals)
    wrong = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    log(f"[vmap] {tag}: {n_folds} folds, {len(gaps)} epoch(s): {counter.steps} stacked train "
        f"steps and {counter.evals} eval forwards in {vm_s:.2f} s, the sequential runs "
        f"{seq_s:.2f} s; launches {launches}")
    log(f"[vmap] {tag}: per-epoch train losses vs sequential, max rel gap by epoch "
        f"{[f'{g:.3e}' for g in gaps]} (tol {[f'{t:.1e}' for t in tols]}; the yardstick "
        f"run's gap {[f'{y:.3e}' for y in yard_gaps]}); (skel, sensor, avg) max gap "
        f"{acc_gap:.4f} points (one eval sample {share:.4f}); each fold's generator state "
        f"bitwise equal to the sequential run's: {sum(same)}/{len(same)}")
    if any(g > t for g, t in zip(gaps, tols)) or acc_gap > share + 1e-4:
        raise RuntimeError(f"{tag}: the stacked run differs from the sequential one")
    if len(same) != n_folds or not all(same):
        raise RuntimeError(f"{tag}: the folds' draws differ from the sequential runs'")
    if counter.steps == 0 or wrong:
        raise RuntimeError(f"{tag}: launches (got, want) {wrong} for {counter.steps} steps")
    return {"launches": launches, "steps": counter.steps, "eval_forwards": counter.evals,
            "seconds": vm_s, "sequential_seconds": seq_s, "loss_gaps": gaps,
            "yardstick_gaps": yard_gaps, "acc_gap": acc_gap, "same_draws": sum(same)}


def compare_fbg_fog_vmapped(seed, dev) -> dict:
    """run_fbg_fog_vmapped for FoG multimodal under GCL and CAGrad (the
    LayerNorm + cosine heads), 2 epochs, every fold of FF_READERS' FoG
    reader (2 train steps of 256 an epoch), against the sequential main on
    the card (compare_ff_stacked)."""
    reader = syn.make_fog_reader(seed=seed, **FF_READERS["fog"])
    args = ff.FbgFogArgs(dataset="fog", modality="multimodal", wm="gcl",
                         use_norm_and_cos=True, epochs=2, seed=seed, verbose=False)
    n_eval = []

    def sequential(perturb):
        losses, results, gens = {}, [], []
        one_fold = ff.train_one_fold

        def keep(*a, **k):
            results.append(one_fold(*a, **k))
            return results[-1]

        def hook(fi, ep, state, tr, ev):
            losses.setdefault(fi, []).append(np.asarray(tr.loss))
            n_eval.append(len(ev.trues[0]))

        ff.train_one_fold = keep
        try:
            with perturbed_init(ff, perturb), sequential_generators(ff, gens):
                t0 = time.perf_counter()
                ff.main(args, on_epoch=hook, reader=reader)
                torch.cuda.synchronize()
        finally:
            ff.train_one_fold = one_fold
        return losses, results, gens, time.perf_counter() - t0

    def stacked():
        losses, results, gens = [], [], []
        folds = vc._fbg_fog_folds_vmapped

        def keep(*a, **k):
            results.extend(folds(*a, **k))
            return results

        vc._fbg_fog_folds_vmapped = keep
        try:
            with stacked_generators(gens):
                t0 = time.perf_counter()
                vc.run_fbg_fog_vmapped(dataclasses.replace(args, verbose=True), reader=reader,
                                       on_epoch=lambda ep, tr, ev: losses.append(tr["loss"]))
                torch.cuda.synchronize()
        finally:
            vc._fbg_fog_folds_vmapped = folds
        return losses, results, gens, time.perf_counter() - t0

    seq = sequential(0.0)
    return compare_ff_stacked("run_fbg_fog_vmapped fog multimodal (GCL, CAGrad)", seq,
                              sequential(ROUNDING_PERTURBATION), stacked, 100.0 / min(n_eval),
                              ff_vmap_launches(None))


def compare_seed_sweep(tag, kind, variant, synced) -> dict:
    """run_baseline_seeds_vmapped of one configuration, seeds FF_SEEDS, 2
    folds a seed, 2 epochs, on synthetic FoG, against baseline_drivers.main
    run once a seed on the card (compare_ff_stacked; the instances in
    (seed, fold) order)."""
    common = dict(synced=synced, epochs=2, n_folds_cap=2, synthetic=True)

    def sequential(perturb):
        losses, results, gens, t0 = {}, [], [], time.perf_counter()
        one_fold = bd.train_fold

        def keep(*a, **k):
            results.append(one_fold(*a, **k))
            return results[-1]

        bd.train_fold = keep
        try:
            with perturbed_init(bd, perturb), sequential_generators(bd, gens):
                for s, seed in enumerate(FF_SEEDS):
                    bd.main(bd.BaselineArgs(kind=kind, dataset="fog", fusion_type=variant,
                                            seed=seed, verbose=False, **common),
                            on_epoch=lambda fi, ep, st, tr, ev, s=s: losses.setdefault(
                                2 * s + fi, []).append(np.asarray(tr.loss)))
            torch.cuda.synchronize()
        finally:
            bd.train_fold = one_fold
        return losses, results, gens, time.perf_counter() - t0

    def stacked():
        losses, gens = [], []
        with stacked_generators(gens):
            t0 = time.perf_counter()
            out = vc.run_baseline_seeds_vmapped(
                "fog", kind, variant, list(FF_SEEDS), verbose=True, **common,
                on_epoch=lambda ep, tr, ev: losses.append(tr["loss"]))
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        # the per-seed means, set against the sequential folds' means below
        return losses, [tuple(out[s][k] for k in ("skel", "sensor", "avg")) for s in FF_SEEDS
                        for _ in range(2)], gens, seconds

    seq = sequential(0.0)
    means = [tuple(np.asarray(seq[1][2 * s:2 * s + 2]).mean(axis=0))
             for s in range(len(FF_SEEDS))]
    # a synthetic FoG fold evaluates 3 subjects' 4 segments
    return compare_ff_stacked(f"run_baseline_seeds_vmapped {tag}",
                              (seq[0], [m for m in means for _ in range(2)], seq[2], seq[3]),
                              sequential(ROUNDING_PERTURBATION), stacked, 100.0 / 12,
                              ff_vmap_launches("cheap_xattn" if kind == "fusion" else kind))


def ff_vmap_step_setup(seed, dev, folds=FF_VMAP_FOLDS, bsz=FF_BATCH):
    """The stacked FBG/FoG step of ``folds`` folds: FoG multimodal under GCL
    and CAGrad at K = 2 (c 0.1), SGD, each fold's own batch of ``bsz``
    window pairs drawn as ff_step_setup draws one (fold f's from seed +
    f), the stacked loss context; the runner and the stacked state."""
    args = ff.FbgFogArgs(dataset="fog", modality="multimodal", seed=seed, use_norm_and_cos=True)
    settings = StepSettings(n_streams=2, wm="gcl", consistency_lambda=0.0, private_grads="sum")
    mtl = make_method("cagrad", 2, c=args.alpha, max_norm=args.max_norm)
    state, partition = vc.init_stacked_state(
        ff.choose_model(args, FBG_FOG_DIMS["fog"]), lambda p: sgd_torch(p, 1e-3, 0.9, 1e-4),
        mtl, folds, dev)
    batches = [ff_step_setup(seed + f, "cpu", bsz)[3] for f in range(folds)]
    batch = {"xs": tuple(torch.stack([b["xs"][i] for b in batches]).to(dev) for i in range(2)),
             "ys": tuple(torch.stack([b["ys"][i] for b in batches]).to(dev) for i in range(2)),
             "valid": torch.ones((folds, bsz), device=dev)}
    ctx = vc.stack_ctx([make_loss_ctx(settings, [[300, 200, 120]] * 2, device=dev)
                        for _ in range(folds)])
    return vc.VmapEpochRunner(settings, mtl, partition), state, batch, ctx


def stacked_syncs(fn) -> list:
    """Host synchronisations in a call of ``fn``, twice (a process's first
    count may read one more), as torch.cuda's sync debug mode reports them."""
    counts = []
    for _ in range(2):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts.append(sum("synchroniz" in str(w.message) for w in caught))
    return counts


def focal_fold_adam_step(seed, dev, folds=FF_VMAP_FOLDS, bsz=FF_BATCH):
    """The stacked FOCAL FoG async step under FoldAdam (AdamW, decay 1e-4,
    the clip 1.0), as run_train_epoch calls it: the host's stepped mask and
    the step's row of the optimizer's plan, made before the call."""
    args = bd.BaselineArgs(kind="focal", seed=seed)
    dims, hp = FBG_FOG_DIMS["fog"], bd._hp(args, "fog")
    settings = StepSettings(n_streams=2, wm="ce", loss_reduction="sum")
    state, _ = vc.init_stacked_state(
        bd._build_model(args, dims, hp, False),
        lambda p: FoldAdam(p, folds, hp["lr"], weight_decay=1e-4, grad_clip=1.0), None, folds,
        dev)
    g = torch.Generator().manual_seed(seed)
    batch = {"xs": (torch.rand((folds, bsz, dims.pose_length, dims.skeleton_input_dim),
                               generator=g).to(dev),
                    torch.randn((folds, bsz, hp["sensor_length"], dims.sensor_in_channels),
                                generator=g).to(dev)),
             "ys": (torch.randint(0, 3, (folds, bsz), generator=g).to(dev),) * 2,
             "valid": torch.ones((folds, bsz), device=dev)}
    ctx = vc.stack_ctx([make_loss_ctx(settings, [[300, 200, 120]] * 2, device=dev)
                        for _ in range(folds)])
    runner = vc.VmapEpochRunner(settings)
    stepped = np.ones((folds, 8), bool)
    plan = state.optimizer.plan(stepped)
    calls = iter(range(8))

    def step():
        b = next(calls)
        return runner.train_step(state, batch, ctx, False, None, None, stepped[:, b], plan[b])

    return step


def time_ff_vmap_step(seed, dev, card, reps=10) -> dict:
    """One stacked FoG multimodal CAGrad step of 3 folds x 256 window pairs
    beside the 3 sequential batch-256 steps it replaces: its launches (one
    step's of ff_vmap_launches), its host synchronisations (0; also in a
    stacked FOCAL step under FoldAdam), wall time (host clock around
    ``reps`` synchronised steps after 3, in turns: stacked, three, three,
    stacked), and each one's device time, kernel launches and idle share
    under the profiler."""
    runner, state, batch, ctx = ff_vmap_step_setup(seed, dev)

    def stacked():
        return runner.train_step(state, batch, ctx, False)

    stacked()
    torch.cuda.synchronize()
    reset_launches()
    stacked()
    torch.cuda.synchronize()
    launches = read_launches()
    want = ff_vmap_launches(None)(1, 0)
    wrong = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    syncs = stacked_syncs(stacked)
    adam_step = focal_fold_adam_step(seed, dev)
    adam_step()
    adam_syncs = stacked_syncs(adam_step)
    log(f"[vmap] one stacked FoG multimodal CAGrad step of {FF_VMAP_FOLDS} folds x {FF_BATCH}: "
        f"launches {launches} (want {want}); host synchronisations {syncs[-1]} (counts "
        f"{syncs}); a stacked FOCAL step under FoldAdam (AdamW, the clip): host "
        f"synchronisations {adam_syncs[-1]} (counts {adam_syncs})")
    if wrong or syncs[-1] != 0 or adam_syncs[-1] != 0:
        raise RuntimeError(f"stacked FoG step: launches (got, want) {wrong}, syncs {syncs}, "
                           f"FoldAdam step syncs {adam_syncs}")
    step, seq_state, seq_ctx, seq_batch, gen = ff_step_setup(seed, dev, FF_BATCH)

    def three():
        for _ in range(FF_VMAP_FOLDS):
            step(seq_state, seq_batch, gen, seq_ctx)

    def host_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps

    turns = {"stacked": [], "three": []}
    for name in ("stacked", "three", "three", "stacked"):
        turns[name].append(host_ms(stacked if name == "stacked" else three))
    prof = {"stacked": profile_steps(stacked, min(PROFILE_REPS, reps)),
            "one": profile_steps(lambda: step(seq_state, seq_batch, gen, seq_ctx),
                                 min(PROFILE_REPS, reps))}
    log(f"[time] {card}: one stacked FoG multimodal CAGrad step of {FF_VMAP_FOLDS} folds x "
        f"{FF_BATCH} window pairs: {turns['stacked'][0]:.3f}/{turns['stacked'][1]:.3f} ms (host "
        f"clock, synchronised); the {FF_VMAP_FOLDS} sequential batch-{FF_BATCH} steps it "
        f"replaces: {turns['three'][0]:.3f}/{turns['three'][1]:.3f} ms "
        f"({turns['three'][0] / FF_VMAP_FOLDS:.3f}/{turns['three'][1] / FF_VMAP_FOLDS:.3f} ms "
        f"a step); profiler, a step: stacked {prof['stacked']}, sequential {prof['one']}")
    return {"stacked_ms": turns["stacked"], "three_sequential_ms": turns["three"],
            "profile": prof, "launches": launches, "syncs": syncs[-1],
            "fold_adam_syncs": adam_syncs[-1]}


def check_ff_cli(card) -> dict:
    """python -m gaitpd_torch.cli --mode fbg_fog --vmap_folds on synthetic
    FoG for 1 epoch, as a subprocess on the card: it exits 0 and prints the
    summary."""
    cmd = [sys.executable, "-m", "gaitpd_torch.cli", "--mode", "fbg_fog", "--dataset", "fog",
           "--synthetic", "--vmap_folds", "--epochs", "1"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=Path(__file__).resolve().parent)
    seconds = time.perf_counter() - t0
    summary = [ln for ln in proc.stdout.splitlines() if ln.startswith("mean skel=")]
    log(f"[cli] {' '.join(cmd[1:])}: exit {proc.returncode} ({seconds:.1f} s); {summary}")
    if proc.returncode != 0 or not summary:
        raise RuntimeError(f"the CLI (fbg_fog --vmap_folds) failed: exit {proc.returncode}\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return {"exit": proc.returncode, "seconds": seconds}


def phase_vmap_fbg_fog(seed, dev, card, rng, commands) -> dict:
    """Phase 10: the stream block under vmap at FBG/FoG's and FOCAL's fold
    shapes and the CAGrad solver under vmap at K = 2, against single-fold
    launches and their plain versions; run_fbg_fog_vmapped and two seed
    sweeps against the sequential drivers on the card; one stacked FoG
    CAGrad step beside the 3 sequential steps; the CLI's --vmap_folds for
    fbg_fog (check_ff_cli, in ``commands``); the fold-stacked block timed at
    FoG's and FOCAL's shapes."""
    t0 = time.perf_counter()
    parts = {}

    def done(part):
        parts[part] = time.perf_counter() - t0 - sum(parts.values())

    errors = check_ff_fold_kernels(rng, dev)
    solver = check_ff_fold_solver(rng, dev, card)
    done("kernels")
    runs = {"fbg_fog": compare_fbg_fog_vmapped(seed, dev)}
    done("run_fbg_fog_vmapped")
    for tag, (kind, variant, synced) in FF_SEED_RUNS.items():
        runs[tag] = compare_seed_sweep(tag, kind, variant, synced)
    done("seed sweeps")
    step = time_ff_vmap_step(seed, dev, card)
    done("timed step")
    cli = commands["ff_cli"]
    times = {}
    for name, key in (("fog", "fbg_fog"), ("focal", "focal_fbg_fog")):
        timed = time_fold_block(rng, dev, card, FF_FOLD_SHAPES[name])
        times[f"stream_block_folds_{key}"] = timed["stream_block_folds"]
        times[f"stream_block_backward_folds_{key}"] = timed["stream_block_backward_folds"]
    times["cagrad_solver_folds_k2"] = solver["times"]
    done("times")
    seconds = time.perf_counter() - t0
    log(f"[vmap] {card}: phase 10: {seconds:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in parts.items())})")
    return {"errors": errors, "solver_error": solver["max_abs_err"], "runs": runs, "step": step,
            "cli": cli, "times": times, "seconds": seconds}


# ---------------------------------------------------------------------------
# 11. the HP grid (--vmap_hp) and the sweep runner
# ---------------------------------------------------------------------------

# the solver's strengths one a matrix: CAGrad's c of the flagship (0.5), of
# FBG/FoG (0.1) and an extreme row (25)
GRID_C_VALUES = (0.1, 0.5, 25.0)
GRID_MATRICES = 40  # 4 grid rows x the CLI's 10 folds
# the flagship's grid at the CLI's defaults: the args' row first (lr 1e-3,
# alpha 0.5), an extreme alpha, a near-zero lr and a larger lr
WEARGAIT_GRID = [{"lr": 1e-3, "alpha": 0.5}, {"lr": 1e-3, "alpha": 25.0},
                 {"lr": 1e-8, "alpha": 0.5}, {"lr": 3e-3, "alpha": 0.5}]
GRID_ROWS = len(WEARGAIT_GRID)
# the fold-stacked block at the grid's instance axis: 40 instances x 3 x 64
# windows at the flagship's shape
GRID_FOLD_SHAPE = (GRID_ROWS * VMAP_FOLDS,) + FOLD_SHAPES["flagship"][1:]


def check_grid_solver(rng, dev, card) -> dict:
    """The CAGrad solver with c one value a matrix (an HP grid's instances):
    40 matrices at K = 3 and K = 2, c cycling through GRID_C_VALUES, in one
    launch (the counter and the per-matrix counter up by one), each matrix's
    w bitwise that of a scalar-c launch of its own and of the plain version;
    the same under torch.func.vmap with a batched c (the fold counter up by
    one too). At K = 3, timed: the merged launch, the vmapped call and the
    40 scalar-c launches it replaces, eager and from a CUDA graph, beside
    the plain version and the bound (40 solves' operations)."""
    out = {}
    for k in (3, 2):
        grams = torch.from_numpy(mtl_solver_grams(rng, GRID_MATRICES, k)[:GRID_MATRICES]).to(dev)
        cvals = [GRID_C_VALUES[i % 3] for i in range(GRID_MATRICES)]
        c = torch.tensor(cvals, dtype=torch.float32, device=dev)

        def counts():
            got = read_launches()
            return tuple(got[n] for n in ("cagrad_solver", "cagrad_solver_folds",
                                          "cagrad_solver_per_matrix_c"))

        before = counts()
        direct = cs.cagrad_solve(grams, c)
        torch.cuda.synchronize()
        mid = counts()
        vmapped = torch.func.vmap(cs.cagrad_solve)(grams, c)
        torch.cuda.synchronize()
        after = counts()
        launched = (tuple(m - b for m, b in zip(mid, before)),
                    tuple(a - m for a, m in zip(after, mid)))
        singles = torch.stack([cs.cagrad_solve(g, cv) for g, cv in zip(grams, cvals)])
        want = cs.cagrad_solve_reference(grams, c)
        same = {"direct_vs_scalar": bitwise_rows(direct, singles),
                "direct_vs_plain": bitwise_rows(direct, want),
                "vmap_vs_scalar": bitwise_rows(vmapped, singles),
                "vmap_vs_plain": bitwise_rows(vmapped, want)}
        err = max((direct - want).abs().max().item(), (vmapped - want).abs().max().item())
        log(f"[kernel] cagrad_solver with c per matrix: {GRID_MATRICES} Gram matrices (K = {k}, "
            f"c in {GRID_C_VALUES}): launches (counter, fold counter, per-matrix counter) "
            f"direct {launched[0]}, under vmap {launched[1]}; bitwise equal (of "
            f"{GRID_MATRICES}) {same}; max abs err {err:.3e}")
        if (launched != ((1, 0, 1), (1, 1, 1))
                or any(v != GRID_MATRICES for v in same.values())):
            raise RuntimeError(f"cagrad_solver with c per matrix at K = {k}: launches "
                               f"{launched}, bitwise {same}")
        out[f"k{k}"] = {"max_abs_err": err, "bitwise": same}
        if k != 3:
            continue

        def run():
            return cs.cagrad_solve(grams, c)

        def scalar_launches():
            return [cs.cagrad_solve(g, cv) for g, cv in zip(grams, cvals)]

        def vmapped_call():
            return torch.func.vmap(cs.cagrad_solve)(grams, c)

        t = {"kernel": time_cuda(run, warmup=10, reps=200),
             "plain": time_cuda(lambda: cs.cagrad_solve_reference(grams, c), warmup=0, reps=2),
             "kernel_2": time_cuda(run, warmup=10, reps=200),
             "singles": time_cuda(scalar_launches, warmup=2, reps=20),
             "vmap": time_cuda(vmapped_call, warmup=10, reps=100),
             "graph": time_cuda_graph(run, reps=100),
             "singles_graph": time_cuda_graph(scalar_launches, reps=10),
             "vmap_graph": time_cuda_graph(vmapped_call, reps=100)}
        bound_ms, bound_by = _bound(GRID_MATRICES * 4 * (k * k + 1 + k),
                                    GRID_MATRICES * solver_ops(k))
        log(f"[time] {card}: cagrad_solver with c per matrix on {GRID_MATRICES} Gram matrices "
            f"(K = {k}): one launch {t['kernel']:.4f}/{t['kernel_2']:.4f} ms eager, "
            f"{t['graph']:.4f} ms from a CUDA graph; under vmap {t['vmap']:.4f} ms eager, "
            f"{t['vmap_graph']:.4f} from a graph; the {GRID_MATRICES} scalar-c launches it "
            f"replaces {t['singles']:.4f} ms eager, {t['singles_graph']:.4f} from a graph; plain "
            f"(eager torch on the card, 2 calls) {t['plain']:.2f} ms; bound {bound_ms:.3e} ms "
            f"({bound_by})")
        out["times"] = {
            "ms": min(t["kernel"], t["kernel_2"]), "plain_ms": t["plain"], "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by, "graph_ms": t["graph"],
            "vmap_ms": t["vmap"], "vmap_graph_ms": t["vmap_graph"],
            "scalar_launches_ms": t["singles"], "scalar_launches_graph_ms": t["singles_graph"],
            "matrices": GRID_MATRICES, "k": k}
    return out


def check_fold_sgd(rng, dev) -> dict:
    """FoldSGD (an lr an instance) against sgd_torch run instance by
    instance on the card, 3 steps at lrs 1e-3, 3e-3, 1e-8 and 10 on leaves
    of the flagship's shapes: the leaves and momenta that are bitwise
    equal, and the largest gap relative to the largest value (the CPU holds
    them bitwise: tests/test_torch_hp_search.py)."""
    from gaitpd_torch.train.optim import FoldSGD

    lrs = [1e-3, 3e-3, 1e-8, 10.0]
    shapes = [(3, 12, 16), (16,), (2, 8), (1000,)]
    p0 = [torch.from_numpy(rng.normal(size=(len(lrs),) + s).astype(np.float32)).to(dev)
          for s in shapes]
    grads = [[torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)).to(dev) for p in p0]
             for _ in range(3)]
    leaves = [p.clone().requires_grad_() for p in p0]
    opt = FoldSGD(leaves, lr=torch.tensor(lrs, device=dev))
    for gs in grads:
        for p, g in zip(leaves, gs):
            p.grad = g.clone()
        opt.step()
    same, total, gap = 0, 0, 0.0
    for i, lr in enumerate(lrs):
        own = [p[i].clone().requires_grad_() for p in p0]
        ref = sgd_torch(own, lr=lr)
        for gs in grads:
            for p, g in zip(own, gs):
                p.grad = g[i].clone()
            ref.step()
        for p, q in zip(leaves, own):
            pairs = ((p.detach()[i], q.detach()),
                     (opt.state[p]["momentum_buffer"][i], ref.state[q]["momentum_buffer"]))
            for a, b in pairs:
                total += 1
                same += int(torch.equal(a, b))
                gap = max(gap, ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item())
    log(f"[hp] FoldSGD vs sgd_torch instance by instance on the card (lrs {lrs}, 3 steps): "
        f"bitwise equal {same}/{total} leaves and momenta; largest gap {gap:.3e} of the "
        f"largest value")
    if gap > STEP_PARAM_TOL:
        raise RuntimeError(f"FoldSGD departs from sgd_torch on the card: {gap}")
    return {"bitwise": same, "of": total, "gap": gap}


@contextlib.contextmanager
def perturbed_stacked_init(perturb):
    """While installed, vmap_cv.init_stacked_state first scales each
    parameter of the model it is given by 1 + perturb N(0, 1): a yardstick
    run of the stacked runner."""
    init, gen = vc.init_stacked_state, torch.Generator().manual_seed(7)

    def perturbed(models, *a, **k):
        with torch.no_grad():
            for p in models.parameters():
                p.mul_(1.0 + perturb * torch.randn(p.shape, generator=gen).to(p.device))
        return init(models, *a, **k)

    vc.init_stacked_state = perturbed
    try:
        yield
    finally:
        vc.init_stacked_state = init


def epoch_gaps(got, want) -> list:
    """Per epoch, the largest relative gap between two runs' (F, K) train
    losses; raises on a non-finite loss."""
    gaps = []
    for ep, (a, b) in enumerate(zip(got, want), 1):
        if not (np.all(np.isfinite(a)) and np.all(np.isfinite(b))):
            raise RuntimeError(f"epoch {ep}: non-finite losses")
        gaps.append(float((np.abs(a - b) / np.abs(b)).max()))
    return gaps


def stacked_run(fn, *a, **k) -> dict:
    """``fn(*a, on_epoch=..., **k)`` on the card as a main path: every count
    set to 0 just before it and read just after; its per-epoch train losses
    (F, K), its generators, its stacked steps and eval forwards, seconds."""
    losses, gens = [], []
    with VmapStepCounter() as counter, stacked_generators(gens):
        reset_launches()
        t0 = time.perf_counter()
        res = fn(*a, on_epoch=lambda ep, tr, ev: losses.append(tr["loss"]), **k)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
    return {"result": res, "losses": losses, "gens": gens, "steps": counter.steps,
            "evals": counter.evals, "seconds": seconds, "launches": launches}


def hold_grid_row(tag, grid_run, plain_run, grid, row, n_folds, share, yard,
                  want_launches) -> dict:
    """Row ``row`` of ``grid``'s run against a plain stacked run under phase 7's
    rule: epoch 1's losses within TRAIN_LOSS_RTOL, later epochs' within
    ROUNDING_GAP_FACTOR of the yardstick's gap ``yard`` (at least
    TRAIN_LOSS_RTOL); each fold's best within one eval window's ``share``;
    each instance's generator bitwise its fold's in the plain run at the
    end; the grid run's launches ``want_launches(steps, evals)``."""
    rows = grid_run["result"]["table"]
    mine = [ep[row * n_folds:(row + 1) * n_folds] for ep in grid_run["losses"]]
    gaps = epoch_gaps(mine, plain_run["losses"])
    tols = [TRAIN_LOSS_RTOL] + [max(TRAIN_LOSS_RTOL, ROUNDING_GAP_FACTOR * y) for y in yard[1:]]
    best = next(r for r in rows if r["hp"] == grid[row])["per_fold"]
    plain_best = plain_run["result"]["per_fold_macro"]
    macro_gap = max(abs(a - b) for a, b in zip(best, plain_best))
    n_inst = len(grid_run["gens"])
    same = sum(torch.equal(g.get_state(), plain_run["gens"][i % n_folds].get_state())
               for i, g in enumerate(grid_run["gens"]))
    want = want_launches(grid_run["steps"], grid_run["evals"])
    launches = grid_run["launches"]
    wrong = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    log(f"[hp] {tag}: {n_inst} instances, {grid_run['steps']} stacked train steps and "
        f"{grid_run['evals']} eval forwards in {grid_run['seconds']:.2f} s (the plain stacked "
        f"run of {n_folds} folds {plain_run['seconds']:.2f} s); launches {launches}")
    log(f"[hp] {tag}: row {row} vs the plain run, max rel loss gap by epoch "
        f"{[f'{g:.3e}' for g in gaps]} (tol {[f'{t:.1e}' for t in tols]}; yardstick "
        f"{[f'{y:.3e}' for y in yard]}); best macro max gap {macro_gap:.4f} points (one eval "
        f"window {share:.4f}); each instance's generator bitwise its fold's: {same}/{n_inst}")
    if any(g > t for g, t in zip(gaps, tols)) or macro_gap > share + 1e-4:
        raise RuntimeError(f"{tag}: row {row} differs from the plain stacked run")
    if same != n_inst:
        raise RuntimeError(f"{tag}: the instances' generators differ from their folds'")
    if grid_run["steps"] == 0 or wrong:
        raise RuntimeError(f"{tag}: launches (got, want) {wrong}")
    return {"launches": launches, "steps": grid_run["steps"], "evals": grid_run["evals"],
            "seconds": grid_run["seconds"], "plain_seconds": plain_run["seconds"],
            "loss_gaps": gaps, "yardstick_gaps": yard, "macro_gap": macro_gap,
            "same_draws": same}


def grid_launches(want_plain):
    """The grid run's launches: the plain run's law, and the solver's
    per-matrix launches one a step (the alpha axis)."""
    def want(steps, evals):
        return {**want_plain(steps, evals), "cagrad_solver_per_matrix_c": steps}
    return want


def rows_differ(grid_run, rows, n_folds) -> list:
    """Whether each of ``rows`` trains otherwise than row 0: its last
    epoch's losses beyond 1e-4 relative of row 0's."""
    last = grid_run["losses"][-1]
    base = last[:n_folds]
    return [bool(np.any(np.abs(last[r * n_folds:(r + 1) * n_folds] - base) > 1e-4 * np.abs(base)))
            for r in rows]


def compare_weargait_grid(seed, dev) -> dict:
    """run_weargait_hp_vmapped at the CLI's defaults (10 folds,
    test_per_class 8), GCL + CAGrad c 0.5, 2 sync epochs, WEARGAIT_GRID (40
    instances), against run_cv_vmapped on the card (hold_grid_row: the
    yardstick run_cv_vmapped again from parameters scaled by 1 + 1e-7 N(0,
    1)); the other rows train otherwise; one solver launch a stacked step,
    reading c one value a matrix."""
    from gaitpd_torch.train.hp_search import run_weargait_hp_vmapped

    args = wg.WearGaitArgs(synthetic=True, seed=seed, batch_size=64, wm="gcl", alpha=0.5,
                           noise_mul=0.0, verbose=False, patience=50, epochs=2, **VMAP_CV)
    plain = stacked_run(vc.run_cv_vmapped, args)
    with perturbed_stacked_init(ROUNDING_PERTURBATION):
        yard = epoch_gaps(stacked_run(vc.run_cv_vmapped, args)["losses"], plain["losses"])
    grid = stacked_run(run_weargait_hp_vmapped, args, WEARGAIT_GRID)
    out = hold_grid_row("weargait grid (GCL, CAGrad)", grid, plain, WEARGAIT_GRID, 0, VMAP_FOLDS,
                        vmap_share(args), yard, grid_launches(flagship_launches))
    differ = rows_differ(grid, range(1, GRID_ROWS), VMAP_FOLDS)
    ranked = [(r["hp"], round(r["macro_mean"], 4)) for r in grid["result"]["table"]]
    log(f"[hp] weargait grid: rows 1-{GRID_ROWS - 1} ({WEARGAIT_GRID[1:]}) train otherwise "
        f"than row 0: {differ}; ranked {ranked}")
    if not all(differ):
        raise RuntimeError(f"weargait grid: rows that train as row 0: {differ}")
    return out


def compare_baseline_grid(seed, dev) -> dict:
    """run_weargait_hp_vmapped of the cheap-xattn fusion at the CLI's
    defaults, lrs 1e-3 and 3e-3 (FoldSGD), 1 epoch, against run_cv_vmapped
    of the baseline on the card (hold_grid_row at one epoch); the second
    row trains otherwise."""
    from gaitpd_torch.train.hp_search import run_weargait_hp_vmapped

    args = wg.WearGaitArgs(synthetic=True, seed=seed, batch_size=64, baseline="cheap_xattn",
                           verbose=False, patience=50, epochs=1, **VMAP_CV)
    plain = stacked_run(vc.run_cv_vmapped, args)
    rows = [{"lr": 1e-3}, {"lr": 3e-3}]
    grid = stacked_run(run_weargait_hp_vmapped, args, rows)
    out = hold_grid_row("cheap_xattn grid (lr axis)", grid, plain, rows, 0, VMAP_FOLDS,
                        vmap_share(args), [0.0], baseline_launches("cheap_xattn"))
    if not rows_differ(grid, [1], VMAP_FOLDS)[0]:
        raise RuntimeError("cheap_xattn grid: lr 3e-3 trains as lr 1e-3")
    return out


def compare_fog_grid(seed, dev) -> dict:
    """run_fbg_fog_hp_vmapped on synthetic FoG multimodal, GCL + CAGrad (c
    0.1), 2 epochs, 2 folds, rows {}, the driver's values written out
    {lr 1e-3, alpha 0.1} and lr 10: the written-out row against the empty
    one, which runs the same arithmetic (losses within TRAIN_LOSS_RTOL
    every epoch, each fold's best within one eval sample's share), and the
    lr 10 row trains otherwise; the launches of a stacked FoG CAGrad run."""
    from gaitpd_torch.train.hp_search import run_fbg_fog_hp_vmapped

    args = ff.FbgFogArgs(dataset="fog", modality="multimodal", wm="gcl", use_norm_and_cos=True,
                         synthetic=True, epochs=2, n_folds_cap=2, seed=seed, verbose=False)
    grid = [{}, {"lr": 1e-3, "alpha": FF_CAGRAD_C}, {"lr": 10.0}]
    run = stacked_run(run_fbg_fog_hp_vmapped, args, grid)
    nf = run["result"]["n_folds"]
    rows = {tuple(sorted(r["hp"].items())): r for r in run["result"]["table"]}
    gaps = epoch_gaps([ep[nf:2 * nf] for ep in run["losses"]], [ep[:nf] for ep in run["losses"]])
    acc_gap = max(abs(a - b) for a, b in zip(rows[tuple(sorted(grid[1].items()))]["per_fold"],
                                             rows[()]["per_fold"]))
    differ = rows_differ(run, [2], nf)[0]
    want = grid_launches(ff_vmap_launches(None))(run["steps"], run["evals"])
    wrong = {k: (run["launches"][k], n) for k, n in want.items() if run["launches"][k] != n}
    log(f"[hp] fog grid (GCL, CAGrad): {len(run['gens'])} instances, {run['steps']} stacked "
        f"steps, {run['evals']} eval forwards in {run['seconds']:.2f} s; launches "
        f"{run['launches']}; the written-out row vs the empty one: max rel loss gap by epoch "
        f"{[f'{g:.3e}' for g in gaps]} (tol {TRAIN_LOSS_RTOL:.0e}), accuracy max gap "
        f"{acc_gap:.4f} points (one eval sample {100.0 / 12:.4f}); lr 10 trains otherwise: "
        f"{differ}; ranked {[(r['hp'], round(r['acc_mean'], 4)) for r in run['result']['table']]}")
    if any(g > TRAIN_LOSS_RTOL for g in gaps) or acc_gap > 100.0 / 12 + 1e-4 or not differ:
        raise RuntimeError("fog grid: the written-out row differs from the empty one, or lr 10 "
                           "trains as it")
    if wrong:
        raise RuntimeError(f"fog grid: launches (got, want) {wrong}")
    return {"launches": run["launches"], "steps": run["steps"], "loss_gaps": gaps,
            "acc_gap": acc_gap, "seconds": run["seconds"]}


def grid_step_setup(seed, dev, bsz=64, fused=False):
    """One stacked step of the flagship's grid at the CLI's defaults
    (with ``fused`` the fused forward):
    WEARGAIT_GRID's 4 rows x 10 folds, each fold's first sync batch of
    ``bsz`` window tuples repeated for every row, each instance's GCL
    scales in its context, c in its method state and lr in FoldSGD
    (hp_search's own helpers); the runner, the stacked state, the batch and
    the context."""
    from gaitpd_torch.train import hp_search as hs

    args, batch, counts = vmap_step_data(seed, dev, bsz)
    args = dataclasses.replace(args, fused=fused)
    settings = StepSettings(n_streams=3, wm="gcl", synchronized=True,
                            private_grads="sum_plus_own")
    ctx = hs._grid_ctx([make_loss_ctx(settings, c, device=dev) for c in counts], WEARGAIT_GRID,
                       args.gcl_m, args.gcl_s, dev)
    mtl = make_method("cagrad", 3, c=0.5)
    state, partition = vc.init_stacked_state(
        wg.build_model(args, True), hs._grid_optimizer(WEARGAIT_GRID, 1e-3, VMAP_FOLDS, 0.9, 1e-4,
                                                       dev),
        mtl, GRID_ROWS * VMAP_FOLDS, dev)
    state.mtl_state["cagrad_c"] = hs._per_instance(WEARGAIT_GRID, "alpha", 0.5, VMAP_FOLDS, dev)

    def rep(t):
        return t.repeat((GRID_ROWS,) + (1,) * (t.dim() - 1))

    grid_batch = {"xs": tuple(rep(x) for x in batch["xs"]),
                  "ys": tuple(rep(y) for y in batch["ys"]), "valid": rep(batch["valid"])}
    return vc.VmapEpochRunner(settings, mtl, partition), state, grid_batch, ctx


def time_grid_step(seed, dev, card, reps=5) -> dict:
    """One stacked step of the flagship's 4 x 10 x 64 grid beside the
    stacked 10-fold step of run_cv_vmapped: the grid step's launches (one
    train step's of the flagship, the solver reading c per matrix) and host
    synchronisations (0), then the host clock around ``reps`` synchronised
    steps after 3 (in turns: grid, folds, folds, grid), and each one's
    device time, kernel launches and idle share under the profiler, with
    the grid step's table by kernel."""
    runner, state, batch, ctx = grid_step_setup(seed, dev)

    def grid():
        return runner.train_step(state, batch, ctx, False)

    grid()
    torch.cuda.synchronize()
    reset_launches()
    grid()
    torch.cuda.synchronize()
    launches = read_launches()
    want = grid_launches(flagship_launches)(1, 0)
    wrong = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    syncs = stacked_syncs(grid)
    log(f"[hp] one stacked grid step ({GRID_ROWS} rows x {VMAP_FOLDS} folds x 64, CAGrad with c "
        f"per instance, FoldSGD): launches {launches} (want {want}); host synchronisations "
        f"{syncs[-1]} (counts {syncs})")
    if wrong or syncs[-1] != 0:
        raise RuntimeError(f"stacked grid step: launches (got, want) {wrong}, syncs {syncs}")
    f_runner, f_state, f_batch, f_ctx, _ = vmap_step_setup(seed, dev)

    def folds():
        return f_runner.train_step(f_state, f_batch, f_ctx, False)

    def host_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps

    turns = {"grid": [], "folds": []}
    for name in ("grid", "folds", "folds", "grid"):
        turns[name].append(host_ms(grid if name == "grid" else folds))
    prof = {"grid": profile_steps(grid, min(PROFILE_REPS, reps), table=(
        f"stacked grid step of {GRID_ROWS} x {VMAP_FOLDS} instances x 64", card)),
            "folds": profile_steps(folds, min(PROFILE_REPS, reps))}
    log(f"[time] {card}: one stacked grid step of {GRID_ROWS} x {VMAP_FOLDS} instances x 64 "
        f"window tuples: {turns['grid'][0]:.3f}/{turns['grid'][1]:.3f} ms (host clock, "
        f"synchronised); the stacked {VMAP_FOLDS}-fold step of run_cv_vmapped: "
        f"{turns['folds'][0]:.3f}/{turns['folds'][1]:.3f} ms; profiler, a step: grid "
        f"{prof['grid']}, folds {prof['folds']}")
    return {"grid_ms": turns["grid"], "folds_ms": turns["folds"], "profile": prof,
            "launches": launches, "syncs": syncs[-1]}


def check_grid_commands(card) -> dict:
    """The CLI's --vmap_hp and the sweep runner as subprocesses on the card:
    python -m gaitpd_torch.cli --mode weargait --vmap_hp (2 lrs x 2 alphas)
    must exit 0 and print the ranked grid, with its 4 rows; meanwhile python
    -m gaitpd_torch.sweep on the FoG cheap-xattn fusion, seeds 0 and 1,
    with --vmap_seeds (done=2 failed=0), then without it (skipped=2
    failed=0): a failed job fails the phase."""
    root = Path(__file__).resolve().parent
    cli = [sys.executable, "-m", "gaitpd_torch.cli", "--mode", "weargait", "--synthetic",
           "--epochs", "1", "--n_folds", "2", "--test_per_class", "3", "--vmap_hp", "--hp_lrs",
           "1e-3", "3e-3", "--hp_alphas", "0.5", "1.0"]
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_sweep_")
    sweep = [sys.executable, "-m", "gaitpd_torch.sweep", "--mode", "fusion", "--dataset", "fog",
             "--synthetic", "--synchronized_loading", "--fusion_types", "cheap_xattn", "--seeds",
             "0", "1", "--epochs", "1", "--n_folds_cap", "1", "--out", out_dir]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cli, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=root)
    try:
        runs = [subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=root)
                for cmd in (sweep + ["--vmap_seeds"], sweep)]
        cli_out, cli_err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    table = cli_out.split("=== HP grid ranked by mean CV macro ===")
    rows = [ln for ln in table[-1].splitlines() if "->" in ln] if len(table) == 2 else []
    log(f"[cli] {' '.join(cli[1:])}: exit {proc.returncode}; ranked grid printed with "
        f"{len(rows)} rows: {rows}")
    if proc.returncode != 0 or len(rows) != 4:
        raise RuntimeError(f"the CLI (--vmap_hp) failed: exit {proc.returncode}\n"
                           f"{cli_out[-2000:]}\n{cli_err[-4000:]}")
    counts = []
    for run, want in zip(runs, ("done=2 skipped=0 failed=0", "done=0 skipped=2 failed=0")):
        last = [ln for ln in run.stdout.splitlines() if ln.startswith("[SWEEP] done=")]
        counts.append(last[-1] if last else None)
        log(f"[cli] {' '.join(run.args[1:])}: exit {run.returncode}; {counts[-1]} (want {want})")
        if run.returncode != 0 or counts[-1] != f"[SWEEP] {want}":
            raise RuntimeError(f"the sweep failed: exit {run.returncode}, {counts[-1]}\n"
                               f"{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
    log(f"[cli] the CLI's grid and both sweeps: {seconds:.1f} s (the CLI alongside the sweeps)")
    return {"cli_exit": proc.returncode, "sweep_counts": counts, "seconds": seconds}


def phase_hp_grid(seed, dev, card, rng, commands) -> dict:
    """Phase 11: the fold-stacked block at the grid's 40 instances and the
    CAGrad solver with c per matrix against single launches and their plain
    versions; the flagship's grid and the
    cheap-xattn fusion's against run_cv_vmapped, FoG's grid rows against
    each other; one stacked grid step beside the stacked 10-fold step; the
    CLI's --vmap_hp and the sweep runner (check_grid_commands, in
    ``commands``); the fold-stacked block timed at the grid's 40
    instances."""
    t0 = time.perf_counter()
    parts = {}

    def done(part):
        parts[part] = time.perf_counter() - t0 - sum(parts.values())

    errors = check_fold_kernels(rng, dev, card, {"grid": GRID_FOLD_SHAPE})
    solver = check_grid_solver(rng, dev, card)
    sgd = check_fold_sgd(rng, dev)
    done("kernels")
    runs = {"weargait": compare_weargait_grid(seed, dev)}
    done("weargait grid")
    runs["cheap_xattn"] = compare_baseline_grid(seed, dev)
    done("cheap_xattn grid")
    runs["fog"] = compare_fog_grid(seed, dev)
    done("fog grid")
    step = time_grid_step(seed, dev, card)
    done("timed step")
    commands = commands["grid"]
    timed = time_fold_block(rng, dev, card, GRID_FOLD_SHAPE)
    times = {"cagrad_solver_per_matrix_c": solver["times"],
             "stream_block_folds_grid": timed["stream_block_folds"],
             "stream_block_backward_folds_grid": timed["stream_block_backward_folds"]}
    done("times")
    seconds = time.perf_counter() - t0
    log(f"[hp] {card}: phase 11: {seconds:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in parts.items())})")
    return {"errors": errors, "solver": {k: v for k, v in solver.items() if k != "times"},
            "fold_sgd": sgd, "runs": runs, "step": step, "commands": commands, "times": times,
            "seconds": seconds}


# ---------------------------------------------------------------------------
# 12. the fused forward (--fused)
# ---------------------------------------------------------------------------

FUSED_BATCH = 1024  # window tuples of the logits check: the backbone sees 3 x 1024 windows
# fused against unfused logits: gaitpd's bound (tests/test_fused.py); stage
# B's kernel addition is the one step that rounds apart
FUSED_LOGIT_TOL = 2e-5
# the heads of the logits check: plain, LayerNorm + cosine (GCL)
FUSED_HEADS = {"plain": (False, False), "norm_cosine": (True, True)}
FUSED_STEP_REPS = {"sequential": 10, "stacked": 8, "grid": 4}  # timed steps a turn
FUSED_TRACE_REPS = 2  # steps a profiler trace


def check_fused_logits(rng, dev) -> dict:
    """The fused flagship against the unfused one on the card, from the
    same parameters, at FUSED_BATCH window tuples and the flagship widths,
    sync and async, plain and LayerNorm + cosine heads: logits within
    FUSED_LOGIT_TOL, finite, and each forward one stream-block launch."""
    xs = [torch.from_numpy(rng.normal(size=(FUSED_BATCH, WIN, CHANNELS[m])).astype(np.float32))
          .to(dev) for m in MODALITIES]
    errors = {}
    for sync in (True, False):
        for head, (use_norm, use_cosine) in FUSED_HEADS.items():
            kw = dict(synchronized=sync, use_norm=use_norm, use_cosine=use_cosine)
            plain = WearGaitThreeModal(**kw, generator=torch.Generator().manual_seed(11)).to(dev)
            fused = FusedWearGaitThreeModal(**kw, generator=torch.Generator().manual_seed(11))
            fused = fused.to(dev)
            outs, counts = [], []
            with torch.no_grad():
                for model in (fused, plain):
                    reset_launches()
                    outs.append(model(*xs))
                    torch.cuda.synchronize()
                    counts.append(read_launches()["stream_block"])
            got, want = outs
            err = max((a - b).abs().max().item() for a, b in zip(got, want))
            finite = all(torch.isfinite(a).all().item() for a in got)
            tag = f"{'sync' if sync else 'async'} {head}"
            errors[tag] = err
            log(f"[fused] logits at {FUSED_BATCH} window tuples, {tag} heads: fused vs unfused "
                f"max abs gap {err:.3e} (tol {FUSED_LOGIT_TOL}); finite {finite}; stream-block "
                f"launches a forward fused/unfused {counts[0]}/{counts[1]}")
            if not finite or err > FUSED_LOGIT_TOL or counts != [1, 1]:
                raise RuntimeError(f"fused logits {tag}: gap {err}, launches {counts}")
    return errors


def fused_launches(steps, evals) -> dict:
    """A sequential fused run's launches: a train step one stream-block
    forward, 3 backward (one a CAGrad task pass) and one solver; an eval
    forward one stream-block forward; nothing wide or fold-stacked."""
    return {"stream_block": steps + evals, "stream_block_backward": 3 * steps,
            "cagrad_solver": steps, "stream_block_wide": 0, "stream_block_backward_wide": 0,
            "stream_block_folds": 0, "stream_block_backward_folds": 0}


def time_steps_in_turns(fns: dict, reps: int) -> dict:
    """Host-clock milliseconds of each of ``reps`` synchronised calls of
    each function (3 warm-up calls first), in turns a, b, b, a: each
    function's median, min and max over its 2 x reps calls."""
    names = list(fns)
    samples = {n: [] for n in names}
    for name in names + names[::-1]:
        fn = fns[name]
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            samples[name].append(1e3 * (time.perf_counter() - t0))
    return {n: {"median_ms": float(np.median(v)), "min_ms": min(v), "max_ms": max(v),
                "p10_ms": float(np.percentile(v, 10)), "p90_ms": float(np.percentile(v, 90))}
            for n, v in samples.items()}


def traced_counts(fn, windows) -> dict:
    """FUSED_TRACE_REPS synchronised calls of ``fn`` under
    gaitpd_torch.runtime.profiling.trace (its Chrome trace written to a
    directory removed after): CUDA kernels a call, cuDNN's weight-gradient
    kernels a call by name, the kernels' summed device time a call, and
    the calls' windows/s from a StepTimer (``windows`` a call; the
    profiler's overhead included)."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    timer = profiling.StepTimer()
    with tempfile.TemporaryDirectory() as tmp, profiling.trace(tmp) as prof:
        timer.reset()
        for _ in range(FUSED_TRACE_REPS):
            fn()
            torch.cuda.synchronize()
            timer.add(windows)
        summary = timer.summary()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    wgrad = {e.key: e.count / FUSED_TRACE_REPS for e in kernels if "wgrad" in e.key}
    return {"kernels": sum(e.count for e in kernels) / FUSED_TRACE_REPS,
            "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3 / FUSED_TRACE_REPS,
            "wgrad_kernels": sum(wgrad.values()), "wgrad_by_name": wgrad,
            "timer": summary}


def time_fused_steps(seed, dev, card) -> dict:
    """The fused train step against the unfused one, where each runs: the
    sequential CAGrad step at batch 64, the stacked 10 x 64 step of
    run_cv_vmapped and the 4 x 10 x 64 grid step. For each, the fused
    step's launches (the unfused step's law: one stream-block forward, 3
    backward, one solver, for all folds or instances), its host clock in
    turns with the unfused one (median and spread), and each one's kernels,
    cuDNN weight-gradient kernels and windows/s under the profiler's
    trace."""
    def sequential(fused):
        step, state, ctx, batch, gen = make_step_setup(seed, dev, 64, fused=fused)
        return lambda: step(state, batch, gen, ctx)

    def stacked(fused):
        runner, state, batch, ctx, gens = vmap_step_setup(seed, dev, fused=fused)
        return lambda: runner.train_step(state, batch, ctx, False, gens)

    def grid(fused):
        runner, state, batch, ctx = grid_step_setup(seed, dev, fused=fused)
        return lambda: runner.train_step(state, batch, ctx, False)

    cases = {"sequential": (sequential, 64, fused_launches),
             "stacked": (stacked, VMAP_FOLDS * 64, flagship_launches),
             "grid": (grid, GRID_ROWS * VMAP_FOLDS * 64, grid_launches(flagship_launches))}
    out = {}
    for name, (setup, windows, law) in cases.items():
        fns = {"fused": setup(True), "unfused": setup(False)}
        fns["fused"]()
        torch.cuda.synchronize()
        reset_launches()
        fns["fused"]()
        torch.cuda.synchronize()
        launches = read_launches()
        want = law(1, 0)
        wrong = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
        if wrong:
            raise RuntimeError(f"fused {name} step: launches (got, want) {wrong}")
        times = time_steps_in_turns(fns, FUSED_STEP_REPS[name])
        counts = {k: traced_counts(fn, windows) for k, fn in fns.items()}
        out[name] = {"times": times, "counts": counts, "launches": launches,
                     "windows": windows}
        log(f"[time] {card}: fused vs unfused {name} CAGrad step ({windows} window tuples): "
            + "; ".join(
                f"{k} median {t['median_ms']:.3f} ms (min {t['min_ms']:.3f}, p10 "
                f"{t['p10_ms']:.3f}, p90 {t['p90_ms']:.3f}, max {t['max_ms']:.3f}; "
                f"{2 * FUSED_STEP_REPS[name]} synchronised steps), traced: "
                f"{counts[k]['kernels']:.1f} kernels, {counts[k]['wgrad_kernels']:.1f} cuDNN "
                f"weight-gradient kernels {counts[k]['wgrad_by_name']}, kernel sum "
                f"{counts[k]['device_ms']:.3f} ms, {counts[k]['timer']['windows_per_sec']} "
                f"windows/s" for k, t in times.items())
            + f"; the fused step's launches {launches}")
    return out


def time_fused_layout(rng, dev, card) -> dict:
    """The stream block at the main shape (3 x 1024 windows) in the fused
    backbone's row order, (b, stream): the forward (the same kernel and
    shape as the unfused path's) and the backward in a CAGrad task pass
    of the fused layout, the walkway's rows (every third) live, held
    against their plain versions (phase 2's rule), then timed: eager and
    from a CUDA graph beside the plain versions, the library calls and the
    bounds; the backward from a graph in turns with the unfused
    stream-major task layout (the first third live) and all rows live."""
    bsz, t, cin, k, cout, t_out, act = MAIN_SHAPE
    x, w, b, g = stream_block_inputs(rng, bsz, t, cin, k, cout, dev, t_out)
    rows = torch.arange(bsz, device=dev)[:, None, None]
    layouts = {"fused": torch.where(rows % 3 == 0, g, torch.zeros_like(g)),
               "stream_major": torch.where(rows < N_WINDOWS, g, torch.zeros_like(g)),
               "all_live": g}
    fwd_err = hold_forward("fused backbone", x, w, b, t_out, act)
    bwd_err = hold_backward("fused (b, stream) task layout", x, w, b, layouts["fused"], t_out,
                            act)[0]
    w_torch = w.permute(2, 1, 0).contiguous()

    def library():
        y = torch.relu(F.conv1d(x.transpose(1, 2), w_torch, b, padding=k // 2))
        return F.adaptive_avg_pool1d(y, t_out).transpose(1, 2)

    leaves = [t_.detach().clone().requires_grad_() for t_ in (x, w, b)]

    def library_backward():
        xl, wl, bl = leaves
        y = torch.relu(F.conv1d(xl.transpose(1, 2), wl.permute(2, 1, 0), bl, padding=k // 2))
        out = F.adaptive_avg_pool1d(y, t_out).transpose(1, 2)
        return torch.autograd.grad(out, leaves, layouts["fused"])

    with torch.inference_mode():
        fwd = {"kernel": time_cuda(lambda: sb.stream_block(x, w, b, t_out)),
               "plain": time_cuda(lambda: sb.stream_block_reference(x, w, b, t_out)),
               "library": time_cuda(library),
               "graph": time_cuda_graph(lambda: sb.stream_block(x, w, b, t_out))}
    bwd = {"kernel": time_cuda(lambda: sb.stream_block_backward(x, w, b, layouts["fused"],
                                                                t_out)),
           "plain": time_cuda(lambda: sb.stream_block_backward_reference(
               x, w, b, layouts["fused"], t_out), warmup=5, reps=50),
           "library": time_cuda(library_backward, warmup=5, reps=50)}
    graph = {name: [] for name in layouts}
    for name in ("fused", "stream_major", "all_live", "all_live", "stream_major", "fused"):
        graph[name].append(time_cuda_graph(
            lambda: sb.stream_block_backward(x, w, b, layouts[name], t_out)))
    fwd_bound = stream_block_bound(bsz, t, cin, k, cout, t_out)
    bwd_bound = stream_block_backward_bound(bsz, t, cin, k, cout, t_out, live=bsz // 3)
    log(f"[time] {card}: stream_block x({bsz},{t},{cin}) in the fused backbone: forward "
        f"kernel {fwd['kernel']:.4f} ms eager, {fwd['graph']:.4f} ms from a CUDA graph, plain "
        f"{fwd['plain']:.4f} ms, library {fwd['library']:.4f} ms, bound {fwd_bound[0]:.5f} ms "
        f"({fwd_bound[1]}); backward in the fused task layout (every third row live): kernel "
        f"{bwd['kernel']:.4f} ms eager, plain {bwd['plain']:.4f} ms, library (autograd, forward "
        f"included) {bwd['library']:.4f} ms, bound {bwd_bound[0]:.5f} ms ({bwd_bound[1]}); "
        f"from a CUDA graph in turns (device only): fused layout "
        f"{'/'.join(f'{v:.4f}' for v in graph['fused'])} ms, stream-major layout "
        f"{'/'.join(f'{v:.4f}' for v in graph['stream_major'])} ms, all rows live "
        f"{'/'.join(f'{v:.4f}' for v in graph['all_live'])} ms")
    return {
        "errors": (fwd_err, bwd_err),
        "stream_block_fused": {"ms": fwd["kernel"], "plain_ms": fwd["plain"],
                               "library_ms": fwd["library"], "bound_ms": fwd_bound[0],
                               "bound_by": fwd_bound[1], "graph_ms": fwd["graph"]},
        "stream_block_backward_fused": {
            "ms": bwd["kernel"], "plain_ms": bwd["plain"], "library_ms": bwd["library"],
            "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
            "graph_ms": min(graph["fused"]), "stream_major_graph_ms": min(graph["stream_major"]),
            "all_live_graph_ms": min(graph["all_live"])},
    }


def phase_fused(seed, dev, card, rng) -> dict:
    """Phase 12: the fused forward. Fused against unfused logits on the
    card; one fused CAGrad step card vs CPU (phase 4's tolerances); a fused
    run_cv card vs CPU (sync, 2 epochs; phase 4's rules, and a train step 1
    stream-block forward, 3 backward and 1 solver launch, an eval forward
    1 forward); a fused run_cv_vmapped against the sequential fused run on
    the card (phase 7's rule, 1 sync epoch); the fused and unfused
    sequential, stacked and grid steps timed and traced; the stream block in
    the fused backbone's row order, checked and timed."""
    t0 = time.perf_counter()
    parts = {}

    def done(part):
        parts[part] = time.perf_counter() - t0 - sum(parts.values())

    logits = check_fused_logits(rng, dev)
    layout = time_fused_layout(rng, dev, card)
    done("kernels and logits")
    compare_one_step("fused CAGrad step at batch 64", dev,
                     lambda device: make_step_setup(seed, device, 64, fused=True))
    runs = compare_run_cv("fused", dict(train_common(seed), fused=True), (("sync", 2),),
                          fused_launches(1, 0), ("stream_block",),
                          per_eval_forward={"stream_block": 1})
    done("run_cv")
    common = dict(synthetic=True, seed=seed, batch_size=64, wm="gcl", alpha=0.5, noise_mul=0.0,
                  verbose=False, patience=50, fused=True, **VMAP_RUN_CV)
    runs["vmap sync"] = compare_vmapped_run(wg.WearGaitArgs(epochs=1, **common),
                                            "vmap_folds fused sync", flagship_launches)
    done("run_cv_vmapped")
    steps = time_fused_steps(seed, dev, card)
    done("timed steps")
    seconds = time.perf_counter() - t0
    log(f"[fused] {card}: phase 12: {seconds:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in parts.items())})")
    return {"logits": logits, "errors": layout["errors"], "runs": runs, "steps": steps,
            "times": {k: layout[k] for k in ("stream_block_fused",
                                             "stream_block_backward_fused")},
            "seconds": seconds}


# ---------------------------------------------------------------------------
# 13. remat (StepSettings.remat) and the data-parallel mesh
# ---------------------------------------------------------------------------

REMAT_POLICIES = ("none", "dots", "nothing")
# stream-block launches of one CAGrad step (K = 3) under each policy:
# "nothing" recomputes the forward in each of the K task passes
REMAT_LAUNCHES = {"none": {"stream_block": 1, "stream_block_backward": 3},
                  "dots": {"stream_block": 1, "stream_block_backward": 3},
                  "nothing": {"stream_block": 4, "stream_block_backward": 3}}
REMAT_STEP_REPS = 20  # timed steps a policy and batch, each synchronised


def remat_step_times(seed, dev, policy) -> dict:
    """At each of TRAIN_BATCHES, the median host-clock time of a
    synchronised CAGrad step under ``policy`` (after 3) and the card's peak
    memory in one step."""
    out = {}
    for bsz in TRAIN_BATCHES:
        step, state, ctx, batch, gen = make_step_setup(seed, dev, bsz, remat=policy)
        for _ in range(3):
            step(state, batch, gen, ctx)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(state, batch, gen, ctx)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = []
        for _ in range(REMAT_STEP_REPS):
            t0 = time.perf_counter()
            step(state, batch, gen, ctx)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        out[f"batch{bsz}"] = {"median_ms": float(np.median(ms)), "peak_bytes_above_state": peak}
    return out


def check_remat_steps(seed, dev, card) -> dict:
    """The flagship's CAGrad step at batch 64 under each remat policy: card
    vs CPU as in phase 4, then on the card against the "none" step from the
    same parameters and batch (phase 4's tolerances), with its stream-block
    launches (REMAT_LAUNCHES); then its median time and peak memory at
    each of TRAIN_BATCHES."""
    out, ref = {}, None
    for policy in REMAT_POLICIES:
        compare_one_step(f"CAGrad step at batch 64, remat {policy}", dev,
                         lambda device, p=policy: make_step_setup(seed, device, 64, remat=p))
        step, state, ctx, batch, gen = make_step_setup(seed, dev, 64, remat=policy)
        torch.cuda.synchronize()
        reset_launches()
        step(state, batch, gen, ctx)
        torch.cuda.synchronize()
        launches = read_launches()
        params = [p.detach().clone() for p in state.module.parameters()]
        momenta = [state.optimizer.state[p]["momentum_buffer"].clone()
                   for p in state.module.parameters()]
        if ref is None:
            ref = (params, momenta)
        gaps = [max((a - b).abs().max().item() for a, b in zip(got, want))
                for got, want in ((params, ref[0]), (momenta, ref[1]))]
        scale = [max(1.0, max(w.abs().max().item() for w in want)) for want in ref]
        bitwise = all(torch.equal(a, b) for a, b in zip(params + momenta, ref[0] + ref[1]))
        want = REMAT_LAUNCHES[policy]
        got = {k: launches[k] for k in want}
        times = remat_step_times(seed, dev, policy)
        log(f"[remat] {card}: CAGrad step under remat {policy}: stream-block launches {got} "
            f"(want {want}); against remat none on the card: parameters max abs gap "
            f"{gaps[0]:.3e} (tol {STEP_PARAM_TOL * scale[0]:.2e}), momentum {gaps[1]:.3e} (tol "
            f"{STEP_MOMENTUM_TOL * scale[1]:.2e}), bitwise equal {bitwise}; "
            + "; ".join(f"batch {b[5:]}: median {t['median_ms']:.3f} ms a step, peak memory "
                        f"{t['peak_bytes_above_state'] / 2**20:.2f} MiB above the state"
                        for b, t in times.items()))
        if got != want:
            raise RuntimeError(f"remat {policy}: stream-block launches {got}, want {want}")
        if gaps[0] > STEP_PARAM_TOL * scale[0] or gaps[1] > STEP_MOMENTUM_TOL * scale[1]:
            raise RuntimeError(f"remat {policy}: the step differs from remat none: {gaps}")
        out[policy] = {"launches": got, "gaps_vs_none": gaps, "bitwise_vs_none": bitwise,
                       "times": times}
    return out


def check_remat_draws(seed, dev) -> dict:
    """DeepAV-Lite at dropout 0.1 (its masks drawn inside the recomputed
    forward) one step on the card under each remat policy from the same
    parameters, batch and generator: under "nothing" the masks the
    recomputation draws are bitwise the first forward's; the parameters and
    momentum equal the "none" step's (phase 4's tolerances), and the
    generator ends where the "none" step leaves it, bitwise."""
    out, ref = {}, None
    rand = fold_draws.rand
    for policy in REMAT_POLICIES:
        masks = []

        def recorded(*a, **k):
            masks.append(rand(*a, **k))
            return masks[-1]

        step, state, ctx, batch, gen = make_step_setup(seed, dev, 64, "deepav_lite", remat=policy)
        fold_draws.rand = recorded
        try:
            step(state, batch, gen, ctx)
        finally:
            fold_draws.rand = rand
        torch.cuda.synchronize()
        first = masks if policy != "nothing" else masks[:len(masks) // 2]
        replayed = (policy != "nothing" or (len(masks) % 2 == 0 and all(
            torch.equal(a, b) for a, b in zip(first, masks[len(first):]))))
        params = [p.detach().clone() for p in state.module.parameters()]
        momenta = [state.optimizer.state[p]["momentum_buffer"].clone()
                   for p in state.module.parameters()]
        if ref is None:
            ref = (params, momenta, gen.get_state(), len(masks))
        gaps = [max((a - b).abs().max().item() for a, b in zip(got, want))
                for got, want in ((params, ref[0]), (momenta, ref[1]))]
        scale = [max(1.0, max(w.abs().max().item() for w in want)) for want in ref[:2]]
        same_gen = torch.equal(gen.get_state(), ref[2])
        log(f"[remat] DeepAV-Lite step (dropout {DROPOUT_RATE}) under remat {policy} on the "
            f"card: {len(masks)} dropout draws ({len(first)} in the first forward), the "
            f"recomputed ones bitwise the first's: {replayed}; against remat none: parameters "
            f"max abs gap {gaps[0]:.3e}, momentum {gaps[1]:.3e}; generator bitwise where remat "
            f"none leaves it: {same_gen}")
        if (not replayed or len(first) != ref[3] or not same_gen
                or gaps[0] > STEP_PARAM_TOL * scale[0] or gaps[1] > STEP_MOMENTUM_TOL * scale[1]):
            raise RuntimeError(f"remat {policy}: the dropout step differs from remat none")
        out[policy] = {"draws": len(masks), "replayed": replayed, "gaps_vs_none": gaps}
    return out


def check_mesh_step(seed, dev) -> dict:
    """The data-parallel CAGrad step at batch 64 over a mesh of one rank
    (make_mesh on the card: NCCL) against the step without a mesh from the
    same parameters and batch, with the recipe's draws (RowShard), within
    phase 4's tolerances (and whether bitwise); an all_reduce and an
    all_gather_object over the group; the group is destroyed after."""
    mesh = make_mesh()
    try:
        group = mesh.get_group()
        t = torch.full((3,), 2.0, device=dev)
        torch.distributed.all_reduce(t, group=group)
        gathered = [None]
        torch.distributed.all_gather_object(gathered, "rank0", group=group)
        runs = {}
        for name, sharding in (("mesh", mesh_sharding(mesh)), ("none", None)):
            step, state, ctx, batch, gen = make_step_setup(seed, dev, 64, recipe=True,
                                                           sharding=sharding)
            _, metrics = step(state, batch, gen, ctx)
            runs[name] = ([p.detach().clone() for p in state.module.parameters()]
                          + [state.optimizer.state[p]["momentum_buffer"].clone()
                             for p in state.module.parameters()], metrics, gen.get_state())
        gap = max((a - b).abs().max().item() for a, b in zip(runs["mesh"][0], runs["none"][0]))
        scale = max(1.0, max(w.abs().max().item() for w in runs["none"][0]))
        bitwise = all(torch.equal(a, b) for a, b in zip(runs["mesh"][0], runs["none"][0]))
        same_gen = torch.equal(runs["mesh"][2], runs["none"][2])
        log(f"[mesh] data-parallel CAGrad step (recipe draws) over a 1-rank NCCL mesh "
            f"({torch.distributed.get_backend()}; all_reduce {t.tolist()}, all_gather_object "
            f"{gathered}) vs no mesh: parameters and momentum max abs gap {gap:.3e} (tol "
            f"{STEP_PARAM_TOL * scale:.2e}), bitwise equal {bitwise}; generators bitwise "
            f"equal {same_gen}; losses {runs['mesh'][1]['losses'].tolist()}")
        if gap > STEP_PARAM_TOL * scale or not same_gen or t.tolist() != [2.0] * 3:
            raise RuntimeError("the 1-rank data-parallel step differs from the plain step")
        return {"gap": gap, "bitwise": bitwise, "backend": torch.distributed.get_backend()}
    finally:
        torch.distributed.destroy_process_group()


def run_group(cmd, timeout) -> subprocess.CompletedProcess:
    """``cmd`` on the card in a session of its own, its output captured; on
    a timeout or an error every process of the session (a dry run's spawned
    ranks too) is killed before this returns or raises."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=Path(__file__).resolve().parent, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    return subprocess.CompletedProcess(cmd, proc.returncode, stdout, stderr)


def check_mesh_commands(card) -> dict:
    """Phase 13's subprocesses on the card: python -m gaitpd_torch.entry
    multichip 2 (two spawned ranks of a gloo group sharing the card run
    gaitpd's dry-run phases: the data-parallel step against the
    single-process step, fold-sharded run_cv_vmapped sync and async and the
    sharded HP grid against single-process runs) must exit 0 and print that
    every phase passed; the CLI with --data_parallel (a 1-rank NCCL mesh)
    must print the mesh line and the 7-subset table."""
    cmds = {"dryrun": [sys.executable, "-m", "gaitpd_torch.entry", "multichip", "2"],
            "cli_data_parallel": [sys.executable, "-m", "gaitpd_torch.cli", "--mode", "weargait",
                                  "--synthetic", "--epochs", "1", "--n_folds", "2",
                                  "--test_per_class", "3", "--data_parallel"]}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(cmds)) as pool:
        futures = {k: pool.submit(run_group, c, 900) for k, c in cmds.items()}
        runs = {k: f.result() for k, f in futures.items()}
    seconds = time.perf_counter() - t0
    dry, cli = runs["dryrun"], runs["cli_data_parallel"]
    phases = [ln for ln in dry.stdout.splitlines() if ln.startswith(("[dryrun", "dryrun_"))]
    log(f"[mesh] python -m gaitpd_torch.entry multichip 2: exit {dry.returncode}; "
        f"{phases}")
    if dry.returncode != 0 or "dryrun_multichip(2) OK" not in dry.stdout:
        raise RuntimeError(f"the dry run failed: exit {dry.returncode}\n{dry.stdout[-3000:]}\n"
                           f"{dry.stderr[-4000:]}")
    mesh_line = [ln for ln in cli.stdout.splitlines() if ln.startswith("Data-parallel mesh")]
    table = all(f"[{mk:5}]" in cli.stdout for mk in wg.MASK_COMBOS)
    log(f"[mesh] {' '.join(cli.args[1:])}: exit {cli.returncode}; {mesh_line}; 7-subset table "
        f"printed: {table} ({seconds:.1f} s for both at once)")
    if cli.returncode != 0 or mesh_line != ["Data-parallel mesh over 1 device(s)"] or not table:
        raise RuntimeError(f"the CLI (--data_parallel) failed: exit {cli.returncode}\n"
                           f"{cli.stdout[-2000:]}\n{cli.stderr[-4000:]}")
    return {"dryrun_exit": dry.returncode, "cli_exit": cli.returncode, "seconds": seconds}


def run_commands(card) -> dict:
    """The subprocess checks of phases 7, 10, 11 and 13, all at once, the
    main process waiting: the CLI with and without --vmap_folds
    (check_cli_runs), the FBG/FoG CLI (check_ff_cli), the CLI's grid and
    the sweeps (check_grid_commands), the dry run and --data_parallel
    (check_mesh_commands). Each is a process of its own on the card, so
    their start-ups (imports, the card's context, the kernels' libraries)
    overlap instead of adding up."""
    checks = {"cli": check_cli_runs, "ff_cli": check_ff_cli, "grid": check_grid_commands,
              "mesh": check_mesh_commands}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(checks)) as pool:
        futures = {name: pool.submit(check, card) for name, check in checks.items()}
        out = {name: f.result() for name, f in futures.items()}
    log(f"[cli] the subprocess checks of phases 7, 10, 11 and 13 at once: "
        f"{time.perf_counter() - t0:.1f} s")
    return out

def phase_remat_mesh(dev, card, rng, commands) -> dict:
    """Phase 13: remat on the card (check_remat_steps, check_remat_draws),
    the data-parallel step over a 1-rank NCCL mesh (check_mesh_step), each
    from models, batches and generators seeded from ``rng``; and the dry
    run and the CLI's --data_parallel (check_mesh_commands, run with the
    other phases' subprocesses: ``commands``)."""
    t0 = time.perf_counter()
    seed = int(rng.integers(1 << 30))
    remat = check_remat_steps(seed, dev, card)
    draws = check_remat_draws(seed, dev)
    mesh = check_mesh_step(seed, dev)
    seconds = time.perf_counter() - t0
    log(f"[remat] {card}: phase 13: {seconds:.1f} s in this process")
    return {"remat": remat, "remat_draws": draws, "mesh": mesh, "commands": commands,
            "seconds": seconds}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    _LAP[0] = t_start
    dev = resolve_device("cuda")
    rng = np.random.default_rng(args.seed)
    card, builds, t_build = phase_device()
    lap("1_device_build")
    sb_errors = check_stream_block(
        rng, dev, [n for n in STREAM_BLOCK_CASES if n not in FUSION_WIDTH_CASES])
    solver_err = check_solver(rng, dev)
    lap("2_kernels")
    engine, serve_launches = phase_serving(args.seed, rng)
    lap("3_serving")
    training = phase_training(args.seed, dev)
    lap("4_training")
    finish_builds(builds, t_build)
    lap("1_device_build_rest")
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
    check_xattn_with_launches(np.random.default_rng([args.seed, 17]), dev, card)
    print_xattn_configs(card)
    check_forward_edges(np.random.default_rng([args.seed, 8]), dev, card)
    check_solver_each_k(np.random.default_rng([args.seed, 9]), dev)
    lap("5_fusion_kernels")
    fusion, single = phase_fusion_training(args.seed, dev)
    lap("5_fusion_training")
    # the SOTA baselines' slice: a stream of its own as well
    frng = np.random.default_rng([args.seed, 10])
    focal_errors = check_focal_blocks(frng, dev, card)
    check_dropout_on_card(dev)
    sota = phase_sota_training(args.seed, dev)
    lap("5e_sota")
    # the other MTL methods' slice: a stream of its own as well
    mrng = np.random.default_rng([args.seed, 11])
    mtl = phase_mtl_methods(args.seed, dev, mrng)
    lap("5f_mtl_methods")
    # the recipe's slice: a stream of its own as well
    recipe = phase_recipe(args.seed, dev)
    lap("5g_recipe")
    # the FBG/FoG driver's slice: a stream of its own as well
    ff_rng = np.random.default_rng([args.seed, 13])
    fbg_fog = phase_fbg_fog(args.seed, dev, ff_rng)
    lap("5h_fbg_fog")
    # the FBG/FoG baseline drivers' slice: a stream of its own as well
    bb_rng = np.random.default_rng([args.seed, 14])
    baselines = phase_baselines(args.seed, dev, card, bb_rng)
    lap("5i_baseline_drivers")
    # the kernel redesigns' slice: the tiled cross-attention on the fusion's
    # path at enc_out_ch 96
    wide_fusion = phase_wide_fusion_training(args.seed, dev)
    lap("5j_wide_fusion")
    # the sweep over key tiles' slice: its kernels' shapes and edges, then the
    # fusion's step at --win_len 256, from a stream of its own
    long_rng = np.random.default_rng([args.seed, 20])
    long_errors = check_xattn_with_launches(long_rng, dev, card, SWEEP_LONG_XATTN_CASES)
    win256 = phase_win256(args.seed, dev, long_rng, card)
    lap("5k_win256")
    times = time_stream_block(rng, dev, card)
    times["cagrad_solver"] = time_solver(rng, dev, card)
    serving = time_serving(engine, rng, card)
    lap("6_times_kernels_serving")
    train_steps = time_train_step(args.seed, dev, card)
    ff_steps = time_ff_train_step(args.seed, dev, card)
    ff_profile = time_ff_step_profile(args.seed, dev, card)
    lap("6_times_train_ff_steps")
    ff_times = time_stream_block(ff_rng, dev, card, FF_SHAPE, slice(FF_BATCH, None),
                                 "FoG async skeleton task layout")
    recipe_times = {"steps": time_train_step(args.seed, dev, card, recipe=True),
                    "profile": time_recipe_step(args.seed, dev, card),
                    "checkpoint_save": time_checkpoint_save(args.seed, dev, card)}
    lap("6_times_fbg_fog_recipe")
    times.update(time_cheap_xattn(xrng, dev, card))
    fusion_steps = time_train_step(args.seed, dev, card, "cheap_xattn")
    win256_steps = time_train_step(args.seed, dev, card, "cheap_xattn", win_len=WIN256)
    focal_times = time_focal_block(frng, dev, card)
    threshold_times = time_wide_threshold(np.random.default_rng([args.seed, 21]), dev, card)
    lap("6_times_xattn_focal")
    sota_steps = {b: time_train_step(args.seed, dev, card, b) for b in wg.SOTA_BASELINES}
    times.update(time_mtl_solvers(mrng, dev, card, np.random.default_rng([args.seed, 23]),
                                  mtl["training_grams"]))
    mtl_steps = {m: time_train_step(args.seed, dev, card, mtl_method=m)
                 for m in sorted(METHODS) if m != "cagrad"}
    lap("6_times_sota_mtl_steps")
    phase_profiles(engine, args.seed, dev, card)
    phase_sota_profiles(args.seed, dev, card)
    lap("6_profiles")
    bb_xattn_times = time_cheap_xattn(bb_rng, dev, card, BB_XATTN_SHAPE)
    t128_xattn_times = time_cheap_xattn(np.random.default_rng([args.seed, 18]), dev, card,
                                        SWEEP128_XATTN_CASES["t128_d12"])
    # the sweep over key tiles beyond 128 keys (--win_len above 128)
    long_time_rng = np.random.default_rng([args.seed, 19])
    long_times = {name: time_cheap_xattn(long_time_rng, dev, card, SWEEP_LONG_XATTN_CASES[name],
                                         reps=reps)
                  for name, reps in SWEEP_LONG_TIMED.items()}
    bb_focal_times = time_stream_block(bb_rng, dev, card, BB_FOCAL_SHAPE, slice(FF_BATCH, None),
                                       "FOCAL async skeleton stream's layout")
    t101_times = time_t101_forwards(np.random.default_rng([args.seed, 16]), dev, card)
    lap("6_times_bb_long_t101")

    def bb_xattn_setup(seed, device, bsz):
        return bb_step_setup(seed, device, bsz, "fusion", fusion_type="cheap_xattn")

    bb_label_xattn = "FoG cheap_xattn fusion (Adam)"
    bb_steps = time_ff_train_step(args.seed, dev, card, bb_xattn_setup, bb_label_xattn)
    bb_profile = time_ff_step_profile(args.seed, dev, card, bb_xattn_setup, bb_label_xattn)
    lap("6_times_bb_steps")
    # the CLI and WearGait's folds in one step: streams of their own
    commands = run_commands(card)
    lap("7_10_11_13_subprocesses")
    vmap = phase_vmap_cv(args.seed, dev, card, np.random.default_rng([args.seed, 24]), commands)
    times.update(time_fold_block(np.random.default_rng([args.seed, 25]), dev, card))
    lap("7_vmap_cv")
    # WearGait's baselines and the recipe's draws under --vmap_folds: a
    # stream of their own
    vmap_baselines = phase_vmap_baselines(args.seed, dev, card,
                                          np.random.default_rng([args.seed, 26]))
    times.update(vmap_baselines["times"])
    lap("8_vmap_baselines")
    # the 16 other MTL methods under --vmap_folds: a stream of their own
    vmap_mtl = phase_vmap_mtl(args.seed, dev, card, np.random.default_rng([args.seed, 27]))
    times.update(vmap_mtl["times"])
    lap("9_vmap_mtl")
    # FBG/FoG's folds and the baseline seed sweeps under --vmap_folds: a
    # stream of their own
    vmap_ff = phase_vmap_fbg_fog(args.seed, dev, card, np.random.default_rng([args.seed, 28]),
                                 commands)
    times.update(vmap_ff["times"])
    lap("10_vmap_fbg_fog")
    # the HP grid and the sweep runner: a stream of their own
    hp_grid = phase_hp_grid(args.seed, dev, card, np.random.default_rng([args.seed, 29]),
                            commands)
    times.update(hp_grid["times"])
    lap("11_hp_grid")
    # the fused forward: a stream of its own
    fused = phase_fused(args.seed, dev, card, np.random.default_rng([args.seed, 30]))
    times.update(fused["times"])
    lap("12_fused")
    # remat and the data-parallel mesh: a stream of its own (no draw yet)
    remat_mesh = phase_remat_mesh(dev, card, np.random.default_rng([args.seed, 31]),
                                  commands["mesh"])
    lap("13_remat_mesh")

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
    # the sweep over key tiles on its own main path: the --win_len 256 step's
    # launches, the times and errors at its shape
    for name in ("cheap_xattn", "cheap_xattn_backward"):
        launches[f"{name}_long"] = win256["launches"][name]
        times[f"{name}_long"] = long_times["win256_batch64"][name]
    # the fold-stacked block on its own main path: the vmapped CV's sync run
    for name in ("stream_block_folds", "stream_block_backward_folds"):
        launches[name] = vmap["runs"]["sync"]["launches"][name]
    # the fold-stacked cross-attention on its own main path: the vmapped
    # cheap-xattn fusion's sync run
    for name in ("cheap_xattn", "cheap_xattn_backward"):
        launches[f"{name}_folds"] = vmap_baselines["runs"]["cheap_xattn sync"]["launches"][name]
    # the solvers with a fold axis on their own main paths: CAGrad's in the
    # vmapped CV's sync run (phase 7), NashMTL's in phase 9's, MGDA's and
    # FairGrad's in phase 9's runs on the card alone
    launches["cagrad_solver_folds"] = vmap["runs"]["sync"]["launches"]["cagrad_solver_folds"]
    for name, run in (("min_norm_solver", "mgda sync"), ("fairgrad_solver", "fairgrad sync"),
                      ("nashmtl_solver", "nashmtl sync")):
        launches[f"{name}_folds"] = vmap_mtl["runs"][run]["launches"][f"{name}_folds"]
    # the fold-stacked block at FBG/FoG's and FOCAL's shapes and the CAGrad
    # solver under vmap at K = 2 on their own main paths: phase 10's stacked
    # FoG CAGrad run and its FOCAL seed sweep
    ff_vm = vmap_ff["runs"]["fbg_fog"]["launches"]
    focal_vm = vmap_ff["runs"]["focal async (AdamW, clip)"]["launches"]
    for name in ("stream_block_folds", "stream_block_backward_folds"):
        launches[f"{name}_fbg_fog"] = ff_vm[name]
        launches[f"{name}_focal_fbg_fog"] = focal_vm[name]
    launches["cagrad_solver_folds_k2"] = ff_vm["cagrad_solver_folds"]
    # the solver reading c one value a matrix and the fold-stacked block at
    # the grid's 40 instances on their own main path: phase 11's flagship grid
    grid_vm = hp_grid["runs"]["weargait"]["launches"]
    launches["cagrad_solver_per_matrix_c"] = grid_vm["cagrad_solver_per_matrix_c"]
    for name in ("stream_block_folds", "stream_block_backward_folds"):
        launches[f"{name}_grid"] = grid_vm[name]
    # the stream block in the fused backbone's (b, stream) row order on its
    # own main path: phase 12's fused sync run
    for name in ("stream_block", "stream_block_backward"):
        launches[f"{name}_fused"] = fused["runs"]["sync"]["launches"][name]
    # the stream block's forward launches in one CAGrad step under each
    # remat policy (phase 13): "nothing" reruns it in each task pass
    times["stream_block"]["remat_forward_launches_a_step"] = {
        policy: run["launches"]["stream_block"] for policy, run in remat_mesh["remat"].items()}
    long_err = long_errors["win256_batch64"]
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
        ("cheap_xattn_long", "gaitpd_torch/csrc/cheap_xattn.cu",
         "gaitpd/ops/pallas_blocks.py:184", long_err[0]),
        ("cheap_xattn_backward_long", "gaitpd_torch/csrc/cheap_xattn.cu",
         "gaitpd/ops/pallas_blocks.py:275", long_err[1]),
        # the stream block with a fold axis: every fold of the CV in one launch
        ("stream_block_folds", "gaitpd_torch/csrc/stream_block.cu",
         "gaitpd/ops/pallas_blocks.py:72", vmap["errors"]["flagship"][0]),
        ("stream_block_backward_folds", "gaitpd_torch/csrc/stream_block.cu",
         "gaitpd/ops/pallas_blocks.py:160", vmap["errors"]["flagship"][1]),
        # the cross-attention with a fold axis: every fold's problems in one launch
        ("cheap_xattn_folds", "gaitpd_torch/csrc/cheap_xattn.cu",
         "gaitpd/ops/pallas_blocks.py:184", vmap_baselines["errors"]["main"][0]),
        ("cheap_xattn_backward_folds", "gaitpd_torch/csrc/cheap_xattn.cu",
         "gaitpd/ops/pallas_blocks.py:275", vmap_baselines["errors"]["main"][1]),
        # not TPU kernels either: the MGDA, FairGrad and NashMTL solvers
        ("min_norm_solver", "gaitpd_torch/csrc/mtl_solvers.cu", "gaitpd/learning/minnorm.py:35",
         mtl["solver_errors"]["min_norm_solver"]),
        ("fairgrad_solver", "gaitpd_torch/csrc/mtl_solvers.cu",
         "gaitpd/learning/minnorm.py:125", mtl["solver_errors"]["fairgrad_solver"]),
        ("nashmtl_solver", "gaitpd_torch/csrc/mtl_solvers.cu", "gaitpd/learning/minnorm.py:144",
         mtl["solver_errors"]["nashmtl_solver"]),
        # the four solvers with a fold axis: every fold of the CV in one launch
        ("cagrad_solver_folds", "gaitpd_torch/csrc/cagrad_solver.cu",
         "gaitpd/learning/minnorm.py:58", vmap_mtl["errors"]["cagrad_solver"]),
        ("min_norm_solver_folds", "gaitpd_torch/csrc/mtl_solvers.cu",
         "gaitpd/learning/minnorm.py:35", vmap_mtl["errors"]["min_norm_solver"]),
        ("fairgrad_solver_folds", "gaitpd_torch/csrc/mtl_solvers.cu",
         "gaitpd/learning/minnorm.py:125", vmap_mtl["errors"]["fairgrad_solver"]),
        ("nashmtl_solver_folds", "gaitpd_torch/csrc/mtl_solvers.cu",
         "gaitpd/learning/minnorm.py:144", vmap_mtl["errors"]["nashmtl_solver"]),
        # the stream block with a fold axis at FBG/FoG's and FOCAL's shapes,
        # and the CAGrad solver under vmap at FBG/FoG's K = 2
        ("stream_block_folds_fbg_fog", "gaitpd_torch/csrc/stream_block.cu",
         "gaitpd/ops/pallas_blocks.py:72", vmap_ff["errors"]["fog"][0]),
        ("stream_block_backward_folds_fbg_fog", "gaitpd_torch/csrc/stream_block.cu",
         "gaitpd/ops/pallas_blocks.py:160", vmap_ff["errors"]["fog"][1]),
        ("stream_block_folds_focal_fbg_fog", "gaitpd_torch/csrc/stream_block.cu",
         "gaitpd/ops/pallas_blocks.py:72", vmap_ff["errors"]["focal"][0]),
        ("stream_block_backward_folds_focal_fbg_fog", "gaitpd_torch/csrc/stream_block.cu",
         "gaitpd/ops/pallas_blocks.py:160", vmap_ff["errors"]["focal"][1]),
        ("cagrad_solver_folds_k2", "gaitpd_torch/csrc/cagrad_solver.cu",
         "gaitpd/learning/minnorm.py:58", vmap_ff["solver_error"]),
        # the HP grid's: the stream block on 40 instances, the CAGrad solver
        # with c one value a matrix
        ("stream_block_folds_grid", "gaitpd_torch/csrc/stream_block.cu",
         "gaitpd/ops/pallas_blocks.py:72", hp_grid["errors"]["grid"][0]),
        ("stream_block_backward_folds_grid", "gaitpd_torch/csrc/stream_block.cu",
         "gaitpd/ops/pallas_blocks.py:160", hp_grid["errors"]["grid"][1]),
        ("cagrad_solver_per_matrix_c", "gaitpd_torch/csrc/cagrad_solver.cu",
         "gaitpd/learning/minnorm.py:58", hp_grid["solver"]["k3"]["max_abs_err"]),
        # the fused forward's backbone: the three streams folded (b, stream)
        ("stream_block_fused", "gaitpd_torch/csrc/stream_block.cu",
         "gaitpd/ops/pallas_blocks.py:72", fused["errors"][0]),
        ("stream_block_backward_fused", "gaitpd_torch/csrc/stream_block.cu",
         "gaitpd/ops/pallas_blocks.py:160", fused["errors"][1]),
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
        f"cross-attention at Tq = Tk = 128, d 12 {json.dumps(t128_xattn_times)}; the "
        f"sweep over key tiles {json.dumps(long_times)}, the step at win_len {WIN256} "
        f"{json.dumps(win256)} and its train steps {json.dumps(win256_steps)}; the wide "
        f"thresholds {json.dumps(threshold_times)}; the vmapped CV (phase 7) "
        f"{json.dumps(vmap)}; the vmapped baselines (phase 8) {json.dumps(vmap_baselines)}; "
        f"the vmapped MTL methods (phase 9) {json.dumps(vmap_mtl)}; FBG/FoG's folds and the "
        f"seed sweeps (phase 10) {json.dumps(vmap_ff)}; the HP grid and the sweep runner "
        f"(phase 11) {json.dumps(hp_grid)}; the fused forward (phase 12) {json.dumps(fused)}; "
        f"remat and the mesh (phase 13) {json.dumps(remat_mesh)}")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
