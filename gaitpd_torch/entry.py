"""Entry points: the flagship forward, and a data-parallel dry run over
spawned ranks. Port of __graft_entry__.py (``entry``, ``dryrun_multichip``).

    python -m gaitpd_torch.entry                      # entry() on the card
    python -m gaitpd_torch.entry multichip 4 cpu      # 4 gloo ranks on the CPU
    python -m gaitpd_torch.entry multichip 2          # 2 gloo ranks sharing the card

gaitpd's dry run splits the CPU into n virtual JAX devices. Here each
device is a process: ``run_ranks`` spawns n ranks of a gloo group that meet
over a file store in a temporary directory. On the card the ranks share the
one device (NCCL takes one rank a device); gloo carries the card's tensors
of all_reduce, broadcast and all_gather.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import os
import sys
import tempfile
import time
import traceback
from typing import Callable, List

import numpy as np
import torch
import torch.distributed as dist

from gaitpd_torch.runtime.device import DeviceLike, resolve_device


def entry(device: DeviceLike = None):
    """The flagship forward (WearGaitThreeModal: three stream encoders, the
    shared backbone, the heads) with the relaxed-input modality mask as an
    operand, then the masked softmax ensemble, as __graft_entry__.py:88-118.
    Returns (fn, example_args); ``fn(*example_args)`` is (64, 2)."""
    from gaitpd_torch.models.multitask import WearGaitThreeModal

    dev = resolve_device(device)
    model = WearGaitThreeModal(synchronized=True,
                               generator=torch.Generator().manual_seed(0)).to(dev).eval()
    b, t = 64, 64
    rng = np.random.default_rng(0)
    xw, xi, xm = (torch.from_numpy(rng.normal(size=(b, t, c)).astype(np.float32)).to(dev)
                  for c in (2, 13, 24))
    mask = torch.tensor([True, True, True], device=dev)

    @torch.no_grad()
    def fn(model, xw, xi, xm, mask):
        zero = torch.zeros((), device=xw.device)
        lw, li, lm = model(torch.where(mask[0], xw, zero), torch.where(mask[1], xi, zero),
                           torch.where(mask[2], xm, zero))
        probs = (torch.softmax(lw, -1) * mask[0] + torch.softmax(li, -1) * mask[1]
                 + torch.softmax(lm, -1) * mask[2])
        return probs / torch.clamp(mask.sum(), min=1)

    return fn, (model, xw, xi, xm, mask)


# ---------------------------------------------------------------------------
# Spawned ranks
# ---------------------------------------------------------------------------


def _rank_main(fn, rank, n, store, args, queue):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=n,
                                timeout=datetime.timedelta(minutes=15))
        try:
            queue.put((rank, True, fn(rank, n, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # the parent raises it with the rank's traceback
        queue.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, n: int, *args, timeout: float = 600.0) -> List:
    """``fn(rank, n, *args)`` in ``n`` spawned processes, the ranks of a gloo
    group over a file store in a temporary directory, each on one intra-op
    thread; returns each rank's value in rank order. A rank that raises or
    outlasts ``timeout`` seconds fails the call; every process is stopped
    before it returns or raises. ``fn`` must be importable by name."""
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, args=(fn, r, n, os.path.join(tmp, "store"),
                                                      args, queue), daemon=True)
                 for r in range(n)]
        for p in procs:
            p.start()
        out, deadline = {}, time.monotonic() + timeout
        try:
            while len(out) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{n - len(out)} of {n} ranks still running after "
                                       f"{timeout:.0f} s")
                try:
                    rank, ok, value = queue.get(timeout=min(left, 5.0))
                except Exception:  # queue.Empty: check that every rank still lives
                    dead = [r for r, p in enumerate(procs) if r not in out and not p.is_alive()]
                    if dead and queue.empty():
                        raise RuntimeError(f"rank(s) {dead} exited without a result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
                out[rank] = value
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(n)]


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------


def _dp_step(n, device, sharding):
    """gaitpd's dry-run step (__graft_entry__.py:156-196): the flagship under
    GCL and CAGrad (sum_plus_own), SGD at 1e-3, one step on 8 n windows of 16
    frames, from one seed on every rank. Returns the metrics' losses and the
    parameters on the host."""
    from gaitpd_torch.learning.mtl import build_flat_partition, make_method
    from gaitpd_torch.models.multitask import WearGaitThreeModal
    from gaitpd_torch.train.optim import sgd_torch
    from gaitpd_torch.train.step import StepSettings, TrainState, make_loss_ctx, make_train_step

    dev = resolve_device(device)
    b, t = 8 * n, 16
    rng = np.random.default_rng(0)
    xs = tuple(torch.from_numpy(rng.normal(size=(b, t, c)).astype(np.float32)).to(dev)
               for c in (2, 13, 24))
    ys = tuple(torch.from_numpy(rng.integers(0, 2, size=b)).to(dev) for _ in range(3))
    batch = {"xs": xs, "ys": ys, "valid": torch.ones(b, device=dev), "n_valid": b}
    model = WearGaitThreeModal(synchronized=True,
                               generator=torch.Generator().manual_seed(0)).to(dev)
    settings = StepSettings(n_streams=3, wm="gcl", synchronized=True,
                            private_grads="sum_plus_own")
    mtl = make_method("cagrad", 3, c=0.5)
    state = TrainState(module=model, optimizer=sgd_torch(model.parameters(), 1e-3),
                       mtl_state={})
    step = make_train_step(settings, mtl,
                           build_flat_partition(model, model.shared_modules, model.task_modules),
                           sharding=sharding)
    _, metrics = step(state, batch, torch.Generator(device=dev).manual_seed(0),
                      make_loss_ctx(settings, [(5, 3)] * 3, device=dev))
    params = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    return metrics["losses"].cpu().numpy(), params


def _close(got, want, what, rtol=2e-4, atol=1e-5):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _dryrun_rank(rank: int, n: int, device: DeviceLike):
    """One rank of ``dryrun_multichip``; rank 0 runs the single-process
    references and prints, the others print nothing."""
    from gaitpd_torch.runtime.mesh import (
        batch_sharding_2d,
        make_mesh,
        make_mesh_2d,
        mesh_sharding,
    )
    from gaitpd_torch.train.hp_search import run_weargait_hp_vmapped
    from gaitpd_torch.train.vmap_cv import run_cv_vmapped
    from gaitpd_torch.train.weargait_driver import WearGaitArgs

    t0 = time.perf_counter()
    quiet = contextlib.nullcontext() if rank == 0 else contextlib.redirect_stdout(io.StringIO())

    def phase(msg):
        if rank == 0:
            print(f"[dryrun +{time.perf_counter() - t0:.0f}s] {msg}", flush=True)

    phase(f"phase 1/5: DP train step on a {n}-device mesh")
    mesh = make_mesh(n, device=device)
    losses, params = _dp_step(n, device, mesh_sharding(mesh))
    assert np.all(np.isfinite(losses))
    if rank == 0:
        single_losses, single_params = _dp_step(n, device, None)
        _close(losses, single_losses, "DP losses diverge from the single-process step")
        for k, v in single_params.items():
            scale = max(float(np.abs(v).max()), 1.0)
            _close(params[k], v, f"DP parameter {k}", rtol=0, atol=1e-6 * scale)
        print(f"dryrun_multichip({n}) DP step == single-process step: losses={losses}")

    if n >= 4 and n % 2 == 0:
        phase(f"phase 2/5: 2-level mesh (2x{n // 2})")
        mesh2 = make_mesh_2d(2, n // 2, device=device)
        losses2, _ = _dp_step(n, device, batch_sharding_2d(mesh2))
        _close(losses2, losses, "2-level mesh losses diverge from 1-level DP")
        phase(f"dryrun_multichip({n}) 2-level mesh (2x{n // 2}) OK")

    kw = dict(n_folds=n, test_per_class=1, epochs=2, patience=50, wm="gcl", alpha=0.5, seed=0,
              synthetic=True, verbose=False, device=device)
    for tag, extra in (("sync", {}), ("async", {"async_loading": True})):
        phase(f"phase {3 if tag == 'sync' else 4}/5: fold-sharded vmapped CV ({tag}), "
              "sharded vs single")
        with quiet:
            sharded = run_cv_vmapped(WearGaitArgs(mesh=mesh, **kw, **extra))
            single = run_cv_vmapped(WearGaitArgs(**kw, **extra)) if rank == 0 else None
        got = np.asarray(sharded["per_fold_macro"])
        assert np.all(np.isfinite(got))
        if rank == 0:
            np.testing.assert_allclose(got, np.asarray(single["per_fold_macro"]), atol=1e-3,
                                       err_msg=f"{tag} fold-sharded CV diverges from single")
            print(f"dryrun_multichip({n}) {tag} fold-sharded vmapped CV OK: per-fold macro="
                  f"{np.round(got, 4)} (== single-process)")

    phase("phase 5/5: HP-grid-sharded search, sharded vs single")
    grid = [{"lr": lr, "gcl_m": m} for lr in (1e-3, 3e-3) for m in (0.1, 0.2)]
    hp_kw = dict(kw, n_folds=max(2, n // 4), test_per_class=2)
    with quiet:
        hp_sharded = run_weargait_hp_vmapped(WearGaitArgs(mesh=mesh, **hp_kw), grid)
        hp_single = run_weargait_hp_vmapped(WearGaitArgs(**hp_kw), grid) if rank == 0 else None
    if rank == 0:
        def key(row):
            return tuple(sorted(row["hp"].items()))

        single_rows = {key(r): r for r in hp_single["table"]}
        for row in hp_sharded["table"]:
            np.testing.assert_allclose(row["per_fold"], single_rows[key(row)]["per_fold"],
                                       atol=1e-3, err_msg="sharded HP grid diverges from single")
        print(f"dryrun_multichip({n}) HP-grid-sharded search OK: {len(grid)} HPs x "
              f"{hp_kw['n_folds']} folds (== single-process)")
    phase(f"all phases OK: losses={losses}")
    return losses


def dryrun_multichip(n_devices: int, device: DeviceLike = None, timeout: float = 900.0):
    """gaitpd's five dry-run phases (__graft_entry__.py:121-312) over
    ``n_devices`` spawned ranks: one data-parallel CAGrad step (held against
    the single-process step), the 2-level mesh for even n >= 4 (losses
    within rtol 2e-4, atol 1e-5 of the 1-level step), fold-sharded
    ``run_cv_vmapped`` sync and async, and the sharded HP grid (each within
    atol 1e-3 of the single-process run's per-fold macro). On the card by
    default, the ranks sharing it over gloo. Returns rank 0's losses."""
    resolve_device(device)  # no card and no device="cpu": raise before spawning
    losses = run_ranks(_dryrun_rank, n_devices, device, timeout=timeout)[0]
    print(f"dryrun_multichip({n_devices}) OK: losses={losses}", flush=True)
    return losses


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "multichip":
        dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else 8,
                         sys.argv[3] if len(sys.argv) > 3 else None)
    else:
        fn, example = entry()
        print("entry OK:", tuple(fn(*example).shape))
