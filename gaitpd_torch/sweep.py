"""Sweep runner: one process drives a whole (configuration x seed) grid on
one card. Port of gaitpd/sweep.py, with the port's drivers and ``--device``.

Replaces the reference's bash job farm (run_all.sh:9-31: fusion_type x 10
seeds round-robined over GPUs with nohup and stdout logs). Jobs run one
after another; every job writes a JSON result file and is skipped on a
rerun if that file exists. A job that fails is recorded with its traceback
(status "failed") and the sweep goes on, so whoever drives it reads the
``failed`` count it prints and returns. With ``--vmap_seeds`` each baseline
configuration trains every pending (seed, fold) instance in one stacked
run (gaitpd_torch/train/vmap_cv.py::run_baseline_seeds_vmapped) and writes
the sequential jobs' file names and payload keys (with ``runtime_s_batch``
beside ``runtime_s``), so either path skips the other's results.

    python -m gaitpd_torch.sweep --mode fusion --dataset fbg --synchronized_loading \\
        --fusion_types early late share_latent cheap_xattn \\
        --seeds 0 1 2 3 4 40 41 42 43 44 --out sweeps/fusion_fbg
    python -m gaitpd_torch.sweep --mode fusion --dataset fog --synthetic \\
        --synchronized_loading --fusion_types cheap_xattn --seeds 0 1 --epochs 1 \\
        --n_folds_cap 1 --vmap_seeds --out /tmp/sweep --device cpu
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

BASELINE_MODES = ("fusion", "deepav", "focal", "taca")


def run_job(mode: str, job_args: dict, out_path: Path, device=None) -> dict:
    """One job of ``mode`` on ``job_args`` (its driver's Args fields) and
    ``device``; its payload written to ``out_path`` and returned. The
    payload's ``args`` are ``job_args``, as gaitpd's."""
    t0 = time.time()
    try:
        if mode in BASELINE_MODES:
            from gaitpd_torch.train.baseline_drivers import BaselineArgs, main

            result = main(BaselineArgs(kind=mode, **job_args, device=device))
        elif mode == "weargait":
            from gaitpd_torch.train.weargait_driver import WearGaitArgs, run_cv

            result = run_cv(WearGaitArgs(**job_args, device=device))
        elif mode == "fbg_fog":
            from gaitpd_torch.train.fbg_fog_driver import FbgFogArgs, main

            result = main(FbgFogArgs(**job_args, device=device))
        else:
            raise ValueError(mode)
        status = "ok"
    except Exception:  # noqa: BLE001 — a failed job must not stop the sweep
        result = {"traceback": traceback.format_exc()}
        status = "failed"
    payload = {
        "status": status,
        "mode": mode,
        "args": dict(job_args),
        "result": result,
        "runtime_s": round(time.time() - t0, 1),
    }
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(payload, indent=2, default=str))
    return payload


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("gaitpd_torch sweep runner")
    p.add_argument("--mode", default="fusion",
                   choices=list(BASELINE_MODES) + ["weargait", "fbg_fog"])
    p.add_argument("--dataset", default="fbg")
    # reference run_all.sh:9-13 grid defaults
    p.add_argument("--fusion_types", nargs="+",
                   default=["early", "late", "share_latent", "cheap_xattn"])
    p.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2, 3, 4, 40, 41, 42, 43, 44])
    p.add_argument("--synchronized_loading", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--n_folds_cap", type=int, default=None)
    p.add_argument("--wm", default="ce")
    p.add_argument("--out", default="sweeps/run")
    p.add_argument("--rerun", action="store_true", help="ignore existing results")
    p.add_argument("--vmap_seeds", action="store_true",
                   help="fusion/deepav/focal/taca: train every (seed x fold) instance of a "
                        "configuration in one stacked run instead of sequential jobs")
    p.add_argument("--device", type=str, default=None,
                   help="where every job runs: the card (default) or cpu")
    return p


def _result_name(ns, variant: str, seed: int) -> str:
    return f"{ns.mode}_{ns.dataset}_{variant}_seed{seed}.json"


def main(argv=None) -> dict:
    """Run the sweep of ``argv`` (default: the process's); returns the counts
    {"done", "skipped", "failed"}, which it also prints."""
    ns = build_parser().parse_args(argv)
    out_root = Path(ns.out)
    variants = ns.fusion_types if ns.mode == "fusion" else [ns.mode]
    if ns.vmap_seeds and ns.mode in BASELINE_MODES:
        return _vmap_seeds_sweep(ns, out_root, variants)

    jobs = [(v, s) for v in variants for s in ns.seeds]
    print(f"[SWEEP] {len(jobs)} jobs -> {out_root}")
    done = skipped = failed = 0
    for variant, seed in jobs:
        name = _result_name(ns, variant, seed)
        out_path = out_root / name
        if out_path.exists() and not ns.rerun:
            print(f"[SKIP] {name}")
            skipped += 1
            continue
        job_args = dict(dataset=ns.dataset, seed=seed, synthetic=ns.synthetic, verbose=False)
        if ns.mode == "fusion":
            job_args.update(fusion_type=variant, synced=ns.synchronized_loading,
                            epochs=ns.epochs, n_folds_cap=ns.n_folds_cap)
        elif ns.mode in BASELINE_MODES:
            job_args.update(synced=ns.synchronized_loading, wm=ns.wm, epochs=ns.epochs,
                            n_folds_cap=ns.n_folds_cap)
        elif ns.mode == "weargait":
            job_args.pop("dataset")
            job_args.update(wm=ns.wm, epochs=ns.epochs or 50, n_folds_cap=ns.n_folds_cap)
        else:  # fbg_fog
            job_args.update(wm=ns.wm, synchronized_loading=ns.synchronized_loading,
                            epochs=ns.epochs, n_folds_cap=ns.n_folds_cap)
        print(f"[RUN ] {name}")
        payload = run_job(ns.mode, job_args, out_path, ns.device)
        if payload["status"] == "ok":
            done += 1
        else:
            failed += 1
            print(f"[FAIL] {name}")
    print(f"[SWEEP] done={done} skipped={skipped} failed={failed}")
    return {"done": done, "skipped": skipped, "failed": failed}


def _vmap_seeds_sweep(ns, out_root: Path, variants) -> dict:
    """One stacked run a configuration trains every pending (seed x fold)
    instance (run_baseline_seeds_vmapped); the result files keep the
    sequential sweep's names and payload keys, each with the run's share a
    seed (``runtime_s``) and its whole (``runtime_s_batch``)."""
    from gaitpd_torch.train.vmap_cv import run_baseline_seeds_vmapped

    done = skipped = failed = 0
    for variant in variants:
        pending = []
        for seed in ns.seeds:
            name = _result_name(ns, variant, seed)
            if (out_root / name).exists() and not ns.rerun:
                print(f"[SKIP] {name}")
                skipped += 1
            else:
                pending.append(seed)
        if not pending:
            continue
        print(f"[RUN ] {variant}: {len(pending)} seeds vmapped")
        t0 = time.time()
        try:
            results = run_baseline_seeds_vmapped(
                ns.dataset, ns.mode, variant, pending, synced=ns.synchronized_loading, wm=ns.wm,
                epochs=ns.epochs, n_folds_cap=ns.n_folds_cap, synthetic=ns.synthetic,
                device=ns.device)
        except Exception:  # noqa: BLE001 — a failed variant must not stop the sweep
            print(f"[FAIL] {variant}\n{traceback.format_exc()}")
            failed += len(pending)
            continue
        dt = round(time.time() - t0, 1)
        out_root.mkdir(parents=True, exist_ok=True)
        for seed in pending:
            payload = {
                "status": "ok",
                "mode": ns.mode,
                "args": dict(dataset=ns.dataset, seed=seed, synthetic=ns.synthetic,
                             verbose=False, fusion_type=variant, wm=ns.wm,
                             synced=ns.synchronized_loading, epochs=ns.epochs,
                             n_folds_cap=ns.n_folds_cap, vmap_seeds=True),
                "result": results[seed],
                # one stacked run trains the whole batch: a seed's share is
                # dt / n, and the batch's total is kept under its own name
                "runtime_s": round(dt / max(1, len(pending)), 3),
                "runtime_s_batch": dt,
            }
            (out_root / _result_name(ns, variant, seed)).write_text(
                json.dumps(payload, indent=2, default=str))
            done += 1
    print(f"[SWEEP] done={done} skipped={skipped} failed={failed}")
    return {"done": done, "skipped": skipped, "failed": failed}


if __name__ == "__main__":
    main()
