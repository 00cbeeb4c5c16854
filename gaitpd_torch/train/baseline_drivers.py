"""FBG/FoG baseline drivers: the fusion ablations (early / late /
share_latent / cheap_xattn) and the SOTA baselines (DeepAV-Lite, FOCAL,
TACA). Port of gaitpd/train/baseline_drivers.py (reference
train/baselines/fusion_train.py, deepav_train.py, focal_train.py,
taca_train.py).

    summary = main(BaselineArgs(kind="fusion", fusion_type="cheap_xattn",
                                synthetic=True, epochs=3))  # on the card
    summary = main(BaselineArgs(kind="focal", dataset="fbg", synced=True,
                                synthetic=True, device="cpu"))

Every driver shares one fold runner (subject folds -> the fold's windows on
the device -> model -> Adam or AdamW -> CE or class_wt -> best epoch),
over the port's epoch loop (gaitpd_torch.train.loop). gaitpd's deliberate
differences between the reference drivers are kept, each with its line:
the per-driver hyperparameters (``_hp``), the mean of the two async CE
losses for the fusions against their sum for the SOTA drivers, Adam without
a clip for the fusions against AdamW (decay 1e-4, clip 1.0) for the SOTA
drivers, and the FoG exclusions passed for FBG labels too.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from gaitpd_torch.config import FBG_FOG_DIMS, normalize_dataset_name
from gaitpd_torch.data.fbg_fog import build_fusion_fold
from gaitpd_torch.models import baselines as B
from gaitpd_torch.models import fusion as FU
from gaitpd_torch.runtime.device import DeviceLike, resolve_device
from gaitpd_torch.train import metrics as M
from gaitpd_torch.train.cv import (
    FOG_EXCLUDED_SUBJECTS,
    fbg_label_dict,
    fog_label_dict,
    generate_class_stratified_folds,
)
from gaitpd_torch.train.fbg_fog_driver import fold_to_device
from gaitpd_torch.train.loop import (
    EarlyStopper,
    EpochRunner,
    init_train_state,
    run_eval_epoch,
    run_train_epoch,
)
from gaitpd_torch.train.optim import adam_torch, adamw_torch
from gaitpd_torch.train.step import StepSettings, make_loss_ctx

KINDS = ("fusion", "deepav", "focal", "taca")


@dataclasses.dataclass
class BaselineArgs:
    kind: str  # fusion | deepav | focal | taca
    dataset: str = "fog"
    synced: bool = False
    wm: str = "ce"  # ce | class_wt
    seed: int = 43
    fusion_type: str = "cheap_xattn"
    epochs: Optional[int] = None
    batch_size: Optional[int] = None
    patience: Optional[int] = None
    synthetic: bool = False
    n_folds_cap: Optional[int] = None
    verbose: bool = True
    # TACA knobs (reference taca_train.py:201-209)
    d_model: int = 96
    n_heads: int = 4
    n_tok_s: int = 4
    n_tok_e: int = 4
    tau: float = 1.0
    gamma: float = 1.5
    taca_schedule: str = "const"
    taca_depths: int = 1
    device: DeviceLike = None  # None: the card; "cpu" for the plain versions


# reference per-driver hyperparameter tables (gaitpd/train/baseline_drivers.py:
# 61-79; the deliberate drift between them is kept: fusion_train.py:21-50
# uses fog sensor_length 150 and fbg batch 32; the SOTA drivers use 100
# epochs & patience 60, deepav_train.py:21-24, focal_train.py:17-26,
# taca_train.py:17-20)
def _hp(args: BaselineArgs, dataset: str) -> dict:
    if args.kind == "fusion":
        hp = dict(epochs=50, patience=10**9,
                  batch=32 if dataset == "fbg" else 256,
                  sensor_length=65 if dataset == "fbg" else 150,
                  lr=1e-3)
    else:
        hp = dict(epochs=100, patience=60, batch=256,
                  sensor_length=65 if dataset == "fbg" else 426, lr=1e-3)
    if args.epochs:
        hp["epochs"] = args.epochs
    if args.batch_size:
        hp["batch"] = args.batch_size
    if args.patience is not None:
        hp["patience"] = args.patience
    return hp


def _build_model(args: BaselineArgs, dims, hp, sync: bool,
                 generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    """The model of ``args.kind`` (gaitpd/train/baseline_drivers.py:82-122),
    its weights drawn from ``generator`` (default: seeded with args.seed)."""
    g = generator if generator is not None else torch.Generator().manual_seed(args.seed)
    widths = dict(skeleton_input_dim=dims.skeleton_input_dim,
                  sensor_in_channels=dims.sensor_in_channels, generator=g)
    if args.kind == "fusion":
        cls = FU.TWO_MOD_FUSIONS[args.fusion_type]
        return cls(dims.skeleton_output_dim, dims.sensor_out_channels, hp["sensor_length"],
                   dims.pose_length, dims.shared_out_channels, dims.backbone_dim,
                   dims.num_classes, synchronized_loading=sync, **widths)
    if args.kind == "deepav":
        return B.DeepAVLite(dims.skeleton_input_dim, dims.sensor_in_channels,
                            num_classes=dims.num_classes, synchronized=sync, generator=g)
    if args.kind == "focal":
        return B.FOCALSharedLatent(
            dims.skeleton_output_dim, dims.sensor_out_channels, hp["sensor_length"],
            pose_length=dims.pose_length, d_shared=16, d_private=8, shared_out_channels=4,
            backbone_dim=4, num_classes=dims.num_classes, synchronized=sync, **widths)
    if args.kind == "taca":
        return B.TACAWrapper(
            skel_t=dims.pose_length, skel_d=dims.skeleton_input_dim,
            sens_t=hp["sensor_length"], sens_d=dims.sensor_in_channels,
            num_classes=dims.num_classes, d_model=args.d_model, n_heads=args.n_heads,
            n_tok_s=args.n_tok_s, n_tok_e=args.n_tok_e, tau=args.tau, gamma=args.gamma,
            schedule=args.taca_schedule, num_depths=args.taca_depths, drop=0.1,
            synchronized=sync, generator=g)
    raise ValueError(f"kind must be one of {KINDS}, got {args.kind!r}")


def _adapters(args: BaselineArgs, hp):
    """(train_apply, eval_apply) of the model, or (None, None) for the
    standard ones: TACA takes the windows flattened to (B, T * D)
    (taca_train.py:30-37) and the epoch fraction of its γ schedule, the
    0-based epoch over max(1, epochs) in f32 as gaitpd computes it; DeepAV
    takes the step's generator for its dropout
    (gaitpd/train/baseline_drivers.py:125-152)."""
    if args.kind == "taca":
        def flat(xs):
            return tuple(x.reshape(x.shape[0], -1) for x in xs)

        def frac(epoch):
            return float(np.float32(epoch) / np.float32(max(1, hp["epochs"])))

        def train_apply(module, xs, generator, epoch):
            return module(*flat(xs), train=True, epoch_frac=frac(epoch), generator=generator)

        def eval_apply(module, xs, epoch):
            return module(*flat(xs), train=False, epoch_frac=frac(epoch))

        return train_apply, eval_apply
    if args.kind == "deepav":
        def train_apply(module, xs, generator, epoch):
            return module(*xs, train=True, generator=generator)

        def eval_apply(module, xs, epoch):
            return module(*xs, train=False)

        return train_apply, eval_apply
    return None, None


def train_fold(fold_idx, reader, args: BaselineArgs, train_subj, eval_subj, on_epoch=None):
    """Train one fold (gaitpd/train/baseline_drivers.py:155-254); returns
    (skel_acc, sens_acc, avg) at the best epoch, the joint head's accuracy
    three times for a one-head model. ``on_epoch(fold, ep, state, train,
    eval)`` is called after every epoch (ep 0-based)."""
    device = resolve_device(args.device)
    dataset = normalize_dataset_name(args.dataset)
    dims = FBG_FOG_DIMS[dataset]
    hp = _hp(args, dataset)

    fold = build_fusion_fold(
        dataset, reader, train_subj, eval_subj,
        synchronized=args.synced, seed=args.seed,
        pad_skel=dims.pose_length, pad_sens=hp["sensor_length"],
        modality="multimodal",
    )
    data = fold_to_device(fold, "multimodal", device)

    # one joint head for sync (except fusion share_latent, which keeps 2
    # heads even in sync mode, reference fusion_train.py:168-173)
    two_heads = (not args.synced) or (
        args.kind == "fusion" and args.fusion_type == "share_latent"
    )
    n_heads = 2 if two_heads else 1
    head_inputs = (0, 1) if two_heads else (0,)
    host = (fold.train_pose, fold.train_sens)
    counts = [np.bincount(host[i].y[data.train_pool[:, i]], minlength=dims.num_classes)
              for i in head_inputs]
    settings = StepSettings(
        n_streams=n_heads,
        wm=args.wm if args.wm in ("ce", "class_wt") else "ce",
        synchronized=args.synced,
        # fusion async averages the two CE losses (fusion_train.py:242);
        # the SOTA drivers SUM them (deepav_train.py:94, focal_train.py:43-46)
        loss_reduction="mean" if args.kind == "fusion" else "sum",
    )
    ctx = make_loss_ctx(settings, counts, device=device)

    model = _build_model(args, dims, hp, args.synced)
    if args.kind == "fusion":  # reference fusion_train.py:202, no clip
        make_optimizer = functools.partial(adam_torch, lr=hp["lr"])
    else:
        make_optimizer = functools.partial(adamw_torch, lr=hp["lr"], weight_decay=1e-4,
                                           grad_clip=1.0)
    train_apply, eval_apply = _adapters(args, hp)
    state, _ = init_train_state(model, make_optimizer, None, device)
    runner = EpochRunner(settings, train_apply=train_apply, eval_apply=eval_apply,
                         head_inputs=head_inputs)

    if args.verbose:
        print(f"Total params: {M.count_params(state.module):,}")

    rng = np.random.default_rng(args.seed + 1000 * fold_idx)
    generator = torch.Generator(device=device).manual_seed(args.seed + fold_idx)
    stopper = EarlyStopper(patience=hp["patience"])

    for ep in range(1, hp["epochs"] + 1):
        state.epoch = ep - 1
        order = rng.permutation(len(data.train_pool))
        state, tr = run_train_epoch(runner, state, data, order, hp["batch"], generator, ctx)
        ev = run_eval_epoch(runner, state, data, hp["batch"], generator, ctx, collect=True)
        if n_heads == 1:
            score = float(ev.acc[0])
            line = f"acc {score:.1f}%"
        else:
            vsk, vse = float(ev.acc[0]), float(ev.acc[1])
            score = 0.5 * (vsk + vse)
            line = f"sk {vsk:.1f}% | se {vse:.1f}% | avg {score:.1f}%"
        stopper.update(score, payload=ev)
        if on_epoch is not None:
            on_epoch(fold_idx, ep - 1, state, tr, ev)
        if args.verbose:
            print(f"[Fold {fold_idx}] Ep{ep}: loss {float(tr.loss.mean()):.3f}/"
                  f"{float(ev.loss.mean()):.3f} | {line}")
        if stopper.stop:
            print(f"[Fold {fold_idx}] early stop at ep {ep}")
            break

    best = stopper.best_payload
    if best is None:
        return 0.0, 0.0, 0.0
    if n_heads == 1:
        acc = M.accuracy(best.preds[0], best.trues[0])
        if args.verbose:
            print(f"\n>>> Fold {fold_idx} Best Acc: {stopper.best:.2f}%")
            M.print_report(best.trues[0], best.preds[0], "Shared Head")
        return acc, 0.0, acc
    sk = M.accuracy(best.preds[0], best.trues[0])
    se = M.accuracy(best.preds[1], best.trues[1])
    avg = 0.5 * (sk + se)
    if args.verbose:
        print(f"\n>>> Fold {fold_idx} Best skel={sk:.2f}% sensor={se:.2f}% avg={avg:.2f}%")
        M.print_report(best.trues[0], best.preds[0], "Skeleton Head")
        M.print_report(best.trues[1], best.preds[1], "Sensor   Head")
    return sk, se, avg


def get_reader(args: BaselineArgs):
    """The synthetic reader of ``args.dataset`` (gaitpd's, from args.seed),
    or the raw one from the reader cache (gaitpd_torch.data.cache; building
    it needs pandas)."""
    dataset = normalize_dataset_name(args.dataset)
    if args.synthetic:
        from gaitpd_torch.data import synthetic

        make = synthetic.make_fbg_reader if dataset == "fbg" else synthetic.make_fog_reader
        return make(seed=args.seed)
    from gaitpd_torch.data.cache import load_reader

    return load_reader(dataset)


def main(args: BaselineArgs, on_epoch=None, reader=None) -> dict:
    """Every fold (gaitpd/train/baseline_drivers.py:257-281); returns
    {"skel", "sensor", "avg"}, the means over folds. ``reader``: a reader to
    train on instead of ``get_reader(args)``'s."""
    resolve_device(args.device)  # no card and no device="cpu": raise before any work
    if args.kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {args.kind!r}")
    dataset = normalize_dataset_name(args.dataset)
    reader = get_reader(args) if reader is None else reader
    rng = np.random.default_rng(args.seed)
    # the SOTA drivers pass the FoG exclusions for both datasets
    # (reference focal_train.py:155, deepav_train.py:162)
    label_dict = (
        fbg_label_dict(reader, exclude=FOG_EXCLUDED_SUBJECTS)
        if dataset == "fbg"
        else fog_label_dict(reader)
    )
    folds = generate_class_stratified_folds(label_dict, rng)
    if args.n_folds_cap:
        folds = folds[: args.n_folds_cap]
    out = []
    for i, (tr, ev) in enumerate(folds, 1):
        print(f"\n=== Fold {i}/{len(folds)} ===\nTrain: {tr}\nEval : {ev}")
        out.append(train_fold(i, reader, args, tr, ev, on_epoch=on_epoch))
    msk, mse, mav = np.asarray(out).mean(axis=0)
    if args.synced:
        print(f"\nMean Acc: {mav:.2f}%")
    else:
        print(f"\nMean skel={msk:.2f}%  sensor={mse:.2f}%  avg={mav:.2f}%")
    return {"skel": float(msk), "sensor": float(mse), "avg": float(mav)}


def _namespace_args(ns, **kw) -> BaselineArgs:
    return BaselineArgs(
        dataset=ns.dataset, synced=ns.synchronized_loading, seed=ns.seed, epochs=ns.epochs,
        batch_size=ns.batch_size, patience=ns.patience, synthetic=ns.synthetic,
        n_folds_cap=ns.n_folds_cap, verbose=not ns.quiet,
        device=getattr(ns, "device", None), **kw)


def run_baseline(ns, kind: str) -> dict:
    """CLI shim for --mode deepav|focal|taca (gaitpd/train/
    baseline_drivers.py:284-299): ``ns`` holds gaitpd's CLI flags, and
    optionally ``device``."""
    return main(_namespace_args(ns, kind=kind,
                                wm=ns.wm if ns.wm in ("ce", "class_wt") else "ce"))


def run_fusion(ns) -> dict:
    """CLI shim for --mode fusion (gaitpd/train/baseline_drivers.py:
    302-318)."""
    return main(_namespace_args(ns, kind="fusion", wm="ce", fusion_type=ns.fusion_type))
