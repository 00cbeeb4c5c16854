"""FBG/FoG training: subject-fold CV over skeleton, sensor or multimodal
multitask models. Port of gaitpd/train/fbg_fog_driver.py (reference
train/fbg_fog_train.py: process_batch :46-164, run_epoch :170-263,
train_one_fold :269-404, main :410-436).

    summary = main(FbgFogArgs(dataset="fog", synthetic=True, epochs=3))  # on the card
    summary = main(FbgFogArgs(dataset="fbg", modality="both", synthetic=True,
                              device="cpu"))
    summary = main(FbgFogArgs(dataset="fog", synchronized_loading=True,
                              ckpt_dir="ck", resume=True))  # real data: needs pandas

Per fold, the fold's arrays go to the device once and each epoch is a loop
of train steps (gaitpd_torch.train.loop). The multimodal model trains under
CAGrad at K = 2 (or another method of gaitpd_torch.learning.mtl), its two
streams through one stream-block launch a step; the single-modality models
on their one loss. With ``ckpt_dir`` each fold saves ``latest`` every
epoch and ``best`` on improvement (gaitpd_torch.train.checkpoint), and
``resume`` continues a fold from its ``latest``, the fold's numpy and torch
generators restored, not replayed. The reports print through the port's
numpy metrics, so no run needs sklearn. With ``mesh`` (gaitpd_torch/
runtime/mesh.py::make_mesh) every train step is data-parallel over the
mesh's ranks, each ending it with the single-process step's parameters;
only the mesh's first rank writes the checkpoints and the loss plots.
The fusion and SOTA baselines train in gaitpd_torch.train.baseline_drivers.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gaitpd_torch.config import FBG_FOG_DIMS, FBG_FOG_TRAIN, normalize_dataset_name
from gaitpd_torch.data.augment import AugmentSpec, make_aug_params
from gaitpd_torch.data.fbg_fog import FusionFold, build_fusion_fold
from gaitpd_torch.learning.mtl import make_method
from gaitpd_torch.models.multitask import (
    MultiModalMultiTask,
    SensorModalityModel,
    SkelModalityModel,
)
from gaitpd_torch.runtime.device import DeviceLike, resolve_device
from gaitpd_torch.runtime.mesh import mesh_rank, replicate
from gaitpd_torch.train import metrics as M
from gaitpd_torch.train.checkpoint import (
    load_snapshot,
    restore_fold_checkpoint,
    save_fold_checkpoint,
)
from gaitpd_torch.train.cv import fbg_label_dict, fog_label_dict, generate_class_stratified_folds
from gaitpd_torch.train.loop import (
    DeviceFoldData,
    EarlyStopper,
    EpochRunner,
    init_train_state,
    run_eval_epoch,
    run_train_epoch,
)
from gaitpd_torch.train.optim import sgd_torch
from gaitpd_torch.train.step import StepSettings, make_loss_ctx

MODALITY_MODES = {
    "skeleton": ("skeleton",),
    "sensor": ("sensor",),
    "multimodal": ("multimodal",),
    "both": ("skeleton", "sensor"),
    "all": ("skeleton", "sensor", "multimodal"),
}


@dataclasses.dataclass
class FbgFogArgs:
    """CLI surface of the reference driver (fbg_fog_train.py:442-463)."""

    dataset: str = "fog"
    modality: str = "multimodal"  # skeleton|sensor|both|multimodal|all
    consistency_lambda: float = 1.0
    seed: int = 43
    wm: str = "gcl"
    synchronized_loading: bool = False
    alpha: float = 0.1
    max_norm: float = 1.0
    ldam_s: float = 30.0
    ldam_m: float = 0.5
    gcl_m: float = 0.2
    gcl_s: float = 25.0
    noise_mul: float = 0.0
    drw_warmup: int = 0
    use_norm_and_cos: bool = False
    epochs: Optional[int] = None  # default: the dataset's TrainParams
    batch_size: Optional[int] = None
    synthetic: bool = False  # synthetic readers, no raw data needed
    synthetic_strength: float = 1.0  # class-signal strength of the synthetic readers
    # per-joint gains on the synthetic pose signal, so that it survives the
    # root-joint centering (data/fbg_fog.py::center_pose)
    synthetic_pose_per_joint: bool = False
    n_folds_cap: Optional[int] = None
    verbose: bool = True
    mesh: object = None  # a torch DeviceMesh (gaitpd_torch.runtime.mesh.make_mesh)
    mtl_method: str = "cagrad"  # a key of gaitpd_torch.learning.mtl.METHODS
    ckpt_dir: Optional[str] = None
    resume: bool = False
    save_loss_plots: bool = False  # per-fold loss-curve PNGs (matplotlib)
    rebuild_cache: bool = False  # rebuild the reader pickle cache first
    # train-time augmentation (gaitpd_torch.data.augment): mirror and
    # rotation act on the skeleton stream, noise and the axis mask on both
    aug_mirror_p: float = 0.0
    aug_rot_deg: float = 0.0
    aug_noise_std: float = 0.0
    aug_axis_p: float = 0.0
    device: DeviceLike = None  # None: the card; "cpu" for the plain versions


def check_supported(args: FbgFogArgs) -> None:
    """Raise ValueError for a modality the driver does not know."""
    if args.modality not in MODALITY_MODES:
        raise ValueError(f"modality must be one of {sorted(MODALITY_MODES)}, "
                         f"got {args.modality!r}")


def augment_config(args: FbgFogArgs, skeleton_input_dim: int, modality: str):
    """(specs, strengths) of the in-step augmentation, one a model input, or
    (None, None) when every strength is zero (gaitpd/train/
    fbg_fog_driver.py:82-111). The sensor stream takes the noise and the
    channel mask only, and no spec when neither is on."""
    strengths = dict(mirror_p=args.aug_mirror_p, rot_deg=args.aug_rot_deg,
                     noise_std=args.aug_noise_std, axis_p=args.aug_axis_p)
    if not any(v > 0 for v in strengths.values()):
        return None, None
    pose_spec = AugmentSpec(
        joints=skeleton_input_dim // 3,
        mirror=args.aug_mirror_p > 0, rotation=args.aug_rot_deg > 0,
        noise=args.aug_noise_std > 0, axis_mask=args.aug_axis_p > 0,
    )
    sens_spec = AugmentSpec(noise=args.aug_noise_std > 0, axis_mask=args.aug_axis_p > 0)
    if not (sens_spec.noise or sens_spec.axis_mask):
        sens_spec = None
    if modality == "skeleton":
        specs = (pose_spec,)
    elif modality == "sensor":
        specs = (sens_spec,)
    else:
        specs = (pose_spec, sens_spec)
    return specs, tuple(make_aug_params(**strengths) for _ in specs)


def choose_model(args: FbgFogArgs, dims, generator: Optional[torch.Generator] = None
                 ) -> torch.nn.Module:
    """The model of ``args.modality`` (reference train/utilities.py:35-71),
    its weights drawn from ``generator`` (default: seeded with args.seed).
    The single-modality models keep their LayerNorm head, as in gaitpd."""
    g = generator if generator is not None else torch.Generator().manual_seed(args.seed)
    common = dict(shared_out_channels=dims.shared_out_channels,
                  backbone_dim=dims.backbone_dim, num_classes=dims.num_classes, generator=g)
    if args.modality == "skeleton":
        return SkelModalityModel(dims.skeleton_input_dim, dims.skeleton_output_dim, **common)
    if args.modality == "sensor":
        return SensorModalityModel(dims.sensor_in_channels, dims.sensor_out_channels,
                                   dims.sensor_length, pose_length=dims.pose_length, **common)
    return MultiModalMultiTask(
        dims.skeleton_input_dim, dims.skeleton_output_dim, dims.sensor_in_channels,
        dims.sensor_out_channels, dims.sensor_length, pose_length=dims.pose_length,
        use_norm=args.use_norm_and_cos, use_cosine=args.use_norm_and_cos,
        synchronized_loading=args.synchronized_loading, **common)


def fold_to_device(fold: FusionFold, modality: str, device) -> DeviceFoldData:
    """The fold's arrays of ``modality`` on ``device``, labels as int64, and
    the pools' columns of those streams."""
    if modality == "skeleton":
        tr, ev = (fold.train_pose,), (fold.eval_pose,)
        tp, epool = fold.train_pool[:, :1], fold.eval_pool[:, :1]
    elif modality == "sensor":
        tr, ev = (fold.train_sens,), (fold.eval_sens,)
        tp, epool = fold.train_pool[:, 1:], fold.eval_pool[:, 1:]
    else:
        tr = (fold.train_pose, fold.train_sens)
        ev = (fold.eval_pose, fold.eval_sens)
        tp, epool = fold.train_pool, fold.eval_pool

    def put(arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)

    return DeviceFoldData(
        xs=put(a.x for a in tr),
        ys=put(a.y.astype(np.int64) for a in tr),
        train_pool=tp,
        eval_pool=epool,
        eval_xs=put(a.x for a in ev),
        eval_ys=put(a.y.astype(np.int64) for a in ev),
    )


def _print_epoch(fold_idx, ep, epochs, tr, ev, avg, sync_multimodal):
    if sync_multimodal:
        print(f"[Fold {fold_idx}][Ep {ep+1}/{epochs}] "
              f"Train loss={tr.loss.mean():.3f} | "
              f"Eval loss={ev.loss.mean():.3f} ens_acc={avg:.1f}%")
        return
    accs = list(tr.acc) + [0.0] * (2 - len(tr.acc))
    eaccs = list(ev.acc) + [0.0] * (2 - len(ev.acc))
    print(f"[Fold {fold_idx}][Ep {ep+1}/{epochs}] "
          f"Train loss={tr.loss.mean():.3f} skel={accs[0]:.1f}% sen={accs[-1]:.1f}% | "
          f"Eval loss={ev.loss.mean():.3f} skel={eaccs[0]:.1f}% sen={eaccs[-1]:.1f}% "
          f"avg={avg:.1f}%")


def train_one_fold(
    fold_idx: int,
    reader,
    args: FbgFogArgs,
    train_subj: Sequence[str],
    eval_subj: Sequence[str],
    on_epoch=None,
) -> Tuple[float, float, float]:
    """Train one fold (reference fbg_fog_train.py:269-404); returns
    (skel_acc, sens_acc, best_avg) at the best epoch. ``on_epoch(fold, ep,
    state, train, eval)`` is called after every epoch (ep 0-based)."""
    check_supported(args)
    device = resolve_device(args.device)
    dataset = normalize_dataset_name(args.dataset)
    dims = FBG_FOG_DIMS[dataset]
    tp = FBG_FOG_TRAIN[dataset]
    epochs = args.epochs or tp.epochs
    batch_size = args.batch_size or tp.batch_size
    multimodal = args.modality == "multimodal"
    sync_multimodal = multimodal and args.synchronized_loading
    n_streams = 2 if multimodal else 1

    fold = build_fusion_fold(
        dataset, reader, train_subj, eval_subj,
        synchronized=args.synchronized_loading, seed=args.seed,
        pad_skel=dims.pose_length, pad_sens=dims.sensor_length,
        modality=args.modality,
    )
    data = fold_to_device(fold, args.modality, device)
    # each branch's class counts over the epoch's samples, from the host arrays
    host = {"skeleton": (fold.train_pose,), "sensor": (fold.train_sens,),
            "multimodal": (fold.train_pose, fold.train_sens)}[args.modality]
    counts = [np.bincount(arr.y[data.train_pool[:, k]], minlength=dims.num_classes)
              for k, arr in enumerate(host)]

    aug_specs, aug_params = augment_config(args, dims.skeleton_input_dim, args.modality)
    settings = StepSettings(
        n_streams=n_streams,
        wm=args.wm,
        synchronized=args.synchronized_loading,
        ldam_s=args.ldam_s,
        gcl_m=args.gcl_m,
        gcl_s=args.gcl_s,
        noise_mul=args.noise_mul,
        drw_warmup=args.drw_warmup,
        consistency_lambda=args.consistency_lambda if multimodal else 0.0,
        private_grads="sum",
        augment=aug_specs,
    )
    ctx = make_loss_ctx(settings, counts, device=device, aug_params=aug_params,
                        ldam_max_m=args.ldam_m)

    model = choose_model(args, dims)
    make_optimizer = functools.partial(sgd_torch, lr=tp.learning_rate, momentum=tp.momentum,
                                       weight_decay=tp.weight_decay)
    mtl = None
    if multimodal and args.alpha > 0:
        kwargs = ({"c": args.alpha, "max_norm": args.max_norm}
                  if args.mtl_method in ("cagrad", "log_cagrad") else {})
        mtl = make_method(args.mtl_method, n_streams, **kwargs)
    state, partition = init_train_state(model, make_optimizer, mtl, device)
    if args.mesh is not None:
        replicate(state.module, args.mesh)
    runner = EpochRunner(settings, mtl, partition, mesh=args.mesh)
    writer = mesh_rank(args.mesh) == 0

    rng = np.random.default_rng(args.seed + 1000 * fold_idx)
    generator = torch.Generator(device=device).manual_seed(args.seed + fold_idx)
    stopper = EarlyStopper(patience=tp.patience)
    start_epoch = 0
    if args.ckpt_dir and args.resume:
        meta = restore_fold_checkpoint(args.ckpt_dir, fold_idx, state, rng=rng,
                                       generator=generator)
        if meta is not None:
            start_epoch = meta["epoch"] + 1
            stopper.best = meta["best_metric"]
            stopper.no_improve = meta["no_improve"]
            stopper.best_payload = _best_payload(args, fold_idx, state, runner, data,
                                                 batch_size, ctx, device)
            print(f"[Fold {fold_idx}] resumed from epoch {start_epoch}")

    if args.verbose:
        print(f"Total params: {M.count_params(state.module):,}")

    train_losses, val_losses = [], []
    for ep in range(start_epoch, epochs):
        state.epoch = ep
        order = rng.permutation(len(data.train_pool))
        state, tr = run_train_epoch(runner, state, data, order, batch_size, generator, ctx)
        ev = run_eval_epoch(runner, state, data, batch_size, generator, ctx, collect=True)
        train_losses.append(float(tr.loss.mean()))
        val_losses.append(float(ev.loss.mean()))
        if sync_multimodal:
            avg = ev.ens_acc
        elif multimodal:
            avg = float((ev.acc[0] + ev.acc[1]) / 2)
        else:
            avg = float(ev.acc[0])
        improved = stopper.update(avg, payload=ev)
        if args.ckpt_dir and writer:
            save = functools.partial(save_fold_checkpoint, args.ckpt_dir, fold_idx, state,
                                     best_metric=stopper.best, rng=rng, generator=generator)
            save(no_improve=stopper.no_improve)
            if improved:
                save(latest=False)
        if on_epoch is not None:
            on_epoch(fold_idx, ep, state, tr, ev)
        if args.verbose:
            _print_epoch(fold_idx, ep, epochs, tr, ev, avg, sync_multimodal)
        if not improved and stopper.stop:
            print(f"[Fold {fold_idx}] Early stopping at epoch {ep+1}")
            break

    if args.save_loss_plots and writer:
        M.save_loss_curve("loss_plots", fold_idx, train_losses, val_losses,
                          tag=f"{dataset}_{args.modality}_{args.wm}_loss_curve")

    best = stopper.best_payload
    if best is None:
        return 0.0, 0.0, 0.0

    def _acc(i):
        return M.accuracy(best.preds[i], best.trues[i])

    if args.modality == "skeleton":
        sk_acc, se_acc = _acc(0), 0.0
    elif args.modality == "sensor":
        sk_acc, se_acc = 0.0, _acc(0)
    else:
        sk_acc, se_acc = _acc(0), _acc(1)

    if args.verbose:
        if sync_multimodal:
            print(f"\n*** Fold {fold_idx} Best Ensemble Acc: {stopper.best:.2f}% ***\n")
        else:
            print(f"\n*** Fold {fold_idx} Best skel={sk_acc:.2f}% sens={se_acc:.2f}%, "
                  f"avg={stopper.best:.2f}% ***\n")
        if args.modality in ("multimodal", "skeleton"):
            M.print_report(best.trues[0], best.preds[0], "Best Skeleton")
        if args.modality in ("multimodal", "sensor"):
            i = 0 if args.modality == "sensor" else 1
            M.print_report(best.trues[i], best.preds[i], "Best Sensor")
        if sync_multimodal:
            M.print_report(best.trues[0], best.preds_ens, "Best Ensemble")

    return sk_acc, se_acc, float(stopper.best)


def _best_payload(args, fold_idx, state, runner, data, batch_size, ctx, device):
    """The best epoch's eval predictions of a resumed fold: its ``best``
    module evaluated again (the predictions draw nothing; a generator of its
    own keeps the fold's untouched), or None without a ``best`` snapshot.
    gaitpd keeps no payload across a resume; the port's resumed run then
    reports what an uninterrupted one does."""
    best = load_snapshot(args.ckpt_dir, fold_idx, "best", map_location=device)
    if best is None:
        return None
    module = copy.deepcopy(state.module)
    module.load_state_dict(best["module"])
    best_state = dataclasses.replace(state, module=module, epoch=best["epoch"])
    return run_eval_epoch(runner, best_state, data, batch_size,
                          torch.Generator(device=device).manual_seed(0), ctx, collect=True)


def get_reader(args: FbgFogArgs):
    """The synthetic reader of ``args.dataset``, or the raw one from the
    reader cache (gaitpd_torch.data.cache; building it needs pandas)."""
    dataset = normalize_dataset_name(args.dataset)
    if args.synthetic:
        from gaitpd_torch.data import synthetic

        make = synthetic.make_fbg_reader if dataset == "fbg" else synthetic.make_fog_reader
        return make(seed=args.seed, strength=args.synthetic_strength,
                    pose_per_joint=args.synthetic_pose_per_joint)
    from gaitpd_torch.data.cache import load_reader

    return load_reader(dataset, rebuild=args.rebuild_cache)


def main(args: FbgFogArgs, on_epoch=None, reader=None):
    """Every fold of every mode of ``args.modality`` (reference
    fbg_fog_train.py:410-436); returns {mode: {"skel", "sensor", "avg"}},
    the means over folds. ``reader``: a reader to train on instead of
    ``get_reader(args)``'s (a synthetic one of other sizes, say)."""
    check_supported(args)
    resolve_device(args.device)  # no card and no device="cpu": raise before any work
    dataset = normalize_dataset_name(args.dataset)
    reader = get_reader(args) if reader is None else reader
    rng = np.random.default_rng(args.seed)
    label_dict = fbg_label_dict(reader) if dataset == "fbg" else fog_label_dict(reader)
    folds = generate_class_stratified_folds(label_dict, rng)
    if args.n_folds_cap:
        folds = folds[: args.n_folds_cap]

    summary = {}
    for mod in MODALITY_MODES[args.modality]:
        args = dataclasses.replace(args, modality=mod)
        print(f"\n>>> MODE: {mod.upper()} <<<")
        results = []
        for idx, (t, e) in enumerate(folds, 1):
            print(f"\nFold {idx}: train={t}, eval={e}")
            results.append(train_one_fold(idx, reader, args, t, e, on_epoch=on_epoch))
        mean_sk, mean_se, mean_av = np.asarray(results).mean(axis=0)
        if mod == "multimodal" and args.synchronized_loading:
            print(f"mean Ensemble Acc: {mean_av:.2f}%")
        else:
            print(f"mean skel={mean_sk:.2f}%, sensor={mean_se:.2f}%, avg={mean_av:.2f}%")
        summary[mod] = dict(skel=mean_sk, sensor=mean_se, avg=mean_av)
    return summary

