"""WearGait three-stream training with CAGrad and relaxed-input evaluation.
Port of gaitpd/train/weargait_driver.py:37-47,49-68,73-198,248-533
(reference train/weargait_train.py: run_cv :533-645, train/eval epochs
:300-352, masked eval :355-433, single-modality sub-driver :250-297).

    res = run_cv(WearGaitArgs(synthetic=True, epochs=3))  # on the card
    res = run_cv(WearGaitArgs(synthetic=True, baseline="cheap_xattn"))
    res = run_cv(WearGaitArgs(synthetic=True, baseline="focal", device="cpu"))
    res = run_cv(WearGaitArgs(synthetic=True, single_mod="imu", device="cpu"))
    res = run_cv(WearGaitArgs(synthetic=True, fused=True, device="cpu"))
    # the recipe: augmentation, modality dropout, per-fold checkpoints
    res = run_cv(WearGaitArgs(data_dir="data/WearGait/WearGait_preproc_SPmT_30Hz",
                              aug_noise_std=0.05, aug_axis_p=0.2, modality_dropout=0.3,
                              ckpt_dir="ck", resume=True))

The flagship model (CAGrad), the seven baselines (the four fusion models and
DeepAV-Lite, FOCAL and TACA, on the mean of the branch losses) and the
single-modality mode, on synthetic streams or the preprocessed pickles of
real recordings (``synthetic=False``; reading them needs pandas). With
``fused`` the flagship runs the fused forward (gaitpd_torch/models/
fused.py); a baseline and the single-modality mode ignore it, as gaitpd's
do. With ``ckpt_dir`` each fold but a single-modality one saves ``latest``
every epoch and ``best`` on improvement (gaitpd_torch.train.checkpoint),
and ``resume`` continues a fold from its ``latest``. With ``mesh``
(gaitpd_torch/runtime/mesh.py::make_mesh) every train step is data-parallel
over the mesh's ranks, each ending it with the single-process step's
parameters; only the mesh's first rank writes the checkpoints.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from gaitpd_torch.data import weargait as WG
from gaitpd_torch.data.augment import AugmentSpec, make_aug_params
from gaitpd_torch.data.cache import count_weargait_pickles
from gaitpd_torch.data.paths import weargait_paths
from gaitpd_torch.data.readers import discover_weargait_subjects
from gaitpd_torch.data.synthetic import make_weargait_streams
from gaitpd_torch.learning.mtl import make_method
from gaitpd_torch.models import baselines as BL
from gaitpd_torch.models import fusion as FU
from gaitpd_torch.models.fused import FusedWearGaitThreeModal
from gaitpd_torch.models.multitask import WearGaitThreeModal
from gaitpd_torch.runtime.device import DeviceLike, resolve_device
from gaitpd_torch.runtime.mesh import mesh_rank, replicate
from gaitpd_torch.train.checkpoint import (
    load_snapshot,
    restore_fold_checkpoint,
    save_fold_checkpoint,
)
from gaitpd_torch.train.cv import build_subj2label, make_fixed_balanced_folds_no_overlap
from gaitpd_torch.train.loop import (
    DeviceFoldData,
    EarlyStopper,
    EpochResult,
    EpochRunner,
    TrainState,
    init_train_state,
    run_eval_epoch,
    run_train_epoch,
)
from gaitpd_torch.train.optim import sgd_torch
from gaitpd_torch.train.step import EvalApply, StepSettings, TrainApply, make_loss_ctx

# reference weargait_train.py:49-57
MASK_COMBOS = {
    "W": (True, False, False),
    "I": (False, True, False),
    "M": (False, False, True),
    "W+I": (True, True, False),
    "W+M": (True, False, True),
    "I+M": (False, True, True),
    "W+I+M": (True, True, True),
}

MODALITIES = ("walkway", "insole", "imu")

# the baselines of gaitpd/train/weargait_driver.py:146-165: the fusion
# models, then the SOTA baselines
FUSION_BASELINES = {
    "early_fusion": FU.EarlyFusion3,
    "late_fusion": FU.LateFusion3,
    "cheap_xattn": FU.CheapXAttn3,
    "shared_latent": FU.SharedLatent3,
}
SOTA_BASELINES = ("deepav_lite", "focal", "taca")
# the baselines that train with dropout (gaitpd/train/weargait_driver.py:291-292)
DROPOUT_BASELINES = ("deepav_lite", "taca")

# Called after every epoch as on_epoch(fold, epoch, state, train, eval).
EpochHook = Callable[[int, int, TrainState, EpochResult, EpochResult], None]


@dataclasses.dataclass
class WearGaitArgs:
    """CLI surface of the reference trainer (weargait_train.py:648-691)."""

    n_folds: int = 10
    test_per_class: int = 8
    win_len: int = 64
    hop_len: int = 64
    batch_size: int = 64
    epochs: int = 50
    patience: int = 50
    num_classes: int = 2
    lr: float = 1e-3
    seed: int = 43
    async_loading: bool = False
    single_mod: Optional[str] = None
    proj_ch: int = 16
    enc_out_ch: int = 12
    backbone_dim: int = 8
    shared_out_ch: int = 16
    use_norm: bool = False
    use_cosine: bool = False
    baseline: Optional[str] = None
    baseline_torch_init: bool = False
    wm: str = "gcl"
    gcl_m: float = 0.2
    gcl_s: float = 25.0
    noise_mul: float = 0.0
    drw_warmup: int = 0
    alpha: float = 0.5
    synthetic: bool = False
    data_dir: Optional[str] = None
    n_folds_cap: Optional[int] = None
    verbose: bool = True
    mesh: object = None  # a torch DeviceMesh (gaitpd_torch.runtime.mesh.make_mesh)
    mtl_method: str = "cagrad"  # a key of gaitpd_torch.learning.mtl.METHODS
    ckpt_dir: Optional[str] = None
    resume: bool = False
    modality_dropout: float = 0.0
    fused: bool = False
    aug_noise_std: float = 0.0
    aug_axis_p: float = 0.0
    device: DeviceLike = None  # None: the card; "cpu" for the plain versions


def weargait_aug_config(args, n_streams: int = 3):
    """Per-stream (AugmentSpec, strengths) for the WearGait sensor streams
    (gaitpd/train/weargait_driver.py:49-68): noise and the channel mask
    only; ``n_streams=1`` for the single-modality fold. (None, None) when
    every strength is zero."""
    noise, axis = args.aug_noise_std, args.aug_axis_p
    if noise <= 0 and axis <= 0:
        return None, None
    specs = (AugmentSpec(noise=noise > 0, axis_mask=axis > 0),) * n_streams
    params = tuple(make_aug_params(noise_std=noise, axis_p=axis) for _ in range(n_streams))
    return specs, params


class SingleBranch(WearGaitThreeModal):
    """The flagship model run on one branch: ``forward(x)`` is
    ``forward_single(x, mod)``, as the reference applies it with
    ``method=forward_single`` (gaitpd/train/weargait_driver.py:426-428). Its
    parameters are the flagship's, under the same names."""

    def __init__(self, mod: str, **kw):
        super().__init__(**kw)
        self.mod = mod

    def forward(self, x):
        return self.forward_single(x, self.mod)


def build_model(args: WearGaitArgs, sync_flag: bool,
                generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    """The flagship model, one of the baselines, or with ``single_mod`` the
    flagship's branch (reference weargait_train.py:458-524,
    gaitpd/train/weargait_driver.py:123-166), its weights drawn from
    ``generator`` (default: seeded with args.seed). ``baseline_torch_init``
    reaches DeepAV-Lite alone, as in gaitpd. With ``fused`` the flagship is
    gaitpd_torch.models.fused.FusedWearGaitThreeModal (the same parameters,
    the fused forward); a baseline or ``single_mod`` ignores it, as gaitpd's
    ``flagship_apply`` (gaitpd/train/weargait_driver.py:232-244)."""
    g = generator if generator is not None else torch.Generator().manual_seed(args.seed)
    common = dict(enc_out_ch=args.enc_out_ch, backbone_dim=args.backbone_dim,
                  shared_out_ch=args.shared_out_ch, num_classes=args.num_classes,
                  synchronized=sync_flag, generator=g)
    if args.baseline is not None:
        if args.single_mod is not None:
            raise ValueError("single_mod runs the flagship's branch: it takes no baseline")
        if args.baseline == "deepav_lite":
            return BL.DeepAVLite3(num_classes=args.num_classes, synchronized=sync_flag,
                                  torch_init=args.baseline_torch_init, generator=g)
        if args.baseline == "focal":
            return BL.FOCALSharedLatent3(num_classes=args.num_classes,
                                         synchronized=sync_flag, generator=g)
        if args.baseline == "taca":
            return BL.TACA3TriWrapper(win_len=args.win_len, num_classes=args.num_classes,
                                      synchronized=sync_flag, generator=g)
        if args.baseline not in FUSION_BASELINES:
            raise ValueError(args.baseline)
        if args.baseline == "shared_latent":
            common["proj_ch"] = args.proj_ch
        return FUSION_BASELINES[args.baseline](**common)
    common.update(use_norm=args.use_norm, use_cosine=args.use_cosine)
    if args.single_mod is not None:
        return SingleBranch(args.single_mod, **common)
    if args.fused:
        return FusedWearGaitThreeModal(**common)
    return WearGaitThreeModal(**common)


def get_streams(args: WearGaitArgs):
    """(streams, PD ids, HC ids): synthetic streams, the same as gaitpd's for
    the same seed, or the per-subject pickles in ``args.data_dir`` (default:
    gaitpd_torch.data.paths.weargait_paths()["output_dir"]), written by
    gaitpd_torch.data.preprocess_weargait."""
    if args.synthetic:
        n = args.n_folds * args.test_per_class + 4
        return make_weargait_streams(n_pd=n, n_hc=n, seed=args.seed)
    data_dir = Path(args.data_dir or weargait_paths()["output_dir"])
    if count_weargait_pickles(data_dir) == 0:
        raise FileNotFoundError(
            f"no WearGait pickles in {data_dir}: run "
            "python -m gaitpd_torch.data.preprocess_weargait, or pass synthetic=True")
    pd_ids, hc_ids = discover_weargait_subjects(data_dir)
    return WG.load_pkl_streams(data_dir, pd_ids + hc_ids), pd_ids, hc_ids


def split_to_device(split: WG.WearGaitSplit, async_mode: bool, seed: int,
                    device) -> DeviceFoldData:
    tr = [split.train[m] for m in MODALITIES]
    te = [split.test[m] for m in MODALITIES]
    if async_mode:
        train_pool = WG.async_pool(split.train, np.random.default_rng(seed))
        eval_pool = WG.async_pool(split.test, np.random.default_rng(seed + 1))
    else:
        train_pool, eval_pool = split.train_sync, split.test_sync

    def put(arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)

    return DeviceFoldData(
        xs=put(s.x for s in tr),
        ys=put(s.y.astype(np.int64) for s in tr),
        train_pool=train_pool,
        eval_pool=eval_pool,
        eval_xs=put(s.x for s in te),
        eval_ys=put(s.y.astype(np.int64) for s in te),
    )


def baseline_adapters(args: WearGaitArgs) -> Tuple[Optional[TrainApply], Optional[EvalApply]]:
    """The forwards of a baseline that needs its own (gaitpd/train/
    weargait_driver.py:201-229), or (None, None) for the standard adapters:
    TACA takes flattened windows and the epoch fraction of its γ schedule,
    epoch / max(1, epochs) on the 0-based epoch, in train and eval."""
    if args.baseline != "taca":
        return None, None

    def flat(xs):
        return tuple(x.reshape(x.shape[0], -1) for x in xs)

    def train_apply(module, xs, generator, epoch):
        return module(*flat(xs), train=True, epoch_frac=epoch / max(1, args.epochs),
                      generator=generator)

    def eval_apply(module, xs, epoch):
        return module(*flat(xs), train=False, epoch_frac=epoch / max(1, args.epochs))

    return train_apply, eval_apply


def run_fold(
    fi: int,
    split: WG.WearGaitSplit,
    args: WearGaitArgs,
    on_epoch: Optional[EpochHook] = None,
) -> Tuple[float, Tuple[float, float, float], Dict[str, float]]:
    """Train one fold; returns (best_macro, per-mod accs, per-mask scores)."""
    device = resolve_device(args.device)
    async_mode = args.async_loading
    sync_flag = not async_mode
    data = split_to_device(split, async_mode, args.seed, device)

    counts = [
        np.bincount(split.train[m].y[data.train_pool[:, k]], minlength=args.num_classes)
        for k, m in enumerate(MODALITIES)
    ]
    aug_specs, aug_params = weargait_aug_config(args)
    settings = StepSettings(
        n_streams=3,
        wm=args.wm,
        synchronized=sync_flag,
        gcl_m=args.gcl_m,
        gcl_s=args.gcl_s,
        noise_mul=args.noise_mul,
        drw_warmup=args.drw_warmup,
        consistency_lambda=0.0,
        private_grads="sum_plus_own",
        dropout=args.baseline in DROPOUT_BASELINES,
        modality_dropout=args.modality_dropout,
        augment=aug_specs,
    )
    ctx = make_loss_ctx(settings, counts, device=device, aug_params=aug_params)

    model = build_model(args, sync_flag)
    # CAGrad for the flagship only; the baselines train on the mean of the
    # branch losses (gaitpd/train/weargait_driver.py:282)
    use_cagrad = args.baseline is None and args.single_mod is None and args.alpha > 0
    mtl = None
    if use_cagrad:  # c is CAGrad's strength; other methods take no c
        kwargs = {"c": args.alpha} if args.mtl_method in ("cagrad", "log_cagrad") else {}
        mtl = make_method(args.mtl_method, 3, **kwargs)
    make_optimizer = functools.partial(sgd_torch, lr=args.lr, momentum=0.9, weight_decay=1e-4)
    state, partition = init_train_state(model, make_optimizer, mtl, device)
    if args.mesh is not None:
        replicate(state.module, args.mesh)
    runner = EpochRunner(settings, mtl, partition, *baseline_adapters(args), mesh=args.mesh)

    rng = np.random.default_rng(args.seed + 1000 * fi)
    generator = torch.Generator(device=device).manual_seed(args.seed + fi)
    stopper = EarlyStopper(patience=args.patience)
    best_params = None
    best_w = best_i = best_m = 0.0

    start_epoch = 1
    if args.ckpt_dir and args.resume:
        meta = restore_fold_checkpoint(args.ckpt_dir, fi, state, rng=rng, generator=generator)
        if meta is not None:
            start_epoch = meta["epoch"] + 2  # stored 0-based
            stopper.best = meta["best_metric"]
            stopper.no_improve = meta["no_improve"]
            # best_w/i/m are not in the json, as in gaitpd: they stay 0
            # unless a later epoch improves
            best = load_snapshot(args.ckpt_dir, fi, "best", map_location=device)
            if best is not None:
                best_params = best["module"]
            print(f"[Fold {fi}] resumed from epoch {start_epoch}")

    for ep in range(start_epoch, args.epochs + 1):
        state.epoch = ep - 1
        if async_mode:
            # per-epoch reseed of the modality permutations
            # (reference weargait_train.py:573-574)
            data.train_pool = WG.async_pool(split.train, np.random.default_rng(args.seed + ep))
        order = rng.permutation(len(data.train_pool))
        state, tr = run_train_epoch(runner, state, data, order, args.batch_size, generator, ctx)
        ev = run_eval_epoch(runner, state, data, args.batch_size, generator, ctx)
        vaw, vai, vam = ev.acc_batchmean
        macro = float((vaw + vai + vam) / 3.0) if async_mode else float(ev.ens_acc)
        improved = stopper.update(macro)
        if improved:
            best_w, best_i, best_m = float(vaw), float(vai), float(vam)
            # a snapshot, never an alias of the live parameters
            best_params = {k: v.detach().clone() for k, v in state.module.state_dict().items()}
        if args.ckpt_dir and mesh_rank(args.mesh) == 0:
            save = functools.partial(save_fold_checkpoint, args.ckpt_dir, fi, state,
                                     best_metric=stopper.best, rng=rng, generator=generator)
            save(no_improve=stopper.no_improve)
            if improved:
                save(latest=False)
        if on_epoch is not None:
            on_epoch(fi, ep, state, tr, ev)
        if args.verbose:
            taw, tai, tam = tr.acc_batchmean
            tail = f"macro={macro:5.1f}" if async_mode else f"ens={macro:5.1f}"
            print(
                f"[Fold {fi}] Ep {ep:03d} | "
                f"L=[{tr.loss[0]:.3f},{tr.loss[1]:.3f},{tr.loss[2]:.3f}] "
                f"acc=[{taw:5.1f},{tai:5.1f},{tam:5.1f}] | "
                f"L=[{ev.loss[0]:.3f},{ev.loss[1]:.3f},{ev.loss[2]:.3f}] "
                f"acc=[{vaw:5.1f},{vai:5.1f},{vam:5.1f}] | {tail} "
                f"best={stopper.best:5.1f}"
            )
        if stopper.stop:
            print(f"[Fold {fi}] Early stop at epoch {ep}")
            break

    # --- masked relaxed-input eval at the best epoch (reference :612-622) ---
    mask_scores: Dict[str, float] = {}
    if best_params is not None:
        best_module = copy.deepcopy(state.module)
        best_module.load_state_dict(best_params)
        best_state = dataclasses.replace(state, module=best_module)
        for mk, tup in MASK_COMBOS.items():
            r = run_eval_epoch(runner, best_state, data, args.batch_size, generator, ctx,
                               mask=tup)
            if async_mode:
                enabled = [a for a, on in zip(r.acc_batchmean, tup) if on]
                score = float(np.mean(enabled)) if enabled else 0.0
            else:
                score = float(r.ens_acc)
            mask_scores[mk] = score
            if args.verbose:
                mode = "ASYNC" if async_mode else "SYNC"
                print(f"[{mode}][mask={mk}] acc={score:5.2f}%")

    print(
        f"[Fold {fi}] Best macro acc: {stopper.best:.2f}% "
        f"(W={best_w:.2f} I={best_i:.2f} M={best_m:.2f})"
    )
    return float(stopper.best), (best_w, best_i, best_m), mask_scores


def run_single_mod_fold(
    fi: int,
    split: WG.WearGaitSplit,
    args: WearGaitArgs,
    on_epoch: Optional[EpochHook] = None,
) -> Tuple[float, Tuple[float, float, float], Dict[str, float]]:
    """Single-modality sub-driver (gaitpd/train/weargait_driver.py:400-476,
    reference weargait_train.py:250-297, 579-588): only that branch through
    the shared backbone and its head, a fresh SGD state every epoch, pooled
    eval accuracy, no masked table, augmentation but no modality dropout and
    no checkpoint, as in gaitpd. Returns (best, per-mod accs, {})."""
    device = resolve_device(args.device)
    async_mode = args.async_loading
    k = MODALITIES.index(args.single_mod)
    data3 = split_to_device(split, async_mode, args.seed, device)
    data = DeviceFoldData(
        xs=data3.xs[k:k + 1],
        ys=data3.ys[k:k + 1],
        train_pool=data3.train_pool[:, k:k + 1],
        eval_pool=data3.eval_pool[:, k:k + 1],
        eval_xs=data3.eval_xs[k:k + 1],
        eval_ys=data3.eval_ys[k:k + 1],
    )
    counts = [np.bincount(split.train[args.single_mod].y[data.train_pool[:, 0]],
                          minlength=args.num_classes)]
    aug_specs, aug_params = weargait_aug_config(args, n_streams=1)
    settings = StepSettings(
        n_streams=1, wm=args.wm, synchronized=False, gcl_m=args.gcl_m, gcl_s=args.gcl_s,
        noise_mul=args.noise_mul, drw_warmup=args.drw_warmup, augment=aug_specs,
    )
    ctx = make_loss_ctx(settings, counts, device=device, aug_params=aug_params)
    make_optimizer = functools.partial(sgd_torch, lr=args.lr, momentum=0.9, weight_decay=1e-4)
    state, _ = init_train_state(build_model(args, not async_mode), make_optimizer, None, device)
    if args.mesh is not None:
        replicate(state.module, args.mesh)
    runner = EpochRunner(settings, mesh=args.mesh)
    rng = np.random.default_rng(args.seed + 1000 * fi)
    generator = torch.Generator(device=device).manual_seed(args.seed + fi)
    stopper = EarlyStopper(patience=args.patience)
    for ep in range(1, args.epochs + 1):
        state.epoch = ep - 1
        # the reference builds a fresh SGD optimizer every epoch
        # (weargait_train.py:273-276): momentum starts from zero again
        state.optimizer = make_optimizer(state.module.parameters())
        if async_mode:
            data.train_pool = WG.async_pool(
                split.train, np.random.default_rng(args.seed + ep))[:, k:k + 1]
        order = rng.permutation(len(data.train_pool))
        state, tr = run_train_epoch(runner, state, data, order, args.batch_size, generator, ctx)
        ev = run_eval_epoch(runner, state, data, args.batch_size, generator, ctx)
        # pooled accuracy: total correct over total windows
        # (weargait_train.py:292-296), not the 3-stream per-batch means
        va = float(ev.acc[0])
        stopper.update(va)
        if on_epoch is not None:
            on_epoch(fi, ep, state, tr, ev)
        if args.verbose:
            print(
                f"[Fold {fi}] Ep {ep:03d} | {args.single_mod} "
                f"train {float(tr.acc_batchmean[0]):5.2f}% L{float(tr.loss[0]):.3f} | "
                f"val {va:5.2f}% best {stopper.best:5.2f}%"
            )
        if stopper.stop:
            break
    best = stopper.best
    per_mod = tuple(best if args.single_mod == m else 0.0 for m in MODALITIES)
    return float(best), per_mod, {}


def run_cv(args: WearGaitArgs, on_epoch: Optional[EpochHook] = None):
    """reference weargait_train.py:533-645."""
    resolve_device(args.device)  # no card and no device="cpu": raise before any work
    streams, pd_ids, hc_ids = get_streams(args)
    subj2label = build_subj2label(pd_ids, hc_ids)
    folds = make_fixed_balanced_folds_no_overlap(
        pd_ids, hc_ids, n_folds=args.n_folds, per_class=args.test_per_class,
        seed=args.seed,
    )
    if args.n_folds_cap:
        folds = folds[: args.n_folds_cap]

    fold_macro, fold_w, fold_i, fold_m = [], [], [], []
    mask_fold_scores: Dict[str, List[float]] = {k: [] for k in MASK_COMBOS}

    for fi, (train_subs, test_subs) in enumerate(folds, 1):
        print(f"\n=== Fold {fi}/{len(folds)} ===")
        split = WG.prepare_split(
            streams, train_subs, test_subs, subj2label,
            win=args.win_len, hop=args.hop_len,
        )
        fold = run_single_mod_fold if args.single_mod is not None else run_fold
        macro, (bw, bi, bm), masks = fold(fi, split, args, on_epoch)
        fold_macro.append(macro)
        fold_w.append(bw)
        fold_i.append(bi)
        fold_m.append(bm)
        for k, v in masks.items():
            mask_fold_scores[k].append(v)

    print("\n=== Summary ===")
    print(
        f"Macro acc mean ± std: {np.mean(fold_macro):.2f}% ± {np.std(fold_macro):.2f}%"
    )
    print(
        f"Per-mod acc mean ± std: "
        f"[walkway {np.mean(fold_w):.2f} ± {np.std(fold_w):.2f}]  "
        f"[insole {np.mean(fold_i):.2f} ± {np.std(fold_i):.2f}]  "
        f"[imu {np.mean(fold_m):.2f} ± {np.std(fold_m):.2f}]"
    )
    if all(len(v) > 0 for v in mask_fold_scores.values()):
        print("\n=== Masked accuracy at best epoch (avg across folds) ===")
        for mk, arr in mask_fold_scores.items():
            a = np.asarray(arr, float)
            print(f"[{mk:5}] {a.mean():5.2f}% ± {a.std():4.2f}%  over {len(a)} folds")
    return {
        "macro": (float(np.mean(fold_macro)), float(np.std(fold_macro))),
        "per_mod": {
            "walkway": float(np.mean(fold_w)),
            "insole": float(np.mean(fold_i)),
            "imu": float(np.mean(fold_m)),
        },
        "masks": {k: float(np.mean(v)) if v else None for k, v in mask_fold_scores.items()},
    }
