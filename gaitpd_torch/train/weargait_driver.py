"""WearGait three-stream training with CAGrad and relaxed-input evaluation.
Port of gaitpd/train/weargait_driver.py:37-47,73-166,169-198,248-533
(reference train/weargait_train.py: run_cv :533-645, train/eval epochs
:300-352, masked eval :355-433, single-modality sub-driver :250-297).

    res = run_cv(WearGaitArgs(synthetic=True, epochs=3))  # on the card
    res = run_cv(WearGaitArgs(synthetic=True, baseline="cheap_xattn"))
    res = run_cv(WearGaitArgs(synthetic=True, single_mod="imu", device="cpu"))

The flagship model (CAGrad), the four fusion baselines (the mean of the
branch losses) and the single-modality mode, on synthetic streams. Options
of the reference trainer that the port does not have yet raise
NotImplementedError naming their ROADMAP item; none is silently ignored.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from gaitpd_torch.data import weargait as WG
from gaitpd_torch.data.synthetic import make_weargait_streams
from gaitpd_torch.learning.mtl import make_method
from gaitpd_torch.models import fusion as FU
from gaitpd_torch.models.multitask import WearGaitThreeModal
from gaitpd_torch.runtime.device import DeviceLike, resolve_device
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
from gaitpd_torch.train.step import StepSettings, make_loss_ctx

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

# the baselines of gaitpd/train/weargait_driver.py:146-153 that the port has
FUSION_BASELINES = {
    "early_fusion": FU.EarlyFusion3,
    "late_fusion": FU.LateFusion3,
    "cheap_xattn": FU.CheapXAttn3,
    "shared_latent": FU.SharedLatent3,
}
UNPORTED_BASELINES = ("deepav_lite", "focal", "taca")

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
    mesh: object = None
    mtl_method: str = "cagrad"  # a key of gaitpd_torch.learning.mtl.METHODS
    ckpt_dir: Optional[str] = None
    resume: bool = False
    modality_dropout: float = 0.0
    fused: bool = False
    aug_noise_std: float = 0.0
    aug_axis_p: float = 0.0
    device: DeviceLike = None  # None: the card; "cpu" for the plain versions


def check_supported(args: WearGaitArgs) -> None:
    """Raise NotImplementedError for an option the port does not have yet."""
    missing = [
        (args.baseline in UNPORTED_BASELINES or args.baseline_torch_init,
         "the DeepAV-Lite, FOCAL and TACA baselines (baseline_torch_init)", "Queue 1, item 13"),
        (args.ckpt_dir is not None or args.resume, "checkpoints (ckpt_dir, resume)",
         "Queue 1, item 9"),
        (args.fused, "the fused forward (fused)", "Queue 1, item 15"),
        (args.aug_noise_std > 0 or args.aug_axis_p > 0 or args.modality_dropout > 0,
         "augmentation and modality dropout", "Queue 1, item 8"),
        (args.mesh is not None, "data-parallel meshes (mesh)", "Queue 1, item 14"),
        (not args.synthetic or args.data_dir is not None,
         "real WearGait data (synthetic=False, data_dir)", "Queue 1, item 5"),
    ]
    for unsupported, what, item in missing:
        if unsupported:
            raise NotImplementedError(f"{what}: not ported yet (ROADMAP {item})")


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
    """The flagship model, one of the fusion baselines, or with ``single_mod``
    the flagship's branch (reference weargait_train.py:458-524,
    gaitpd/train/weargait_driver.py:123-166), its weights drawn from
    ``generator`` (default: seeded with args.seed)."""
    g = generator if generator is not None else torch.Generator().manual_seed(args.seed)
    common = dict(enc_out_ch=args.enc_out_ch, backbone_dim=args.backbone_dim,
                  shared_out_ch=args.shared_out_ch, num_classes=args.num_classes,
                  synchronized=sync_flag, generator=g)
    if args.baseline is not None:
        if args.single_mod is not None:
            raise ValueError("single_mod runs the flagship's branch: it takes no baseline")
        if args.baseline not in FUSION_BASELINES:
            raise ValueError(args.baseline)
        if args.baseline == "shared_latent":
            common["proj_ch"] = args.proj_ch
        return FUSION_BASELINES[args.baseline](**common)
    common.update(use_norm=args.use_norm, use_cosine=args.use_cosine)
    if args.single_mod is not None:
        return SingleBranch(args.single_mod, **common)
    return WearGaitThreeModal(**common)


def get_streams(args: WearGaitArgs):
    """Synthetic streams, the same as gaitpd's for the same seed."""
    n = args.n_folds * args.test_per_class + 4
    return make_weargait_streams(n_pd=n, n_hc=n, seed=args.seed)


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


def run_fold(
    fi: int,
    split: WG.WearGaitSplit,
    args: WearGaitArgs,
    on_epoch: Optional[EpochHook] = None,
) -> Tuple[float, Tuple[float, float, float], Dict[str, float]]:
    """Train one fold; returns (best_macro, per-mod accs, per-mask scores)."""
    check_supported(args)
    device = resolve_device(args.device)
    async_mode = args.async_loading
    sync_flag = not async_mode
    data = split_to_device(split, async_mode, args.seed, device)

    counts = [
        np.bincount(split.train[m].y[data.train_pool[:, k]], minlength=args.num_classes)
        for k, m in enumerate(MODALITIES)
    ]
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
    )
    ctx = make_loss_ctx(settings, counts, device=device)

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
    runner = EpochRunner(settings, mtl, partition)

    rng = np.random.default_rng(args.seed + 1000 * fi)
    generator = torch.Generator(device=device).manual_seed(args.seed + fi)
    stopper = EarlyStopper(patience=args.patience)
    best_params = None
    best_w = best_i = best_m = 0.0

    for ep in range(1, args.epochs + 1):
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
    eval accuracy, no masked table. Returns (best, per-mod accs, {})."""
    check_supported(args)
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
    settings = StepSettings(
        n_streams=1, wm=args.wm, synchronized=False, gcl_m=args.gcl_m, gcl_s=args.gcl_s,
        noise_mul=args.noise_mul, drw_warmup=args.drw_warmup,
    )
    ctx = make_loss_ctx(settings, counts, device=device)
    make_optimizer = functools.partial(sgd_torch, lr=args.lr, momentum=0.9, weight_decay=1e-4)
    state, _ = init_train_state(build_model(args, not async_mode), make_optimizer, None, device)
    runner = EpochRunner(settings)
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
    check_supported(args)
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
