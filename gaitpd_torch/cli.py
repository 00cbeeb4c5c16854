"""The training command line. Port of gaitpd/cli.py:21-300: the same flag
surface, defaults and mode dispatch, plus ``--device``.

Each mode is a call of one of the port's drivers on its Args dataclass:
``fbg_fog`` (and ``trip``, ``single`` without ``--single_mod``) the FBG/FoG
driver's ``main``, or with ``--vmap_folds`` its every-fold-in-one-step
``run_fbg_fog_vmapped``; ``weargait`` (and ``single --single_mod``)
WearGait's ``run_cv``, or with ``--vmap_folds`` ``run_cv_vmapped``; with
``--vmap_hp`` (taken before ``--vmap_folds``) the grid of ``--hp_lrs``,
``--hp_gcl_ms``, ``--hp_gcl_ss`` and ``--hp_alphas`` in one stacked run
(gaitpd_torch/train/hp_search.py; the ``--hp_*`` flags do nothing without
it, as in gaitpd); ``fusion`` and ``deepav``/``focal``/``taca`` the FBG/FoG
baseline drivers (which ignore ``--vmap_folds`` and ``--vmap_hp``, as
gaitpd's do). Runs go to the card unless ``--device cpu`` is given. With
``--data_parallel`` the run takes a mesh over every rank of ``torchrun``'s
group, or a group of one rank without it (gaitpd_torch/runtime/mesh.py):
the sequential drivers shard each train batch over it, ``--vmap_folds`` and
``--vmap_hp`` their folds or instances.

    torchrun --nproc_per_node 2 -m gaitpd_torch.cli --mode weargait --synthetic \\
        --epochs 2 --n_folds 2 --test_per_class 3 --data_parallel --device cpu

    python -m gaitpd_torch.cli --mode weargait --wm gcl --synthetic --epochs 3 \\
        --n_folds 2 --test_per_class 3 --vmap_folds
    python -m gaitpd_torch.cli --mode weargait --baseline taca --async_loading \\
        --synthetic --epochs 3 --n_folds 2 --test_per_class 3 --vmap_folds
    python -m gaitpd_torch.cli --mode weargait --synthetic --epochs 2 --n_folds 2 \\
        --test_per_class 3 --vmap_folds --mtl_method nashmtl
    python -m gaitpd_torch.cli --mode fbg_fog --dataset fog --modality sensor \\
        --wm ce --synthetic --epochs 5 --n_folds_cap 1 --device cpu
    python -m gaitpd_torch.cli --mode fbg_fog --dataset fog --synthetic --epochs 2 \\
        --vmap_folds
    python -m gaitpd_torch.cli --mode weargait --synthetic --epochs 2 --n_folds 2 \\
        --test_per_class 3 --vmap_hp --hp_lrs 1e-3 3e-3 --hp_alphas 0.5 1.0
"""

from __future__ import annotations

import argparse

from gaitpd_torch.runtime.device import MATMUL_PRECISIONS, matmul_precision

MODES = ("fbg_fog", "trip", "single", "weargait", "fusion", "deepav", "focal", "taca")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="gaitpd PyTorch/CUDA training CLI")
    p.add_argument("--mode", type=str, default="fbg_fog", choices=MODES)
    p.add_argument("--dataset", type=str, default="fog")
    p.add_argument("--modality", type=str, default="multimodal",
                   choices=["skeleton", "sensor", "both", "multimodal", "all"])
    p.add_argument("--consistency_lambda", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=43)
    p.add_argument("--wm", type=str, default="gcl",
                   choices=["ce", "class_wt", "ldam", "gcl"])
    p.add_argument("--synchronized_loading", action="store_true")
    p.add_argument("--alpha", type=float, default=None,
                   help="CAGrad c (default 0.1 fbg_fog / 0.5 weargait); 0 disables")
    p.add_argument("--max_norm", type=float, default=1.0)
    p.add_argument("--ldam_s", type=float, default=30.0)
    p.add_argument("--ldam_m", type=float, default=0.5)
    p.add_argument("--gcl_m", type=float, default=0.2)
    p.add_argument("--gcl_s", type=float, default=25.0)
    p.add_argument("--noise_mul", type=float, default=0.0)
    p.add_argument("--drw_warmup", type=int, default=0)
    p.add_argument("--use_norm_and_cos", action="store_true")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="use synthetic readers/streams (no raw data needed)")
    p.add_argument("--synthetic_pose_per_joint", action="store_true",
                   help="per-class per-joint gains on the synthetic pose signal so it "
                        "survives root-joint centering (fbg_fog only; see "
                        "gaitpd_torch/data/synthetic.py)")
    p.add_argument("--n_folds_cap", type=int, default=None)
    p.add_argument("--quiet", action="store_true")
    # WearGait-specific (reference weargait_train.py:648-691)
    p.add_argument("--n_folds", type=int, default=10)
    p.add_argument("--test_per_class", type=int, default=8)
    p.add_argument("--win_len", type=int, default=64)
    p.add_argument("--hop_len", type=int, default=64)
    p.add_argument("--patience", type=int, default=None)
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--async_loading", action="store_true")
    p.add_argument("--single_mod", type=str, default=None,
                   choices=["walkway", "insole", "imu"])
    p.add_argument("--proj_ch", type=int, default=16)
    p.add_argument("--enc_out_ch", type=int, default=12)
    p.add_argument("--backbone_dim", type=int, default=8)
    p.add_argument("--shared_out_ch", type=int, default=16)
    p.add_argument("--use_norm", action="store_true")
    p.add_argument("--use_cosine", action="store_true")
    p.add_argument("--baseline", type=str, default=None,
                   choices=["early_fusion", "late_fusion", "shared_latent",
                            "cheap_xattn", "deepav_lite", "focal", "taca"])
    p.add_argument("--baseline_torch_init", action="store_true",
                   help="DeepAV patch-embed conv uses the torch init law (kaiming_uniform "
                        "kernel + uniform bias) instead of the default lecun_normal + zero "
                        "bias (gaitpd_torch/models/baselines.py::PatchEmbed1D)")
    p.add_argument("--fusion_type", type=str, default="early",
                   choices=["early", "late", "share_latent", "cheap_xattn"])
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--rebuild_cache", action="store_true")
    p.add_argument("--mtl_method", type=str, default="cagrad",
                   help="multitask weighting method (any gaitpd_torch.learning.mtl key)")
    p.add_argument("--ckpt_dir", type=str, default=None,
                   help="enable per-fold checkpoints under this dir "
                        "(gaitpd_torch/train/checkpoint.py; one stacked snapshot with "
                        "--vmap_folds)")
    p.add_argument("--resume", action="store_true",
                   help="resume folds from their latest checkpoint")
    p.add_argument("--save_loss_plots", action="store_true",
                   help="save per-fold train/eval loss curves")
    p.add_argument("--matmul_precision", type=str, default="highest",
                   choices=list(MATMUL_PRECISIONS),
                   help="products' precision on the card: highest = strict f32 (no TF32 "
                        "in cuBLAS or cuDNN; parity with the f32 reference); high and "
                        "default let cuBLAS and cuDNN use TF32")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard batches over every rank of the process group (torchrun's, "
                        "or one rank): torch.distributed, NCCL on the card, gloo on the CPU")
    p.add_argument("--aug_mirror_p", type=float, default=0.0,
                   help="train-time on-device augmentation: per-sample mirror-reflection "
                        "probability (skeleton streams). Negates the x coordinate and, on "
                        "skeletons with >=17 joints (FBG/H36M), also swaps left/right joint "
                        "pairs; 7-keypoint FoG poses get only the sign flip")
    p.add_argument("--aug_rot_deg", type=float, default=0.0,
                   help="train-time random 3-D rotation amplitude in degrees "
                        "(skeleton streams)")
    p.add_argument("--aug_noise_std", type=float, default=0.0,
                   help="train-time additive gaussian noise std (all streams)")
    p.add_argument("--aug_axis_p", type=float, default=0.0,
                   help="train-time probability of zeroing one random coordinate axis / "
                        "channel per sample")
    p.add_argument("--modality_dropout", type=float, default=0.0,
                   help="train-time random modality dropout probability (weargait; "
                        "relaxed-input training)")
    p.add_argument("--fused", action="store_true",
                   help="weargait flagship: block-diagonal fused 3-stream forward (the "
                        "same parameters, logits within ~1e-5; the backbone one kernel "
                        "launch for the three streams; gaitpd_torch/models/fused.py)")
    p.add_argument("--vmap_folds", action="store_true",
                   help="weargait (the flagship under any --mtl_method, any --baseline, "
                        "or --single_mod; the recipe's draws per fold) and fbg_fog/trip/"
                        "single (each --modality mode's folds): train ALL CV folds in one "
                        "step, each kernel launched once for every fold "
                        "(gaitpd_torch/train/vmap_cv.py)")
    p.add_argument("--vmap_hp", action="store_true",
                   help="weargait (any --baseline, or --single_mod) and fbg_fog/trip/single: "
                        "train an (lr x gcl_m x gcl_s x alpha) hyperparameter grid, every "
                        "(row, fold) instance in one step (gaitpd_torch/train/hp_search.py)")
    p.add_argument("--hp_lrs", nargs="+", type=float, default=None,
                   help="lr values for --vmap_hp (default: just --lr)")
    p.add_argument("--hp_gcl_ms", nargs="+", type=float, default=None,
                   help="gcl_m values for --vmap_hp (default: just --gcl_m)")
    p.add_argument("--hp_gcl_ss", nargs="+", type=float, default=None,
                   help="gcl_s values for --vmap_hp (default: just --gcl_s)")
    p.add_argument("--hp_alphas", nargs="+", type=float, default=None,
                   help="CAGrad strength values for --vmap_hp "
                        "(default: just --alpha; must all be >0)")
    p.add_argument("--device", type=str, default=None,
                   help="where to run: the card (default) or cpu (the kernels' plain "
                        "versions)")
    return p


def run_fbg_fog(ns: argparse.Namespace):
    from gaitpd_torch.train.fbg_fog_driver import FbgFogArgs, main

    if ns.modality == "sensor" and (ns.aug_mirror_p > 0 or ns.aug_rot_deg > 0):
        print("warning: --aug_mirror_p/--aug_rot_deg are skeleton-stream "
              "transforms; --modality sensor ignores them "
              "(only --aug_noise_std/--aug_axis_p apply)")

    args = FbgFogArgs(
        dataset=ns.dataset,
        modality=ns.modality,
        consistency_lambda=ns.consistency_lambda,
        seed=ns.seed,
        wm=ns.wm,
        synchronized_loading=ns.synchronized_loading,
        alpha=0.1 if ns.alpha is None else ns.alpha,
        max_norm=ns.max_norm,
        ldam_s=ns.ldam_s,
        ldam_m=ns.ldam_m,
        gcl_m=ns.gcl_m,
        gcl_s=ns.gcl_s,
        noise_mul=ns.noise_mul,
        drw_warmup=ns.drw_warmup,
        use_norm_and_cos=ns.use_norm_and_cos,
        epochs=ns.epochs,
        batch_size=ns.batch_size,
        synthetic=ns.synthetic,
        synthetic_pose_per_joint=ns.synthetic_pose_per_joint,
        n_folds_cap=ns.n_folds_cap,
        verbose=not ns.quiet,
        mtl_method=ns.mtl_method,
        ckpt_dir=ns.ckpt_dir,
        resume=ns.resume,
        save_loss_plots=ns.save_loss_plots,
        rebuild_cache=ns.rebuild_cache,
        mesh=getattr(ns, "mesh", None),
        aug_mirror_p=ns.aug_mirror_p,
        aug_rot_deg=ns.aug_rot_deg,
        aug_noise_std=ns.aug_noise_std,
        aug_axis_p=ns.aug_axis_p,
        device=ns.device,
    )
    if ns.vmap_hp:
        from gaitpd_torch.train.hp_search import make_grid, run_fbg_fog_hp_vmapped

        grid = make_grid(ns.hp_lrs, ns.hp_gcl_ms, ns.hp_gcl_ss, ns.hp_alphas)
        return run_fbg_fog_hp_vmapped(args, grid)
    if ns.vmap_folds:
        from gaitpd_torch.train.vmap_cv import run_fbg_fog_vmapped

        return run_fbg_fog_vmapped(args)
    return main(args)


def run_weargait(ns: argparse.Namespace, baseline: str = None):
    from gaitpd_torch.train.weargait_driver import WearGaitArgs, run_cv

    if ns.aug_mirror_p > 0 or ns.aug_rot_deg > 0:
        print("warning: --aug_mirror_p/--aug_rot_deg are skeleton-stream "
              "transforms; the WearGait sensor streams ignore them "
              "(only --aug_noise_std/--aug_axis_p apply)")

    args = WearGaitArgs(
        n_folds=ns.n_folds,
        test_per_class=ns.test_per_class,
        win_len=ns.win_len,
        hop_len=ns.hop_len,
        batch_size=ns.batch_size or 64,
        epochs=ns.epochs or 50,
        patience=ns.patience if ns.patience is not None else 50,
        num_classes=ns.num_classes,
        lr=ns.lr,
        seed=ns.seed,
        async_loading=ns.async_loading,
        single_mod=ns.single_mod,
        proj_ch=ns.proj_ch,
        enc_out_ch=ns.enc_out_ch,
        backbone_dim=ns.backbone_dim,
        shared_out_ch=ns.shared_out_ch,
        use_norm=ns.use_norm,
        use_cosine=ns.use_cosine,
        baseline=baseline if baseline is not None else ns.baseline,
        baseline_torch_init=ns.baseline_torch_init,
        wm=ns.wm if ns.wm in ("ce", "class_wt", "gcl") else "ce",
        gcl_m=ns.gcl_m,
        gcl_s=ns.gcl_s,
        noise_mul=ns.noise_mul,
        drw_warmup=ns.drw_warmup,
        alpha=0.5 if ns.alpha is None else ns.alpha,
        synthetic=ns.synthetic,
        data_dir=ns.data_dir,
        n_folds_cap=ns.n_folds_cap,
        verbose=not ns.quiet,
        mtl_method=ns.mtl_method,
        ckpt_dir=ns.ckpt_dir,
        resume=ns.resume,
        modality_dropout=ns.modality_dropout,
        fused=ns.fused,
        mesh=getattr(ns, "mesh", None),
        aug_noise_std=ns.aug_noise_std,
        aug_axis_p=ns.aug_axis_p,
        device=ns.device,
    )
    if ns.vmap_hp:
        from gaitpd_torch.train.hp_search import make_grid, run_weargait_hp_vmapped

        grid = make_grid(ns.hp_lrs or [args.lr], ns.hp_gcl_ms or [args.gcl_m],
                         ns.hp_gcl_ss or [args.gcl_s], alphas=ns.hp_alphas)
        return run_weargait_hp_vmapped(args, grid)
    if ns.vmap_folds:
        from gaitpd_torch.train.vmap_cv import run_cv_vmapped

        return run_cv_vmapped(args)
    return run_cv(args)


def run(ns: argparse.Namespace):
    """The mode's driver on the parsed flags (gaitpd/cli.py:279-298)."""
    if ns.mode == "fbg_fog":
        return run_fbg_fog(ns)
    if ns.mode in ("single", "trip"):
        # single-modality conveniences over the same drivers
        if ns.mode == "single" and ns.single_mod:
            return run_weargait(ns)
        return run_fbg_fog(ns)
    if ns.mode == "weargait":
        return run_weargait(ns)
    if ns.mode == "fusion":
        from gaitpd_torch.train.baseline_drivers import run_fusion

        return run_fusion(ns)
    if ns.mode in ("deepav", "focal", "taca"):
        from gaitpd_torch.train.baseline_drivers import run_baseline

        return run_baseline(ns, ns.mode)
    raise ValueError(ns.mode)


def main(argv=None):
    """Parse ``argv`` (default: the process's), then run the mode with the
    products' precision ``--matmul_precision``; the process's precision
    flags are as they were when it returns."""
    ns = build_parser().parse_args(argv)
    ns.mesh = None
    if ns.data_parallel:
        from gaitpd_torch.runtime.mesh import make_mesh, mesh_size

        ns.mesh = make_mesh(device=ns.device)
        print(f"Data-parallel mesh over {mesh_size(ns.mesh)} device(s)")
    print("Arguments:", ns)
    with matmul_precision(ns.matmul_precision):
        return run(ns)


if __name__ == "__main__":
    main()
