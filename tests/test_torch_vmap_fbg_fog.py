"""gaitpd_torch.train.vmap_cv's FBG/FoG half on the CPU, against the port's
own sequential drivers, fold by fold: ``run_fbg_fog_vmapped`` against
``fbg_fog_driver.main`` and ``run_baseline_seeds_vmapped`` against
``baseline_drivers.main`` run once a seed. Those drivers are held against
gaitpd's by tests/test_torch_fbg_fog_driver.py and
test_torch_baseline_drivers.py; tests/test_torch_vmap_fbg_fog_gaitpd.py
holds the stacked functions against gaitpd's own. No JAX here.

The cases: gaitpd's three configurations of tests/test_vmap_cv.py
(sensor_ce, mm_gcl_cagrad, mm_ce_sync) at 2 epochs on synthetic FoG, one
with the GCL noise and the augmentation and one under PCGrad (each fold's
draws from its own generator), FBG's ``both`` modes; early stop at
patience 1 (a stopped fold's best frozen while the others train on); a run
checkpointed at 2 epochs and resumed to 4, bitwise equal to 4 straight;
the stacked Adam and AdamW (``FoldAdam``): a fold whose batch is all
padding keeps its parameters, moments and step count bitwise, and the
per-fold clip equals each fold's own ``adamw_torch`` step; the seed sweeps
of the cheap-xattn fusion (synced, Adam), FOCAL (async, AdamW with the
clip) and TACA (its dropout drawn from each instance's generator); folds
of unequal size, whose all-padding steps a fold sits out (SGD with FAMO's
state; a sweep's smaller seed under AdamW with the clip); the CLI's
``--vmap_folds``.

Tolerances: per-epoch train losses within 1e-4 relative (the stacked step
sums in other orders); the skeleton, sensor and average accuracies within
one eval sample's share of the fold with the fewest, since an argmax on a
near-tie may flip; each fold's generator bitwise where the sequential run
leaves it; an Adam step within two f32 ulps of the largest parameter, the
tolerance of tests/test_torch_fbg_fog_baselines.py. The module runs with
one intra-op thread (restored after): its steps are many small ops, which
the parallel test workers' threads would otherwise oversubscribe.
"""

import dataclasses

import numpy as np
import pytest
import torch

import gaitpd_torch.cli as TC
import gaitpd_torch.train.baseline_drivers as TB
import gaitpd_torch.train.fbg_fog_driver as TD
import gaitpd_torch.train.vmap_cv as TV
from gaitpd_torch.data import synthetic as syn
from gaitpd_torch.config import FBG_FOG_DIMS, FBG_FOG_TRAIN
from gaitpd_torch.train.cv import fbg_label_dict, fog_label_dict, generate_class_stratified_folds
from gaitpd_torch.train.optim import FoldAdam, adam_torch, adamw_torch
from gaitpd_torch.train.step import StepSettings, TrainState, make_loss_ctx, make_train_step

LOSS_RTOL = 1e-4
ADAM_ULPS = 2 * np.finfo(np.float32).eps
COMMON = dict(epochs=2, synthetic=True, seed=5, verbose=False, device="cpu")
CONFIGS = {
    "sensor_ce": dict(dataset="fog", modality="sensor", wm="ce", alpha=0.0),
    "mm_gcl_cagrad": dict(dataset="fog", modality="multimodal", wm="gcl",
                          use_norm_and_cos=True, alpha=0.1),
    "mm_ce_sync": dict(dataset="fog", modality="multimodal", wm="ce",
                       synchronized_loading=True, alpha=0.0),
    "mm_gcl_noise_aug": dict(dataset="fog", modality="multimodal", wm="gcl", noise_mul=0.5,
                             aug_noise_std=0.05, aug_axis_p=0.2, alpha=0.1),
    "mm_ce_pcgrad": dict(dataset="fog", modality="multimodal", wm="ce", mtl_method="pcgrad",
                         alpha=0.1),
    "fbg_both_ce": dict(dataset="fbg", modality="both", wm="ce"),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eval_share(args, reader=None) -> float:
    """One eval sample's share, in points, of the fold and mode with the
    fewest."""
    reader = TD.get_reader(args) if reader is None else reader
    labels = fbg_label_dict(reader) if args.dataset == "fbg" else fog_label_dict(reader)
    folds = generate_class_stratified_folds(labels, np.random.default_rng(args.seed))
    dims = FBG_FOG_DIMS[args.dataset]
    n = min(len(TD.build_fusion_fold(
        args.dataset, reader, tr, ev, synchronized=args.synchronized_loading, seed=args.seed,
        pad_skel=dims.pose_length, pad_sens=dims.sensor_length, modality=mode).eval_pool)
        for tr, ev in folds for mode in TD.MODALITY_MODES[args.modality])
    return 100.0 / n + 1e-4


def _keep_generators(monkeypatch, module, store):
    """Record the generator each sequential fold evaluates with."""
    orig = module.run_eval_epoch

    def run_eval_epoch(runner, state, data, batch_size, generator, *a, **k):
        if not store or store[-1] is not generator:
            store.append(generator)
        return orig(runner, state, data, batch_size, generator, *a, **k)

    monkeypatch.setattr(module, "run_eval_epoch", run_eval_epoch)


def _keep_stacked_generators(monkeypatch, store):
    orig = TV._instance_streams

    def streams(*a):
        rngs, gens = orig(*a)
        store.extend(gens)
        return rngs, gens

    monkeypatch.setattr(TV, "_instance_streams", streams)


def _assert_losses(seq, vm, epochs):
    """seq: {fold: [per-epoch losses]} of the sequential run; vm: per
    epoch, the stacked run's (F, K) losses (the folds in the same order)."""
    for fi, per_epoch in seq.items():
        for ep, want in enumerate(per_epoch[:epochs]):
            np.testing.assert_allclose(vm[ep][fi - 1], want, rtol=LOSS_RTOL,
                                       err_msg=f"fold {fi}, epoch {ep + 1}")


def _fbg_fog_both(monkeypatch, kw, reader=None):
    """The port's main and run_fbg_fog_vmapped on ``kw`` (and ``reader``):
    summaries, per-fold per-epoch train losses of each mode, and the
    generators."""
    args = TD.FbgFogArgs(**kw)
    seq_losses, vm_losses, seq_gens, vm_gens = [], [], [], []
    _keep_generators(monkeypatch, TD, seq_gens)
    _keep_stacked_generators(monkeypatch, vm_gens)

    def seq_hook(fi, ep, state, tr, ev):
        if fi == 1 and ep == 0:
            seq_losses.append({})
        seq_losses[-1].setdefault(fi, []).append(tr.loss)

    def vm_hook(ep, tr, ev):
        if ep == 1:
            vm_losses.append([])
        vm_losses[-1].append(tr["loss"])

    want = TD.main(args, on_epoch=seq_hook, reader=reader)
    got = TV.run_fbg_fog_vmapped(args, on_epoch=vm_hook, reader=reader)
    return args, want, got, (seq_losses, vm_losses), (seq_gens, vm_gens)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_run_fbg_fog_vmapped_matches_sequential(monkeypatch, name):
    args, want, got, (seq, vm), (seq_gens, vm_gens) = _fbg_fog_both(
        monkeypatch, dict(COMMON, **CONFIGS[name]))
    assert list(got) == list(want) == list(TD.MODALITY_MODES[args.modality])
    for mode_seq, mode_vm in zip(seq, vm):
        _assert_losses(mode_seq, mode_vm, args.epochs)
    share = _eval_share(args)
    for mod in want:
        assert set(got[mod]) == {"skel", "sensor", "avg"}
        for key in got[mod]:
            assert abs(got[mod][key] - want[mod][key]) <= share, (mod, key, got, want)
    assert len(vm_gens) == len(seq_gens)
    assert all(torch.equal(a.get_state(), b.get_state()) for a, b in zip(vm_gens, seq_gens))
    if CONFIGS[name].get("noise_mul"):  # every fold drew
        assert all(not torch.equal(g.get_state(), torch.Generator().manual_seed(
            args.seed + f + 1).get_state()) for f, g in enumerate(vm_gens))


def test_early_stop_freezes_a_stopped_folds_best(monkeypatch):
    """Patience 1 over 5 epochs: a fold stops where its sequential run
    stops (the sequential runs stop at different epochs), while the others
    train on; each fold's best epoch, and so the summary, is the
    sequential run's."""
    monkeypatch.setitem(FBG_FOG_TRAIN, "fog", dataclasses.replace(FBG_FOG_TRAIN["fog"],
                                                                  patience=1))
    kw = dict(COMMON, epochs=5, **CONFIGS["mm_gcl_cagrad"])
    args, want, got, (seq, vm), _ = _fbg_fog_both(monkeypatch, kw)
    epochs_run = sorted(len(v) for v in seq[0].values())
    assert epochs_run[0] < 5 and epochs_run[0] < epochs_run[-1], epochs_run
    _assert_losses(seq[0], vm[0], 5)
    for key in ("skel", "sensor", "avg"):
        assert abs(got["multimodal"][key] - want["multimodal"][key]) <= _eval_share(args)


def test_resume_is_bitwise_an_uninterrupted_run(tmp_path):
    """2 epochs, then a resume to 4, against 4 straight: the stacked
    snapshot's parameters, momentum, method state, best predictions and
    random streams, and the summary, bitwise."""
    kw = dict(COMMON, **CONFIGS["mm_gcl_noise_aug"])
    straight = TV.run_fbg_fog_vmapped(TD.FbgFogArgs(**dict(kw, epochs=4),
                                                    ckpt_dir=str(tmp_path / "a")))
    TV.run_fbg_fog_vmapped(TD.FbgFogArgs(**kw, ckpt_dir=str(tmp_path / "b")))
    resumed = TV.run_fbg_fog_vmapped(TD.FbgFogArgs(**dict(kw, epochs=4), resume=True,
                                                   ckpt_dir=str(tmp_path / "b")))
    assert resumed == straight
    a, b = (TV.load_vmap_snapshot(tmp_path / d / "multimodal") for d in "ab")
    assert a["epoch"] == b["epoch"] == 4
    assert a["best"] == b["best"] and a["no_improve"] == b["no_improve"]
    for key in ("params", "mtl_state", "extras"):
        assert a[key].keys() == b[key].keys()
        assert all(torch.equal(a[key][k], b[key][k]) for k in a[key]), key
    for sa, sb in zip(a["optimizer"]["state"].values(), b["optimizer"]["state"].values()):
        assert torch.equal(sa["momentum_buffer"], sb["momentum_buffer"])
    assert a["rngs"] == b["rngs"]
    assert all(torch.equal(x, y) for x, y in zip(a["generators"], b["generators"]))


def _baseline_step(kind, n_folds):
    """A FoG baseline's stacked state and runner (its driver's optimizer as
    a FoldAdam), one batch of 8 window pairs a fold (fold f's from seed f),
    and for each fold a sequential step and state from its own parameters."""
    args = TB.BaselineArgs(kind=kind, fusion_type="early", seed=3, device="cpu")
    dims = FBG_FOG_DIMS["fog"]
    hp = TB._hp(args, "fog")
    settings = StepSettings(n_streams=2, wm="ce",
                            loss_reduction="mean" if kind == "fusion" else "sum")
    opt_kw = {} if kind == "fusion" else dict(weight_decay=1e-4, grad_clip=1.0)
    models = [TB._build_model(dataclasses.replace(args, seed=s), dims, hp, False)
              for s in range(n_folds)]
    state, _ = TV.init_stacked_state(
        models, lambda p: FoldAdam(p, n_folds, hp["lr"], **opt_kw), None, n_folds, "cpu")
    runner = TV.VmapEpochRunner(settings)
    batches = []
    for f in range(n_folds):
        g = torch.Generator().manual_seed(f)
        batches.append({"xs": (torch.rand((8, dims.pose_length, dims.skeleton_input_dim),
                                          generator=g),
                               torch.randn((8, hp["sensor_length"], dims.sensor_in_channels),
                                           generator=g)),
                        "ys": (torch.randint(0, 3, (8,), generator=g),) * 2})
    batch = {"xs": tuple(torch.stack([b["xs"][i] for b in batches]) for i in range(2)),
             "ys": tuple(torch.stack([b["ys"][i] for b in batches]) for i in range(2))}
    ctx = [make_loss_ctx(settings, [[5, 3, 2]] * 2) for _ in range(n_folds)]
    make = adam_torch if kind == "fusion" else adamw_torch
    seq = []
    for f, m in enumerate(models):
        single = TB._build_model(dataclasses.replace(args, seed=f), dims, hp, False)
        seq.append((TrainState(module=single, optimizer=make(single.parameters(), hp["lr"],
                                                             **opt_kw), mtl_state={}),
                    {"xs": batches[f]["xs"], "ys": batches[f]["ys"]}, ctx[f]))
    return state, runner, batch, TV.stack_ctx(ctx), seq, make_train_step(settings)


@pytest.mark.parametrize("kind", ["fusion", "focal"], ids=["adam", "adamw_clip"])
def test_fold_adam_keeps_a_padded_fold_bitwise(kind):
    """Two steps of every fold, then one where fold 1's batch is all
    padding: fold 1's parameters, Adam moments and step count are what the
    first two steps left, bitwise, and every other fold equals its own
    sequential adam_torch / adamw_torch run within two f32 ulps."""
    n_folds = 3
    state, runner, batch, ctx, seq, step = _baseline_step(kind, n_folds)
    ones = torch.ones((n_folds, 8))
    for _ in range(2):
        state, _ = runner.train_step(state, dict(batch, valid=ones), ctx, False)
    for st, b, c in seq:
        for _ in range(2):
            step(st, dict(b, valid=torch.ones(8), n_valid=8), None, c)
    opt = state.optimizer
    before = {n: (p.detach().clone(), opt.state[p]["exp_avg"].clone(),
                  opt.state[p]["exp_avg_sq"].clone()) for n, p in state.params.items()}
    valid = ones.clone()
    valid[1] = 0.0
    state, _ = runner.train_step(state, dict(batch, valid=valid), ctx, True)
    assert opt.fold_steps == [3, 2, 3]
    for n, p in state.params.items():
        for now, was in zip((p, opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"]), before[n]):
            assert torch.equal(now[1], was[1]), n
            assert not torch.equal(now[0], was[0]) or not torch.equal(now[2], was[2]), n
    for f in (0, 2):
        st, b, c = seq[f]
        step(st, dict(b, valid=torch.ones(8), n_valid=8), None, c)
        got = {n: p[f].detach() for n, p in state.params.items()}
        want = dict(st.module.named_parameters())
        largest = max(w.abs().max().item() for w in want.values())
        gap = max((got[n] - want[n]).abs().max().item() for n in want)
        assert gap <= ADAM_ULPS * largest, (f, gap)


def test_fold_adam_clips_each_fold_by_its_own_norm():
    """FoldAdam with the clip against adamw_torch per fold: gradients whose
    norms lie below the bound in one fold and far above it in others, over
    three steps with a fold idle in the second; each fold's parameters and
    moments within two f32 ulps of its largest value."""
    n_folds, shapes = 3, [(5, 4), (7,), (2, 3, 2)]
    gen = torch.Generator().manual_seed(0)
    stacked = [torch.randn((n_folds,) + s, generator=gen).requires_grad_() for s in shapes]
    singles = [[p[f].detach().clone().requires_grad_() for p in stacked] for f in range(n_folds)]
    opt = FoldAdam(stacked, n_folds, 1e-3, weight_decay=1e-4, grad_clip=1.0)
    seq = [adamw_torch(ps, 1e-3, weight_decay=1e-4, grad_clip=1.0) for ps in singles]
    scale = torch.tensor([0.01, 3.0, 30.0])  # fold 0 below the bound, 1 and 2 above
    for stepped in ([True] * 3, [True, False, True], [True] * 3):
        grads = [torch.randn((n_folds,) + s, generator=gen)
                 * scale.reshape((-1,) + (1,) * len(s)) for s in shapes]
        for p, g in zip(stacked, grads):
            p.grad = g.clone()
        opt.step(stepped)
        for f in range(n_folds):
            if stepped[f]:
                for p, g in zip(singles[f], grads):
                    p.grad = g[f].clone()
                seq[f].step()
    assert opt.fold_steps == [3, 2, 3]
    for f in range(n_folds):
        for i, p in enumerate(stacked):
            single = singles[f][i]
            for got, want in ((p[f], single), (opt.state[p]["exp_avg"][f],
                                              seq[f].state[single]["exp_avg"])):
                tol = ADAM_ULPS * max(1.0, want.abs().max().item())
                assert (got.detach() - want.detach()).abs().max().item() <= tol, (f, i)


SEED_CASES = {
    "fusion_cheap_xattn_sync": ("fusion", "cheap_xattn", True),
    "focal_async": ("focal", "cheap_xattn", False),
    "taca_async": ("taca", "cheap_xattn", False),
}


def _keep_padded(monkeypatch, store):
    """Record each stacked train step's ``padded`` flag."""
    orig = TV.VmapEpochRunner.train_step

    def train_step(runner, state, batch, ctx, padded, *a, **k):
        store.append(padded)
        return orig(runner, state, batch, ctx, padded, *a, **k)

    monkeypatch.setattr(TV.VmapEpochRunner, "train_step", train_step)


def _seed_sweeps_both(monkeypatch, kind, variant, synced, share, batch_size=None):
    """run_baseline_seeds_vmapped of seeds [0, 1], 2 folds a seed, 2 epochs,
    against baseline_drivers.main of each seed: per instance the per-epoch
    train losses and its generator at the end, per seed the summary within
    ``share``. Returns the stacked optimizer's step counts and each
    sequential fold's, in (seed, fold) order."""
    seeds, epochs = [0, 1], 2
    seq_gens, vm_gens, seq_losses, vm_losses, seq_steps, stacked = [], [], [], [], [], []
    _keep_generators(monkeypatch, TB, seq_gens)
    _keep_stacked_generators(monkeypatch, vm_gens)
    orig_init = TV.init_stacked_state

    def init(*a, **k):
        stacked.append(orig_init(*a, **k)[0])
        return stacked[-1], None

    monkeypatch.setattr(TV, "init_stacked_state", init)
    got = TV.run_baseline_seeds_vmapped(
        "fog", kind, variant, seeds, synced=synced, epochs=epochs, n_folds_cap=2, synthetic=True,
        batch_size=batch_size, device="cpu",
        on_epoch=lambda ep, tr, ev: vm_losses.append(tr["loss"]))
    assert sorted(got) == seeds

    def hook(losses, fi, ep, st, tr, ev):
        losses.setdefault(fi, []).append(tr.loss)
        if ep == epochs - 1:
            seq_steps.append(int(st.optimizer.state[next(st.module.parameters())]["step"]))

    for seed in seeds:
        args = TB.BaselineArgs(kind=kind, dataset="fog", fusion_type=variant, synced=synced,
                               seed=seed, epochs=epochs, n_folds_cap=2, synthetic=True,
                               batch_size=batch_size, verbose=False, device="cpu")
        losses = {}
        want = TB.main(args, on_epoch=lambda *a, losses=losses: hook(losses, *a))
        seq_losses.append(losses)
        for key in ("skel", "sensor", "avg"):
            assert abs(got[seed][key] - want[key]) <= share, (seed, key, got[seed], want)
    for s, losses in enumerate(seq_losses):
        _assert_losses(losses, [v[2 * s:2 * s + 2] for v in vm_losses], epochs)
    assert len(vm_gens) == len(seq_gens) == 4
    assert all(torch.equal(a.get_state(), b.get_state()) for a, b in zip(vm_gens, seq_gens))
    return stacked[0].optimizer.fold_steps, seq_steps


@pytest.mark.parametrize("name", sorted(SEED_CASES))
def test_baseline_seeds_vmapped_matches_sequential(monkeypatch, name):
    """Every (seed, fold) instance in one stack against the sequential
    driver of each seed (``_seed_sweeps_both``; a synthetic FoG fold
    evaluates 3 subjects' 4 segments)."""
    fold_steps, seq_steps = _seed_sweeps_both(monkeypatch, *SEED_CASES[name], 100.0 / 12 + 1e-4)
    assert fold_steps == seq_steps


def _fog_reader_without(seed, subject, keep):
    """Synthetic FoG with all but ``keep`` of ``subject``'s segments taken
    out: the folds that train on it hold fewer windows than the others."""
    reader = syn.make_fog_reader(seed=seed)
    n = len(reader.labels_dict[subject])
    for i in range(keep, n):
        del reader.pose_dict[f"{subject}_{i}"], reader.sensor_dict[f"{subject}_{i}"]
    reader.labels_dict[subject] = reader.labels_dict[subject][:keep]
    return reader


def test_ragged_folds_pad_and_match_sequential(monkeypatch):
    """Folds of 26, 26 and 30 train windows at batch 4 (SUB00 keeps 2 of
    its 6 segments): each epoch's last step is all padding in two folds,
    which keep their parameters, momentum and FAMO state (K = 2, a method
    state a fold); every fold as its sequential run."""
    reader = _fog_reader_without(5, "SUB00", 2)
    padded = []
    _keep_padded(monkeypatch, padded)
    kw = dict(COMMON, dataset="fog", modality="multimodal", wm="ce", mtl_method="famo",
              alpha=0.1, batch_size=4)
    args, want, got, (seq, vm), (seq_gens, vm_gens) = _fbg_fog_both(monkeypatch, kw, reader)
    assert sum(padded) == args.epochs, padded
    _assert_losses(seq[0], vm[0], args.epochs)
    for key in ("skel", "sensor", "avg"):
        assert abs(got["multimodal"][key] - want["multimodal"][key]) <= _eval_share(args, reader)
    assert all(torch.equal(a.get_state(), b.get_state()) for a, b in zip(vm_gens, seq_gens))


def test_seed_sweep_pads_the_smaller_seeds_folds(monkeypatch):
    """FOCAL (AdamW with the clip) at batch 8 over seed 0's folds of 30
    train windows and seed 1's of 66 (10 segments a subject): seed 0's
    instances sit out 5 of the 9 steps an epoch as all padding, keeping
    their parameters, moments and step counts; every instance as its
    sequential run, its step count too."""
    readers = {0: syn.make_fog_reader(seed=0), 1: syn.make_fog_reader(seed=1, segments=10)}
    monkeypatch.setattr(TV, "get_baseline_reader", lambda args: readers[args.seed])
    monkeypatch.setattr(TB, "get_reader", lambda args: readers[args.seed])
    padded = []
    _keep_padded(monkeypatch, padded)
    fold_steps, seq_steps = _seed_sweeps_both(monkeypatch, "focal", "cheap_xattn", False,
                                              100.0 / 12 + 1e-4, batch_size=8)
    assert sum(padded) == 2 * 5, padded
    assert fold_steps == seq_steps == [8, 8, 18, 18]


def test_cli_vmap_folds_runs_the_stacked_driver(monkeypatch):
    """python -m gaitpd_torch.cli --mode fbg_fog --vmap_folds reaches
    run_fbg_fog_vmapped and returns gaitpd's summary keys."""
    calls = []
    orig = TV.run_fbg_fog_vmapped

    def stacked(args, *a, **k):
        calls.append(args.modality)
        return orig(args, *a, **k)

    monkeypatch.setattr(TV, "run_fbg_fog_vmapped", stacked)
    out = TC.main(["--mode", "trip", "--modality", "both", "--dataset", "fog", "--wm", "ce",
                   "--synthetic", "--epochs", "1", "--vmap_folds", "--quiet", "--device", "cpu"])
    assert calls == ["both"]
    assert list(out) == ["skeleton", "sensor"]
    assert all(set(v) == {"skel", "sensor", "avg"} for v in out.values())
