"""gaitpd_torch.models.fused (the fused three-stream WearGait forward) on the
CPU, where its backbone is the stream block's plain version.

Against gaitpd's ``make_fused_weargait_apply`` from the same parameters
(gaitpd's ``init``, copied by gaitpd_torch.params), B 4, T 64: the logits
of sync and async mode under the plain, LayerNorm and cosine heads within
2e-5 abs, and the gradients of gaitpd's CE-style loss (tests/test_fused.py)
within 5e-5 abs; a model with ``pool_len`` raises as gaitpd's does.
Against the port's unfused ``WearGaitThreeModal``: the logits within 2e-5,
the same state_dict keys, the same logits under ``torch.func.vmap`` over
stacked parameters; ``run_cv`` fused against unfused within gaitpd's bounds
(macro within 1.0 point, every 7-subset score within 2.0;
tests/test_fused.py), ``run_cv_vmapped`` fused against the sequential
fused ``run_cv`` within tests/test_torch_vmap_cv.py's bounds (train losses
1e-4 relative, each fold's macro and 7-subset scores one eval window), one
``--vmap_hp`` grid of the fused flagship, and ``build_model``'s choice
(fused only for the flagship, as gaitpd's ``flagship_apply``). JAX runs
at f32 (``jax_default_matmul_precision`` "highest", restored after); torch
on one intra-op thread (restored after).
"""

import functools

import numpy as np
import pytest
import torch
from torch.func import functional_call, stack_module_state, vmap

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaitpd.models.fused import make_fused_weargait_apply as jax_fused_apply  # noqa: E402
from gaitpd.models.multitask import WearGaitThreeModal as FlaxModel  # noqa: E402
from gaitpd_torch.models.fused import (  # noqa: E402
    FusedWearGaitThreeModal,
    make_fused_weargait_apply,
)
from gaitpd_torch.models.multitask import WearGaitThreeModal  # noqa: E402
from gaitpd_torch.params import export_flax_params, load_flax_params  # noqa: E402
from gaitpd_torch.train import hp_search as TH  # noqa: E402
from gaitpd_torch.train import vmap_cv as TV  # noqa: E402
from gaitpd_torch.train import weargait_driver as TD  # noqa: E402

B, T = 4, 64
LOGIT_ATOL = 2e-5
GRAD_ATOL = 5e-5
LOSS_RTOL = 1e-4
HEADS = {"plain": (False, False), "norm": (True, False), "cosine": (True, True)}
COMMON = dict(n_folds=2, test_per_class=3, epochs=2, patience=50, synthetic=True,
              verbose=False, seed=0, wm="gcl", alpha=0.5, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_precision():
    saved = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", saved)


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    return [r.normal(size=(B, T, c)).astype(np.float32) for c in (2, 13, 24)]


def _pair(sync, use_norm=False, use_cosine=False):
    """gaitpd's model and parameters, and the port's fused model on them."""
    kw = dict(num_classes=2, use_norm=use_norm, use_cosine=use_cosine, synchronized=sync)
    xs = _inputs()
    fm = FlaxModel(**kw)
    params = fm.init(jax.random.PRNGKey(0), *map(jnp.asarray, xs))
    tm = load_flax_params(FusedWearGaitThreeModal(**kw), params)
    return fm, params, tm, xs


@pytest.mark.parametrize("use_norm,use_cosine", HEADS.values(), ids=HEADS.keys())
@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
def test_fused_logits_match_gaitpd(jax_precision, sync, use_norm, use_cosine):
    fm, params, tm, xs = _pair(sync, use_norm, use_cosine)
    want = jax.jit(jax_fused_apply(fm))(params, *map(jnp.asarray, xs))
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, xs))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == (B, 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LOGIT_ATOL)


def test_fused_gradients_match_gaitpd(jax_precision):
    """Gradients of gaitpd's CE-style loss (tests/test_fused.py) through
    both fused forwards, leaf by leaf in the flax layout."""
    from jax.flatten_util import ravel_pytree

    fm, params, tm, xs = _pair(True, use_norm=True, use_cosine=True)
    y = np.random.default_rng(1).integers(0, 2, size=B)

    def jax_loss(p):
        out = 0.0
        for lg in jax_fused_apply(fm)(p, *map(jnp.asarray, xs)):
            out += -jnp.mean(jax.nn.log_softmax(lg * 10.0)[jnp.arange(B), y])
        return out

    want = jax.jit(jax.grad(jax_loss))(params)
    loss = sum(torch.nn.functional.cross_entropy(lg * 10.0, torch.from_numpy(y))
               for lg in tm(*map(torch.from_numpy, xs)))
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    got = export_flax_params(tm, dict(zip(names, grads)))
    flat_w, _ = ravel_pytree(want)
    flat_g, _ = ravel_pytree(jax.tree_util.tree_map(jnp.asarray, got))
    assert flat_w.shape == flat_g.shape
    np.testing.assert_allclose(np.asarray(flat_g), np.asarray(flat_w), atol=GRAD_ATOL)


def test_pooled_encoders_raise():
    with pytest.raises(ValueError, match="pool_len"):
        FusedWearGaitThreeModal(pool_len=30)
    with pytest.raises(ValueError, match="pool_len"):
        make_fused_weargait_apply(WearGaitThreeModal(pool_len=30))


@pytest.mark.parametrize("use_norm,use_cosine", HEADS.values(), ids=HEADS.keys())
@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
def test_fused_matches_unfused(sync, use_norm, use_cosine):
    kw = dict(use_norm=use_norm, use_cosine=use_cosine, synchronized=sync)
    plain = WearGaitThreeModal(**kw, generator=torch.Generator().manual_seed(3))
    fused = FusedWearGaitThreeModal(**kw, generator=torch.Generator().manual_seed(3))
    assert list(fused.state_dict()) == list(plain.state_dict())
    assert fused.shared_modules == plain.shared_modules
    assert fused.task_modules == plain.task_modules
    xs = [torch.from_numpy(x) for x in _inputs(5)]
    with torch.no_grad():
        want = plain(*xs)
        for got in (fused(*xs), make_fused_weargait_apply(plain)(*xs)):
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, atol=LOGIT_ATOL, rtol=0)


def test_fused_under_vmap_over_stacked_parameters():
    """The block-diagonal kernels are built without in-place writes, so the
    fused forward runs under torch.func.vmap over 3 models' parameters, as
    the stacked folds run it, each equal to its own unfused forward."""
    models = [WearGaitThreeModal(generator=torch.Generator().manual_seed(s)) for s in range(3)]
    params, buffers = stack_module_state(models)
    fused = FusedWearGaitThreeModal()
    xs = [torch.from_numpy(np.stack([x] * 3)) for x in _inputs(6)]

    def one(p, b, xw, xi, xm):
        return functional_call(fused, (p, b), (xw, xi, xm))

    with torch.no_grad():
        got = vmap(one)(params, buffers, *xs)
        for f, m in enumerate(models):
            for g, w in zip(got, m(*(x[f] for x in xs))):
                torch.testing.assert_close(g[f], w, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("option", [{}, dict(baseline="late_fusion"), dict(single_mod="imu")],
                         ids=["flagship", "baseline", "single_mod"])
def test_build_model_takes_fused_for_the_flagship_only(fused, option):
    model = TD.build_model(TD.WearGaitArgs(fused=fused, **option), True)
    assert isinstance(model, FusedWearGaitThreeModal) == (fused and not option)


@functools.lru_cache(maxsize=None)
def _sequential(fused: bool, n_folds_cap=None):
    """The port's run_cv on COMMON: its result, and per fold the per-epoch
    train losses and (best macro, per-mod accuracies, 7-subset scores)."""
    folds, losses = [], {}
    orig = TD.run_fold

    def keep(*a, **k):
        out = orig(*a, **k)
        folds.append(out)
        return out

    TD.run_fold = keep
    try:
        res = TD.run_cv(TD.WearGaitArgs(**COMMON, fused=fused, n_folds_cap=n_folds_cap),
                        on_epoch=lambda fi, ep, st, tr, ev:
                        losses.setdefault(fi, []).append(np.asarray(tr.loss)))
    finally:
        TD.run_fold = orig
    return res, losses, folds


def _eval_share() -> float:
    """One eval window's share of an accuracy, in percent, at the largest
    fold's eval pool."""
    splits = TV._folds_and_splits(TD.WearGaitArgs(**COMMON))
    return 100.0 / max(len(s.test_sync) for s in splits) + 1e-4


def test_fused_run_cv_matches_unfused():
    """Fold 1 of the fused run against the unfused run of fold 1 alone
    (n_folds_cap 1: the same fold, seeds and parameters)."""
    fused_macro, _, fused_masks = _sequential(True)[2][0]
    plain = _sequential(False, 1)[0]
    assert fused_macro == pytest.approx(plain["macro"][0], abs=1.0)
    assert set(fused_masks) == set(TD.MASK_COMBOS)
    for k in plain["masks"]:
        assert fused_masks[k] == pytest.approx(plain["masks"][k], abs=2.0), k


def test_fused_run_cv_vmapped_matches_sequential(monkeypatch):
    """Every fold in one step through the fused forward: each fold within
    the sequential fused run's bounds, and its backbone one call for all
    folds' three streams a forward (a stream-block launch on the card)."""
    built = []
    orig_build = TV.build_model
    monkeypatch.setattr(TV, "build_model", lambda *a, **k: built.append(orig_build(*a, **k))
                        or built[-1])
    vm_losses = []
    res = TV.run_cv_vmapped(TD.WearGaitArgs(**COMMON, fused=True),
                            on_epoch=lambda ep, tr, ev: vm_losses.append(tr["loss"]))
    assert [type(m) for m in built] == [FusedWearGaitThreeModal]
    _, losses, folds = _sequential(True)
    share = _eval_share()
    assert len(res["per_fold_macro"]) == len(folds) == COMMON["n_folds"]
    for f, (macro, _, masks) in enumerate(folds):
        for ep, want in enumerate(losses[f + 1]):
            np.testing.assert_allclose(vm_losses[ep][f], want, rtol=LOSS_RTOL,
                                       err_msg=f"fold {f + 1}, epoch {ep + 1}")
        assert abs(res["per_fold_macro"][f] - macro) <= share
        for mk, score in masks.items():
            assert abs(res["per_fold_masks"][mk][f] - score) <= share, (f, mk)


def test_fused_hp_grid_runs_the_fused_flagship(monkeypatch):
    """One --vmap_hp grid of the fused flagship (2 rows x 2 folds, 1
    epoch): the fused model, both rows ranked with finite scores."""
    built = []
    orig_build = TH.build_model
    monkeypatch.setattr(TH, "build_model", lambda *a, **k: built.append(orig_build(*a, **k))
                        or built[-1])
    grid = TH.make_grid([1e-3, 3e-3])
    res = TH.run_weargait_hp_vmapped(TD.WearGaitArgs(**dict(COMMON, epochs=1), fused=True), grid)
    assert [type(m) for m in built] == [FusedWearGaitThreeModal]
    assert res["grid_size"] == 2 and res["n_folds"] == COMMON["n_folds"]
    assert len(res["table"]) == 2
    assert all(np.isfinite(r["macro_mean"]) for r in res["table"])
