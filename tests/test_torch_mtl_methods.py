"""The 17 MTL methods of gaitpd_torch.learning.mtl and the plain MGDA,
FairGrad and NashMTL solvers against gaitpd's, on fixed (K, P) gradient
matrices built as tests/test_mtl_golden.py builds them, at K = 2 and 3.

- Deterministic methods: one ``combine`` from the initial state, every
  output (shared gradient, private weights, new state, weights) within rtol
  1e-5 and atol 1e-6: f32 on both sides, sums in another order.
- Stateful methods (Uncertainty at lr > 0, DWA across its window, FAMO,
  NashMTL recomputing every 2nd step): 30 steps of varying losses and
  gradients, the states compared after every step, same tolerances.
- Drawing methods (RLW, PCGrad, GradDrop): gaitpd's draw, reproduced from
  its PRNG key, fed to the port's method in place of its own draw, same
  tolerances; the port's own draws on the CPU by their statistics, each
  within 5 sigma.
- The plain solvers: MGDA's objective within 1e-5 relative of gaitpd's (K
  = 2, 3, 4) and, at gaitpd's K = 2 and 3, no worse than scipy's SLSQP by
  1 %, gaitpd's own bound against a simplex grid
  (tests/test_mtl.py::test_min_norm_element): 250 Frank-Wolfe steps stop
  up to 0.3 % above the minimum at K = 3 and 1.2 % at K = 4, in gaitpd as
  in the port; tests/test_mtl.py's checks
  (the brute-force simplex minimum, FairGrad's and NashMTL's fixed-point
  residuals); a batch bitwise equal to its matrices one at a time.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaitpd.learning import minnorm as JN  # noqa: E402
from gaitpd.learning import mtl as JM  # noqa: E402
from gaitpd_torch.learning import minnorm as TN  # noqa: E402
from gaitpd_torch.learning import mtl as TM  # noqa: E402
from gaitpd_torch.ops import mtl_solvers as MS  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
P = 8
DETERMINISTIC = ("stl", "ls", "scaleinvls", "uw", "dwa", "famo", "mgda", "log_mgda", "imtl",
                 "log_imtl", "nashmtl", "fairgrad")
STATEFUL = {
    "uw": dict(lr=0.1),
    "dwa": dict(iteration_window=3),
    "famo": {},
    "nashmtl": dict(update_weights_every=2),
}


def golden(k, seed=7, shared_cols=6):
    """Losses (K,), J_shared (K, P) with its last columns private (zero) and
    its Gram matrix, as tests/test_mtl_golden.py draws them."""
    rng = np.random.default_rng(seed + 10 * k)
    j = rng.normal(size=(k, P)).astype(np.float32)
    j[:, shared_cols:] = 0.0
    losses = (rng.uniform(0.5, 3.0, size=k)).astype(np.float32)
    return losses, j, (j @ j.T).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, what):
    np.testing.assert_allclose(_np(got).astype(np.float64), _np(want).astype(np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _port_state(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def _close_states(got, want, what):
    assert set(got) == set(want), what
    for key in want:
        _close(got[key], want[key], f"{what} state {key}")


def _combine_both(name, k, losses, j, gram, j_state, t_state, key=None, **kw):
    jm, tm = JM.make_method(name, k, **kw), TM.make_method(name, k, **kw)
    ref = jm.combine(jnp.asarray(losses), jnp.asarray(j), jnp.asarray(gram), j_state,
                     key if key is not None else jax.random.PRNGKey(0))
    got = tm.combine(torch.from_numpy(losses), torch.from_numpy(j), torch.from_numpy(gram),
                     t_state)
    return got, ref


def test_methods_table_matches_gaitpd():
    assert set(TM.METHODS) == set(JM.METHODS)


@pytest.mark.parametrize("name", sorted(JM.METHODS))
def test_fields_and_defaults_match_gaitpd(name):
    """Each key builds the same dataclass fields, defaults and clip flag."""
    assert dataclasses.asdict(TM.make_method(name, 3)) == dataclasses.asdict(
        JM.make_method(name, 3))


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("name", DETERMINISTIC)
def test_combine_matches_gaitpd(name, k):
    losses, j, gram = golden(k)
    j_state = JM.make_method(name, k).init_state()
    got, ref = _combine_both(name, k, losses, j, gram, j_state, _port_state(j_state))
    for part, g, r in zip(("shared", "private weights"), got[:2], ref[:2]):
        _close(g, r, f"{name} {part}")
    _close_states(got[2], ref[2], name)
    _close(got[3]["weights"], ref[3]["weights"], f"{name} weights")


def test_task_weights_reach_ls_and_scaleinvls():
    losses, j, gram = golden(3)
    for name in ("ls", "scaleinvls"):
        got, ref = _combine_both(name, 3, losses, j, gram, {}, {}, task_weights=(0.5, 2.0, 1.5))
        _close(got[0], ref[0], name)
        _close(got[1], ref[1], name)


@pytest.mark.parametrize("name", sorted(STATEFUL))
def test_stateful_sequence_matches_gaitpd(name):
    """30 steps: losses and gradients vary; the state after every step."""
    k, kw = 3, STATEFUL[name]
    rng = np.random.default_rng(3)
    jm, tm = JM.make_method(name, k, **kw), TM.make_method(name, k, **kw)
    j_state, t_state = jm.init_state(), tm.init_state(torch.device("cpu"))
    _close_states(t_state, j_state, f"{name} init")
    for step in range(30):
        losses = rng.uniform(0.3, 3.0, size=k).astype(np.float32)
        j = rng.normal(size=(k, P)).astype(np.float32)
        gram = (j @ j.T).astype(np.float32)
        ref = jm.combine(jnp.asarray(losses), jnp.asarray(j), jnp.asarray(gram), j_state,
                         jax.random.PRNGKey(step))
        got = tm.combine(torch.from_numpy(losses), torch.from_numpy(j), torch.from_numpy(gram),
                         t_state)
        what = f"{name} step {step}"
        _close(got[0], ref[0], what)
        _close(got[1], ref[1], what)
        _close_states(got[2], ref[2], what)
        j_state, t_state = ref[2], got[2]


def _jax_draw(name, key, k):
    if name == "rlw":
        return torch.from_numpy(np.array(jax.random.normal(key, (k,), jnp.float32)))
    if name == "pcgrad":
        return torch.from_numpy(np.asarray(jax.random.permutation(key, k)).astype(np.int64))
    return torch.from_numpy(np.array(jax.random.uniform(key, (P,), jnp.float32)))


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("name", ["rlw", "pcgrad", "graddrop"])
def test_drawing_methods_match_gaitpd_on_its_draw(monkeypatch, name, k):
    """gaitpd's draw from its key, given to the port's method as its own."""
    losses, j, gram = golden(k, seed=11)
    cls = type(TM.make_method(name, k))
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        monkeypatch.setattr(cls, "draw", lambda self, *a, d=_jax_draw(name, key, k): d)
        got, ref = _combine_both(name, k, losses, j, gram, {}, {}, key=key)
        _close(got[0], ref[0], f"{name} seed {seed} shared")
        _close(got[1], ref[1], f"{name} seed {seed} private weights")


def test_pcgrad_pure_part_and_mean_reduction():
    """The projection of a row onto itself is a no-op, so the identity and
    a reversed order agree at K = 2; reduction="mean" divides by K."""
    losses, j, gram = golden(2, seed=5)
    jt = torch.from_numpy(j)
    a = TM._pcgrad_project(jt, torch.tensor([0, 1]))
    b = TM._pcgrad_project(jt, torch.tensor([1, 0]))
    torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    gen = torch.Generator().manual_seed(0)
    total = TM.make_method("pcgrad", 2).combine(torch.from_numpy(losses), jt, None, {}, gen)[0]
    gen = torch.Generator().manual_seed(0)
    mean = TM.make_method("pcgrad", 2, reduction="mean").combine(
        torch.from_numpy(losses), jt, None, {}, gen)[0]
    torch.testing.assert_close(mean * 2, total, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["rlw", "pcgrad", "graddrop"])
def test_drawing_methods_need_a_generator(name):
    losses, j, gram = golden(3)
    with pytest.raises(ValueError, match="generator"):
        TM.make_method(name, 3).combine(torch.from_numpy(losses), torch.from_numpy(j),
                                        torch.from_numpy(gram), {})


def test_rlw_draws_mean_weight_one_over_k():
    k, n = 3, 4000
    gen = torch.Generator().manual_seed(1)
    m = TM.make_method("rlw", k)
    losses = torch.ones(k)
    w = torch.stack([TM._rlw_weights(m.draw(losses, gen)) for _ in range(n)]).double()
    sigma = w.std(0) / np.sqrt(n)
    assert torch.all((w.mean(0) - 1.0 / k).abs() <= 5 * sigma), w.mean(0)
    torch.testing.assert_close(w.sum(-1), torch.ones(n, dtype=torch.float64))


def test_pcgrad_draws_every_order_alike():
    k, n = 3, 3000
    gen = torch.Generator().manual_seed(2)
    m = TM.make_method("pcgrad", k)
    counts = dict.fromkeys(itertools.permutations(range(k)), 0)
    for _ in range(n):
        counts[tuple(m.draw(torch.ones(k), gen).tolist())] += 1
    p = 1.0 / len(counts)
    sigma = np.sqrt(n * p * (1 - p))
    assert all(abs(c - n * p) <= 5 * sigma for c in counts.values()), counts


def test_graddrop_keeps_each_sign_at_its_rate():
    """Every column holds (1, 0.5, -0.3): sign purity p = 0.8333; the
    positive entries are kept at rate p, the negative at 1 - p."""
    cols = 20000
    j = torch.tensor([1.0, 0.5, -0.3])[:, None].expand(3, cols).contiguous()
    gen = torch.Generator().manual_seed(3)
    m = TM.make_method("graddrop", 3)
    mask = TM._graddrop_mask(j, m.draw(j, gen))
    p = 0.5 * (1.0 + 1.2 / 1.8)
    for row, rate in ((0, p), (1, p), (2, 1 - p)):
        sigma = np.sqrt(cols * rate * (1 - rate))
        assert abs(mask[row].sum().item() - cols * rate) <= 5 * sigma, (row, mask[row].sum())
    assert torch.equal(mask[0], mask[1])  # one draw a column, shared by its rows


# ---------------------------------------------------------------------------
# the plain solvers
# ---------------------------------------------------------------------------


def random_gram(rng, k, scale=1.0):
    g = rng.normal(size=(k, 6)) * scale
    return g @ g.T + 1e-4 * np.eye(k)


def grams(k, n=12, seed=0):
    """n seeded PSD Gram matrices, then the degenerate ones: zero, rank one
    with tasks of one sign, identical tasks, one task with a zero gradient."""
    rng = np.random.default_rng(seed + k)
    out = [random_gram(rng, k, 1.0 + s % 4) for s in range(n)]
    v = np.abs(rng.normal(size=k)) + 0.1
    zero_task = random_gram(rng, k)
    zero_task[0, :] = zero_task[:, 0] = 0.0
    out += [np.zeros((k, k)), np.outer(v, v), np.full((k, k), 2.0), zero_task]
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_min_norm_matches_gaitpd_and_scipy(k):
    from scipy.optimize import minimize

    g = grams(k)
    got = TN.min_norm_element(torch.from_numpy(g)).numpy()
    for i, gi in enumerate(g):
        g64 = gi.astype(np.float64)
        ref = np.asarray(JN.min_norm_element(jnp.asarray(gi)))
        f_got, f_ref = got[i] @ g64 @ got[i], ref @ g64 @ ref
        assert abs(f_got - f_ref) <= 1e-5 * max(abs(f_ref), 1e-12), (i, f_got, f_ref)
        np.testing.assert_allclose(got[i].sum(), 1.0, atol=1e-5)
        assert np.all(got[i] >= 0)
        if k > 3:
            continue
        res = minimize(lambda x: x @ g64 @ x, np.ones(k) / k, bounds=[(0, 1)] * k,
                       constraints={"type": "eq", "fun": lambda x: 1 - x.sum()})
        assert f_got <= res.fun * 1.01 + 1e-9, (i, f_got, res.fun)


@pytest.mark.parametrize("k", [2, 3])
def test_min_norm_element_beats_the_simplex_grid(k):
    """tests/test_mtl.py::test_min_norm_element, on the port."""
    rng = np.random.default_rng(k)
    gram = random_gram(rng, k)
    w = TN.min_norm_element(torch.from_numpy(gram.astype(np.float32))).numpy()
    best = min(v @ gram @ v for v in rng.dirichlet(np.ones(k), size=20000))
    assert w @ gram @ w <= best * 1.01 + 1e-6


@pytest.mark.parametrize("alpha", [0.5, 1.0, 2.0])
def test_fairgrad_fixed_point(alpha):
    """tests/test_mtl.py::test_fairgrad_fixed_point, on the port, and
    gaitpd's weights within 1e-5 relative on every matrix of ``grams``."""
    gram = random_gram(np.random.default_rng(0), 3)
    w = TN.fairgrad_weights(torch.from_numpy(gram.astype(np.float32)), alpha).numpy()
    resid = gram @ w - np.power(w, -1.0 / alpha)
    assert np.abs(resid).max() < 1e-2, (alpha, w, resid)
    g = grams(3)
    got = TN.fairgrad_weights(torch.from_numpy(g), alpha).numpy()
    for i, gi in enumerate(g):
        ref = np.asarray(JN.fairgrad_weights(jnp.asarray(gi), jnp.asarray(alpha, jnp.float32)))
        np.testing.assert_allclose(got[i], ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max(),
                                   err_msg=f"matrix {i}")


def test_nashmtl_fixed_point():
    """tests/test_mtl.py::test_nashmtl_fixed_point, on the port, and
    gaitpd's weights within 1e-5 relative on every normalised matrix."""
    gram = random_gram(np.random.default_rng(1), 3)
    gram = gram / np.linalg.norm(gram)
    a = TN.nashmtl_weights(torch.from_numpy(gram.astype(np.float32))).numpy()
    resid = gram @ a - 1.0 / a
    assert np.abs(resid).max() < 1e-3, (a, resid)
    g = grams(3)
    g = (g / np.maximum(np.linalg.norm(g, axis=(1, 2)), 1e-8)[:, None, None]).astype(np.float32)
    got = TN.nashmtl_weights(torch.from_numpy(g)).numpy()
    for i, gi in enumerate(g):
        ref = np.asarray(JN.nashmtl_weights(jnp.asarray(gi)))
        np.testing.assert_allclose(got[i], ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max(),
                                   err_msg=f"matrix {i}")


@pytest.mark.parametrize("solver", ["min_norm", "fairgrad", "nashmtl"])
def test_batched_equals_one_by_one(solver):
    fns = {"min_norm": TN.min_norm_element, "nashmtl": TN.nashmtl_weights,
           "fairgrad": lambda g: TN.fairgrad_weights(g, 0.5)}
    fn = fns[solver]
    g = torch.from_numpy(grams(3, n=4))
    batched = fn(g)
    for gi, wi in zip(g, batched):
        torch.testing.assert_close(fn(gi), wi, rtol=0, atol=0)


def test_solver_wrappers_take_the_plain_version_on_cpu():
    g = torch.from_numpy(grams(3, n=3))
    before = (MS.min_norm_launches, MS.fairgrad_launches, MS.nashmtl_launches)
    torch.testing.assert_close(MS.min_norm_solve(g), TN.min_norm_element(g), rtol=0, atol=0)
    torch.testing.assert_close(MS.fairgrad_solve(g, 2.0), TN.fairgrad_weights(g, 2.0),
                               rtol=0, atol=0)
    torch.testing.assert_close(MS.nashmtl_solve(g), TN.nashmtl_weights(g), rtol=0, atol=0)
    assert (MS.min_norm_launches, MS.fairgrad_launches, MS.nashmtl_launches) == before
    for bad in (torch.eye(9), torch.zeros(3, 4), torch.zeros(2, 3, 3, 3)):
        with pytest.raises(ValueError):
            MS.min_norm_solve(bad)


@pytest.mark.parametrize("name, alpha", [("fairgrad_solver", (1.0,)), ("nashmtl_solver", ())])
@pytest.mark.parametrize("variant", MS.VARIANTS)
def test_solver_designs_by_name_take_a_cuda_tensor_only(name, alpha, variant):
    """The designs by name are the card's comparison: a CPU tensor has no
    kernel to run and no plain version to fall back on there."""
    with pytest.raises(ValueError, match="CUDA"):
        MS._solve_kernel(name, torch.from_numpy(grams(3, n=2)), *alpha, variant=variant)


@pytest.mark.parametrize("name, alpha", [("fairgrad_solver", (1.0,)), ("nashmtl_solver", ())])
def test_newton_solvers_have_one_design(name, alpha):
    """FairGrad's and NashMTL's one-thread design is gone from the kernel:
    asked for by name, it is refused before any device is looked at, while
    MGDA keeps its thread design as the stop design's yardstick."""
    assert MS.designs(name) == ("warp",)
    assert MS.designs("min_norm_solver") == ("thread", "stop")
    with pytest.raises(ValueError, match="designs \\('warp',\\), not 'thread'"):
        MS._solve_kernel(name, torch.from_numpy(grams(3, n=2)), *alpha, variant="thread")
