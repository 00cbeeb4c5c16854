"""gaitpd_torch.ops.stream_block against the Pallas stream block of
gaitpd.ops.pallas_blocks (interpret mode on the CPU, as tests/test_pallas.py
runs it) and its jnp reference, on the same numpy inputs.

On the CPU the wrapper takes its plain version; tests/test_torch_kernel_card.py
holds the CUDA kernel against that plain version on the card. Tolerance: see
test_torch_pipeline.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaitpd.models.encoders import SharedBackbone as FlaxBackbone  # noqa: E402
from gaitpd.ops.pallas_blocks import make_stream_block  # noqa: E402
from gaitpd.ops.pallas_blocks import stream_block_reference as jax_reference  # noqa: E402
from gaitpd_torch.models.encoders import SharedBackbone  # noqa: E402
from gaitpd_torch.ops import stream_block as sb  # noqa: E402
from gaitpd_torch.params import load_flax_params  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)

# (B, T, C_in, K, C_out, t_out, act): tests/test_pallas.py's cases, the main
# path's shape at a small batch, T = 101 (uneven, overlapping bins) and k = 1
CASES = [
    (8, 64, 13, 3, 16, 8, "relu"),
    (8, 64, 13, 5, 16, 8, "gelu"),
    (6, 64, 12, 3, 16, 8, "relu"),
    (4, 101, 6, 3, 16, 8, "relu"),
    (3, 101, 13, 5, 16, 8, "gelu"),
    (5, 30, 4, 1, 7, 4, "relu"),
    (3, 5, 4, 3, 6, 8, "gelu"),  # t_out > T: bins repeat frames
]


def _inputs(case, seed=0):
    bsz, t, cin, k, cout, _, _ = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bsz, t, cin)).astype(np.float32)
    w = (rng.normal(size=(k, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_matches_pallas_and_jnp(case):
    t_out, act = case[5], case[6]
    x, w, b = _inputs(case)
    got = sb.stream_block(*map(torch.from_numpy, (x, w, b)), t_out, act).numpy()
    assert got.shape == (case[0], t_out, case[4])
    pallas = np.asarray(make_stream_block(act, t_out)(*map(jnp.asarray, (x, w, b))))
    ref = np.asarray(jax_reference(*map(jnp.asarray, (x, w, b)), t_out=t_out, act_name=act))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


def test_cpu_path_counts_no_launch():
    x, w, b = _inputs(CASES[0])
    before = sb.launches
    sb.stream_block(*map(torch.from_numpy, (x, w, b)))
    assert sb.launches == before


@pytest.mark.parametrize("t", [64, 101])
def test_shared_backbone_matches_flax(t):
    rng = np.random.default_rng(t)
    x = rng.normal(size=(4, t, 12)).astype(np.float32)
    fm = FlaxBackbone(16, 8)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.normal(size=a.shape) * 0.1).astype(np.float32),
        fm.init(jax.random.PRNGKey(0), jnp.asarray(x)),
    )
    tm = load_flax_params(SharedBackbone(12, 16, 8, generator=torch.Generator()), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(fm.apply(v, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("bad", ["even_k", "act", "cin", "bias", "t_out"])
def test_wrapper_rejects_bad_arguments(bad):
    x, w, b = map(torch.from_numpy, _inputs(CASES[0]))
    t_out, act = 8, "relu"
    if bad == "even_k":
        w = torch.zeros(2, 13, 16)
    elif bad == "act":
        act = "tanh"
    elif bad == "cin":
        w = torch.zeros(3, 12, 16)
    elif bad == "bias":
        b = torch.zeros(15)
    else:
        t_out = 0
    with pytest.raises(ValueError):
        sb.stream_block(x, w, b, t_out, act)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No silent fallback: a kernel that cannot be built raises."""
    from gaitpd_torch.ops import _build

    assert "stream_block" in _build.sources()
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("stream_block")
