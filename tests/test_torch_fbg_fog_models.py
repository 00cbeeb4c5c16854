"""gaitpd_torch.models.multitask's FBG/FoG models against
gaitpd.models.multitask on the CPU: MultiModalMultiTask (sync and async,
plain and LayerNorm + cosine heads), SkelModalityModel and
SensorModalityModel at the published FBG and FoG widths, from the same flax
parameters (gaitpd_torch.params.load_flax_params) on the same seeded inputs.

Tolerances: logits within 1e-5 (f32 on both sides; the convolutions and
pooling sum in another order); the gradients of a weighted sum of the
logits within rtol 1e-4 and an atol of 1e-5 of the leaf's largest value
(floored at 1), as the repo's other gradient checks scale theirs: FBG's
skeleton encoder normalises 3 features a frame, and its kernel's gradient
(largest value 6.3) sums 404 frames' terms that cancel, 6.2e-5 apart
between the two packages. The flat partition of the multimodal
model (gaitpd_torch.learning.mtl.build_flat_partition over its
shared_modules / task_modules) marks the same leaves shared, and gives
them the same task, as gaitpd's module_mask.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from gaitpd.config import FBG_FOG_DIMS  # noqa: E402
from gaitpd.models import multitask as JMT  # noqa: E402
from gaitpd_torch.learning.mtl import build_flat_partition  # noqa: E402
from gaitpd_torch.models import blocks as TB  # noqa: E402
from gaitpd_torch.models import multitask as TMT  # noqa: E402
from gaitpd_torch.params import export_flax_params, load_flax_params  # noqa: E402

LOGIT_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
BATCH = 4


def _inputs(dims, seed):
    rng = np.random.default_rng(seed)
    skel = rng.normal(size=(BATCH, dims.pose_length, dims.skeleton_input_dim)).astype(np.float32)
    sens = rng.normal(size=(BATCH, dims.sensor_length, dims.sensor_in_channels)
                      ).astype(np.float32)
    return skel, sens


def _models(kind, dims, sync, norm):
    """(flax model, port model, which inputs) of one case."""
    if kind == "multimodal":
        fm = JMT.MultiModalMultiTask(
            skeleton_output_dim=dims.skeleton_output_dim,
            sensor_out_channels=dims.sensor_out_channels, sensor_length=dims.sensor_length,
            pose_length=dims.pose_length, use_norm=norm, use_cosine=norm,
            synchronized_loading=sync)
        tm = TMT.MultiModalMultiTask(
            dims.skeleton_input_dim, dims.skeleton_output_dim, dims.sensor_in_channels,
            dims.sensor_out_channels, dims.sensor_length, pose_length=dims.pose_length,
            use_norm=norm, use_cosine=norm, synchronized_loading=sync)
        return fm, tm, (0, 1)
    if kind == "skeleton":
        return (JMT.SkelModalityModel(skeleton_output_dim=dims.skeleton_output_dim),
                TMT.SkelModalityModel(dims.skeleton_input_dim, dims.skeleton_output_dim), (0,))
    return (JMT.SensorModalityModel(sensor_out_channels=dims.sensor_out_channels,
                                    sensor_length=dims.sensor_length,
                                    pose_length=dims.pose_length),
            TMT.SensorModalityModel(dims.sensor_in_channels, dims.sensor_out_channels,
                                    dims.sensor_length, pose_length=dims.pose_length), (1,))


CASES = [("multimodal", sync, norm) for sync in (False, True) for norm in (False, True)]
CASES += [("skeleton", False, True), ("sensor", False, True)]


def _case_id(c):
    kind, sync, norm = c
    if kind != "multimodal":
        return kind
    return f"multimodal-{'sync' if sync else 'async'}-{'normcos' if norm else 'plain'}"


@pytest.mark.parametrize("dataset", ["fbg", "fog"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_forward_and_gradients_match_gaitpd(dataset, case):
    kind, sync, norm = case
    dims = FBG_FOG_DIMS[dataset]
    fm, tm, which = _models(kind, dims, sync, norm)
    xs = [_inputs(dims, 0)[i] for i in which]
    params = fm.init(jax.random.PRNGKey(1), *map(jnp.asarray, xs))
    load_flax_params(tm, params)
    coef = np.random.default_rng(2).normal(size=(2, BATCH, dims.num_classes)).astype(np.float32)

    def j_objective(p):
        out = fm.apply(p, *map(jnp.asarray, xs))
        out = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o * coef[i]) for i, o in enumerate(out)), out

    (_, j_out), j_grads = jax.value_and_grad(j_objective, has_aux=True)(params)
    t_out = tm(*map(torch.from_numpy, xs))
    t_out = t_out if isinstance(t_out, tuple) else (t_out,)
    assert len(t_out) == len(j_out) == (2 if kind == "multimodal" else 1)
    for t, j in zip(t_out, j_out):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=LOGIT_TOL)
    objective = sum((o * torch.from_numpy(coef[i])).sum() for i, o in enumerate(t_out))
    grads = torch.autograd.grad(objective, list(tm.parameters()))
    t_grads = export_flax_params(tm, dict(zip([n for n, _ in tm.named_parameters()], grads)))
    want = flatten_dict(j_grads)
    got = flatten_dict(t_grads)
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key], w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * max(1.0, float(np.abs(w).max())),
                                   err_msg="/".join(key))


@pytest.mark.parametrize("dataset", ["fbg", "fog"])
@pytest.mark.parametrize("sync", [False, True], ids=["async", "sync"])
def test_partition_matches_module_mask(dataset, sync):
    dims = FBG_FOG_DIMS[dataset]
    fm, tm, _ = _models("multimodal", dims, sync, False)
    params = fm.init(jax.random.PRNGKey(0), *map(jnp.asarray, _inputs(dims, 0)))
    bound = fm.bind(params)
    assert tm.shared_modules == bound.shared_modules
    assert tm.task_modules == bound.task_modules
    load_flax_params(tm, params)
    part = build_flat_partition(tm, tm.shared_modules, tm.task_modules)
    shared = export_flax_params(tm, {n: part.shared[s].reshape(p.shape).float()
                                     for (n, p), s in zip(tm.named_parameters(),
                                                          _slices(tm))})
    task = export_flax_params(tm, {n: part.task_id[s].reshape(p.shape).float()
                                   for (n, p), s in zip(tm.named_parameters(), _slices(tm))})
    j_shared = flatten_dict(JMT.module_mask(params, bound.shared_modules))
    for key, leaf in flatten_dict(shared).items():
        assert bool(np.all(leaf == 1.0)) == j_shared[key], key
        assert np.all(leaf == leaf.flat[0]), key
    for t, group in enumerate(bound.task_modules):
        mask = flatten_dict(JMT.module_mask(params, group))
        for key, leaf in flatten_dict(task).items():
            assert bool(np.all(leaf == t)) == mask[key], (t, key)


def _slices(module):
    out, start = [], 0
    for _, p in module.named_parameters():
        out.append(slice(start, start + p.numel()))
        start += p.numel()
    return out


def test_both_streams_share_one_backbone_launch(monkeypatch):
    """The multimodal forward calls the backbone once, on both streams'
    windows, and gives what two calls give."""
    dims = FBG_FOG_DIMS["fog"]
    model = TMT.MultiModalMultiTask(
        dims.skeleton_input_dim, dims.skeleton_output_dim, dims.sensor_in_channels,
        dims.sensor_out_channels, dims.sensor_length,
        generator=torch.Generator().manual_seed(0))
    skel, sens = map(torch.from_numpy, _inputs(dims, 3))
    calls = []
    orig = type(model.backbone).forward

    def counted(self, x):
        calls.append(x.shape[0])
        return orig(self, x)

    monkeypatch.setattr(type(model.backbone), "forward", counted)
    with torch.no_grad():
        got = model(skel, sens)
        assert calls == [2 * BATCH]
        rs = TB.flatten_features(model.backbone(model.skeleton_encoder(skel)))
        rn = TB.flatten_features(model.backbone(model.sensor_encoder(sens)))
    torch.testing.assert_close(got[0], model.task_head_skel(rs), rtol=0, atol=1e-6)
    torch.testing.assert_close(got[1], model.task_head_sensor(rn), rtol=0, atol=1e-6)


def test_flatten_skel():
    x = torch.arange(2 * 3 * 7 * 3, dtype=torch.float32).reshape(2, 3, 7, 3)
    np.testing.assert_array_equal(TB.flatten_skel(x).numpy(),
                                  x.numpy().reshape(2, 3, 21))
    flat = torch.zeros(2, 3, 21)
    assert TB.flatten_skel(flat) is flat


def test_backbone_widths_must_agree():
    with pytest.raises(ValueError, match="one width"):
        TMT.MultiModalMultiTask(21, 6, 6, 5, 426)

