"""gaitpd_torch.data.augment and the step's modality dropout against
gaitpd.data.augment.augment_stream and gaitpd.train.step on the CPU: the
sensor streams' and (further down) the skeleton streams' apply steps on
gaitpd's own draws, the sample-level transforms and augment_reader.

The port draws from a torch.Generator, gaitpd from JAX keys, so the apply
steps are held on gaitpd's own draws: ``augment_stream`` splits its key in
5 and draws the gate on ``k_axp`` (``bernoulli``, which is ``uniform < p``),
the channel on ``k_ax`` (``randint``) and the noise on ``k_noise``
(``normal``); those numbers go into the port's ``apply_augment``. The
results are bitwise equal: the channel mask multiplies by exactly 1 or 0
(NaN stays NaN) and both add ``noise_std * noise`` to x in f32, one
multiply then one add. Modality dropout is held on gaitpd's keep/forced
draws, taken from gaitpd's own loss function. The draws' laws are held on
the CPU generator (gaitpd_torch.tools.recipe_laws, the checks phase 5g of
chip_smoke.py makes on the card).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaitpd.data import augment as JA  # noqa: E402
from gaitpd.train import step as JS  # noqa: E402
from gaitpd_torch.data import augment as TA  # noqa: E402
from gaitpd_torch.learning import mtl as TM  # noqa: E402
from gaitpd_torch.models.multitask import WearGaitThreeModal  # noqa: E402
from gaitpd_torch.tools import recipe_laws  # noqa: E402
from gaitpd_torch.train import optim as TO  # noqa: E402
from gaitpd_torch.train import step as TS  # noqa: E402

SPECS = {
    "noise": dict(noise=True),
    "axis_mask": dict(axis_mask=True),
    "both": dict(noise=True, axis_mask=True),
}


def _stream(seed, b=16, t=8, c=13):
    x = np.random.default_rng(seed).normal(size=(b, t, c)).astype(np.float32)
    x[1, 2, c - 1] = np.nan  # a NaN stays NaN under the channel mask
    return x


def _gaitpd_draws(key, x, p):
    """The numbers gaitpd's augment_stream draws from ``key``."""
    b, c = x.shape[0], x.shape[-1]
    _, _, k_noise, k_ax, k_axp = jax.random.split(key, 5)
    gate_u = jax.random.uniform(k_axp, (b,), jnp.float32)
    # bernoulli(k_axp, p) is exactly uniform(k_axp) < p
    np.testing.assert_array_equal(np.asarray(gate_u < p["axis_p"]),
                                  np.asarray(jax.random.bernoulli(k_axp, p["axis_p"], (b,))))
    return {
        "gate_u": torch.tensor(np.asarray(gate_u)),
        "channel": torch.tensor(np.asarray(jax.random.randint(k_ax, (b,), 0, c))).long(),
        "noise": torch.tensor(np.asarray(jax.random.normal(k_noise, x.shape, jnp.float32))),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("c", [2, 13, 24])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_apply_matches_gaitpd_on_its_draws(spec, c, seed):
    x = _stream(seed, c=c)
    key = jax.random.PRNGKey(seed)
    jp = JA.make_aug_params(noise_std=0.3, axis_p=0.5)
    want = np.asarray(JA.augment_stream(jnp.asarray(x), key, JA.AugmentSpec(**SPECS[spec]), jp))
    got = TA.apply_augment(torch.from_numpy(x), TA.AugmentSpec(**SPECS[spec]),
                           TA.make_aug_params(noise_std=0.3, axis_p=0.5),
                           _gaitpd_draws(key, x, jp)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)  # NaN at the same entries
    if "axis_mask" in SPECS[spec]:  # some samples gated, some not
        gate = np.asarray(jax.random.bernoulli(jax.random.split(key, 5)[4], 0.5, (16,)))
        assert 0 < gate.sum() < len(gate)


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_zero_strengths_are_the_identity(spec):
    x = torch.from_numpy(_stream(5))
    got = TA.augment_stream(x, torch.Generator().manual_seed(0), TA.AugmentSpec(**SPECS[spec]),
                            TA.make_aug_params())
    np.testing.assert_array_equal(got.numpy(), x.numpy())


def test_augmentation_keeps_the_dtype():
    x = torch.from_numpy(_stream(3)).to(torch.bfloat16)
    got = TA.augment_stream(x, torch.Generator().manual_seed(0), TA.AugmentSpec(**SPECS["both"]),
                            TA.make_aug_params(noise_std=0.1, axis_p=0.5))
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize("spec", [dict(joints=7), dict(mirror=True), dict(rotation=True)])
def test_skeleton_transforms_raise(spec):
    """A skeleton spec on a stream whose width is not three times its
    joints, and mirror or rotation without a joint count, raise."""
    with pytest.raises(ValueError, match="joint"):
        TA.augment_stream(torch.zeros(2, 4, 20), torch.Generator(), TA.AugmentSpec(**spec),
                          TA.make_aug_params())


def _gaitpd_skeleton_draws(key, x, p):
    """The numbers gaitpd's augment_stream draws from ``key`` for a
    skeleton stream: the mirror gate on k_mir, the rotation's axis, main and
    rest angles on k_rot's three splits, the coordinate axis on k_ax."""
    b = x.shape[0]
    k_mir, k_rot, k_noise, k_ax, k_axp = jax.random.split(key, 5)
    k_axis, k_main, k_rest = jax.random.split(k_rot, 3)
    mirror_u = jax.random.uniform(k_mir, (b,), jnp.float32)
    np.testing.assert_array_equal(np.asarray(mirror_u < p["mirror_p"]),
                                  np.asarray(jax.random.bernoulli(k_mir, p["mirror_p"], (b,))))

    def t(a):
        return torch.tensor(np.asarray(a))

    return {
        "mirror_u": t(mirror_u),
        "rot_axis": t(jax.random.randint(k_axis, (b,), 0, 3)).long(),
        "rot_main_u": t(jax.random.uniform(k_main, (b,), jnp.float32)),
        "rot_rest_u": t(jax.random.uniform(k_rest, (b, 3), jnp.float32)),
        "gate_u": t(jax.random.uniform(k_axp, (b,), jnp.float32)),
        "channel": t(jax.random.randint(k_ax, (b,), 0, 3)).long(),
        "noise": t(jax.random.normal(k_noise, x.shape, jnp.float32)),
    }


SKELETON_SPECS = {
    "mirror": dict(mirror=True),
    "axis_mask": dict(axis_mask=True),
    "mirror_mask_noise": dict(mirror=True, axis_mask=True, noise=True),
    "rotation": dict(rotation=True),
    "all": dict(mirror=True, rotation=True, axis_mask=True, noise=True),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("joints", [7, 17])
@pytest.mark.parametrize("spec", sorted(SKELETON_SPECS))
def test_skeleton_apply_matches_gaitpd_on_its_draws(spec, joints, seed):
    """The skeleton branch of augment_stream on gaitpd's draws. Mirror,
    the coordinate-axis mask and the noise are bitwise equal. With the
    rotation the result is within 2 ulps of the stream's largest value:
    the rotation angles are equal (the port rounds jax.random.uniform's
    fused multiply-add once, as XLA does), but XLA's sin and cos differ
    from PyTorch's by an ulp, and the 3-term products of the rotation sum
    in another order."""
    x = np.random.default_rng(seed).normal(size=(64, 9, 3 * joints)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    strengths = dict(mirror_p=0.5, rot_deg=15.0, noise_std=0.1, axis_p=0.5)
    jp = JA.make_aug_params(**strengths)
    want = np.asarray(JA.augment_stream(jnp.asarray(x), key,
                                        JA.AugmentSpec(joints=joints, **SKELETON_SPECS[spec]), jp))
    got = TA.apply_augment(torch.from_numpy(x), TA.AugmentSpec(joints=joints,
                                                               **SKELETON_SPECS[spec]),
                           TA.make_aug_params(**strengths),
                           _gaitpd_skeleton_draws(key, x, jp)).numpy()
    assert got.dtype == np.float32
    if "rotation" in SKELETON_SPECS[spec]:
        ulp = np.spacing(np.float32(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * ulp)
        assert not np.array_equal(want, x)
    else:
        np.testing.assert_array_equal(got, want)


def test_skeleton_draws_come_in_the_documented_order():
    x = torch.zeros(5, 3, 21)
    spec = TA.AugmentSpec(joints=7, mirror=True, rotation=True, axis_mask=True, noise=True)
    draws = TA.draw_augment(x, spec, torch.Generator().manual_seed(0))
    assert list(draws) == ["mirror_u", "rot_axis", "rot_main_u", "rot_rest_u", "gate_u",
                           "channel", "noise"]
    g = torch.Generator().manual_seed(0)
    assert torch.equal(draws["mirror_u"], torch.rand((5,), generator=g))
    assert int(draws["channel"].max()) < 3  # a coordinate axis, not one of 21 channels


def test_mirror_and_rotation_on_pose_stacks():
    """gaitpd's sample-level mirror (H36M pairs swapped at 17 joints, the
    flip alone at 7) exactly; a random rotation keeps each point's norm and
    stays the identity at 0 degrees."""
    rng = np.random.default_rng(0)
    for j in (7, 17):
        x = rng.normal(size=(4, 6, j, 3)).astype(np.float32)
        np.testing.assert_array_equal(TA.mirror_reflection(torch.from_numpy(x)).numpy(),
                                      np.asarray(JA.mirror_reflection(jnp.asarray(x))))
    x = torch.from_numpy(rng.normal(size=(8, 5, 17, 3)).astype(np.float32))
    rot = TA.random_rotation(x, torch.Generator().manual_seed(1), -30.0, 30.0)
    torch.testing.assert_close(rot.norm(dim=-1), x.norm(dim=-1), rtol=1e-5, atol=1e-6)
    assert not torch.allclose(rot, x)
    same = TA.random_rotation(x, torch.Generator().manual_seed(1), 0.0, 0.0)
    np.testing.assert_array_equal(same.numpy(), x.numpy())
    ang = rng.uniform(-20, 20, size=(6, 3)).astype(np.float32)
    want = np.asarray(jax.vmap(JA.rotation_matrix_3d)(jnp.asarray(ang)))
    np.testing.assert_allclose(TA.rotation_matrix_3d(torch.from_numpy(ang)).numpy(), want,
                               rtol=0, atol=2e-7)


def test_augment_reader():
    """augment_reader adds one copy a sequence and augmentation, labelled as
    its source: the mirror equal to gaitpd's, joint dropout zeroing whole
    joints, the translation one shift a coordinate within the estimated
    range, the rotation keeping norms; the source reader is not changed."""
    from gaitpd.data import synthetic as JSYN
    from gaitpd_torch.data import synthetic as TSYN

    augs = ["mirror_reflection", "joint_dropout", "random_rotation", "random_translation",
            "unknown"]
    params = {"dropout_prob": 0.5, "translation_frac": 0.2}
    for name in ("make_fog_reader", "make_fbg_reader"):
        t_reader = getattr(TSYN, name)(n_subjects=3, segments=1, seed=0) if "fog" in name \
            else getattr(TSYN, name)(n_subjects=3, walks=1, seed=0)
        j_reader = getattr(JSYN, name)(n_subjects=3, segments=1, seed=0) if "fog" in name \
            else getattr(JSYN, name)(n_subjects=3, walks=1, seed=0)
        got = TA.augment_reader(t_reader, augs, params, seed=0)
        want = JA.augment_reader(j_reader, augs, params, seed=0)
        assert sorted(got.pose_dict) == sorted(want.pose_dict)
        labels = "labels_dict" if "fog" in name else "pose_label_dict"
        assert getattr(got, labels) == getattr(want, labels)
        assert len(got.pose_dict) == 5 * len(t_reader.pose_dict)
        lo, hi = TA.estimate_translation_range(t_reader.pose_dict, 0.2)
        assert (lo, hi) == JA.estimate_translation_range(j_reader.pose_dict, 0.2)
        for key, src in t_reader.pose_dict.items():
            src = np.asarray(src, np.float32)  # the augmented copies are f32
            np.testing.assert_array_equal(got.pose_dict[f"{key}_mirror_reflection"],
                                          want.pose_dict[f"{key}_mirror_reflection"])
            drop = got.pose_dict[f"{key}_joint_dropout"]
            zeroed = (drop == 0).all(axis=(0, 2))
            np.testing.assert_array_equal(drop[:, ~zeroed], src[:, ~zeroed])
            shift = got.pose_dict[f"{key}_random_translation"] - src
            assert np.allclose(shift, shift[0, 0], atol=1e-5) and np.all(np.abs(shift) <= hi)
            np.testing.assert_allclose(
                np.linalg.norm(got.pose_dict[f"{key}_random_rotation"], axis=-1),
                np.linalg.norm(src, axis=-1), rtol=1e-5)
        assert len(t_reader.pose_dict) * 5 == len(got.pose_dict)
        assert all("_" in k for k in got.pose_dict) and t_reader.pose_dict is not got.pose_dict


def _gaitpd_dropped(xs, p, seed):
    """gaitpd's modality dropout through its own loss function (the forward
    records its inputs) and the keep/forced it drew."""
    settings = JS.StepSettings(n_streams=3, wm="ce", modality_dropout=p)
    seen = {}

    def train_apply(params, xs_in, rng, epoch):
        seen["xs"] = xs_in
        return tuple(jnp.zeros((x.shape[0], 2)) for x in xs_in)

    loss_fn = JS.make_multitask_loss_fn(train_apply, settings)
    rng = jax.random.PRNGKey(seed)
    b = xs[0].shape[0]
    ys = tuple(jnp.zeros(b, jnp.int32) for _ in range(3))
    loss_fn(None, tuple(map(jnp.asarray, xs)), ys, jnp.ones(b), JS.make_loss_ctx(
        settings, [[3, 2]] * 3), rng, jnp.asarray(0))
    k_drop, k_force = jax.random.split(jax.random.fold_in(rng, 555))
    keep = np.asarray(jax.random.bernoulli(k_drop, 1.0 - p, (3,)))
    forced = int(jax.random.randint(k_force, (), 0, 3))
    return [np.asarray(x) for x in seen["xs"]], keep, forced


def test_modality_dropout_matches_gaitpd_on_its_draws():
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(4, 8, c)).astype(np.float32) for c in (2, 13, 24)]
    all_dropped = 0
    for seed in range(24):
        want, keep, forced = _gaitpd_dropped(xs, 0.7, seed)
        all_dropped += not keep.any()
        got = TS.modality_dropout(tuple(map(torch.from_numpy, xs)), torch.from_numpy(keep),
                                  torch.tensor(forced))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    assert all_dropped > 0  # the forced stream's case was reached


def test_draws_keep_their_laws_on_the_cpu():
    recipe_laws.check_augment_laws("cpu", t=2)
    recipe_laws.check_modality_dropout_law("cpu")


def _cagrad_step_params(settings, aug_params):
    model = WearGaitThreeModal(synchronized=True, generator=torch.Generator().manual_seed(0))
    mtl = TM.make_method("cagrad", 3, c=0.5)
    step = TS.make_train_step(settings, mtl, TM.build_flat_partition(
        model, model.shared_modules, model.task_modules))
    state = TS.TrainState(module=model, optimizer=TO.sgd_torch(model.parameters(), 1e-3),
                          mtl_state=mtl.init_state())
    g = torch.Generator().manual_seed(1)
    batch = {"xs": tuple(torch.randn((6, 64, c), generator=g) for c in (2, 13, 24)),
             "ys": tuple(torch.randint(0, 2, (6,), generator=g) for _ in range(3)),
             "valid": torch.ones(6), "n_valid": 6}
    ctx = TS.make_loss_ctx(settings, [[30, 20]] * 3, aug_params=aug_params)
    step(state, batch, torch.Generator().manual_seed(2), ctx)
    return [p.detach().clone() for p in model.parameters()]


def test_zero_strength_step_equals_the_plain_step():
    """A CAGrad step with augmentation at strength 0 leaves the parameters
    a step without augmentation leaves."""
    base = dict(n_streams=3, wm="gcl", synchronized=True, private_grads="sum_plus_own")
    plain = _cagrad_step_params(TS.StepSettings(**base), None)
    spec = TA.AugmentSpec(noise=True, axis_mask=True)
    zero = _cagrad_step_params(TS.StepSettings(**base, augment=(spec,) * 3),
                               [TA.make_aug_params()] * 3)
    for a, b in zip(zero, plain):
        assert torch.equal(a, b)


def test_axis_mask_and_random_noise():
    """gaitpd's sample-level transforms: axis_mask zeroes one last-axis entry
    of each sample, everywhere in it; random_noise at std 0 adds the mean."""
    x = torch.ones(64, 5, 7, 3)
    masked = TA.axis_mask(x, torch.Generator().manual_seed(0))
    zeroed = (masked == 0).all(dim=(1, 2))  # (N, C)
    assert torch.equal(zeroed.sum(1), torch.ones(64, dtype=torch.long))
    assert torch.equal(masked, x * ~zeroed[:, None, None, :])
    assert len(set(zeroed.float().argmax(1).tolist())) == 3
    np.testing.assert_array_equal(
        TA.random_noise(x, torch.Generator(), mean=0.25, std=0.0).numpy(), 1.25)
    noisy = TA.random_noise(torch.zeros(4000), torch.Generator().manual_seed(1), std=0.5)
    assert abs(float(noisy.std()) - 0.5) < 5 * 0.5 / np.sqrt(2 * 4000)
