"""The port's own copies of gaitpd's numpy data code (synthetic streams,
WearGait fold preparation, folds, epoch index matrices) give exactly the
arrays gaitpd gives for the same seeds: the training comparisons of
test_torch_train_driver rest on both packages seeing the same batches."""

import numpy as np
import pytest

pytest.importorskip("jax")

from gaitpd.data import sampler as JSa  # noqa: E402
from gaitpd.data import synthetic as JSy  # noqa: E402
from gaitpd.data import weargait as JW  # noqa: E402
from gaitpd.train import cv as JC  # noqa: E402
from gaitpd_torch.data import sampler as TSa  # noqa: E402
from gaitpd_torch.data import synthetic as TSy  # noqa: E402
from gaitpd_torch.data import weargait as TW  # noqa: E402
from gaitpd_torch.train import cv as TC  # noqa: E402


@pytest.mark.parametrize("tie_free", [False, True])
def test_synthetic_streams_are_identical(tie_free):
    a, pa, ha = JSy.make_weargait_streams(n_pd=4, n_hc=3, seed=5, tie_free=tie_free)
    b, pb, hb = TSy.make_weargait_streams(n_pd=4, n_hc=3, seed=5, tie_free=tie_free)
    assert (pa, ha) == (pb, hb) and set(a) == set(b)
    for sid in a:
        for m in a[sid]:
            np.testing.assert_array_equal(a[sid][m], b[sid][m])  # NaNs in the same places


def test_folds_split_and_pools_are_identical():
    streams, pd_ids, hc_ids = TSy.make_weargait_streams(n_pd=10, n_hc=10, seed=1)
    folds = TC.make_fixed_balanced_folds_no_overlap(pd_ids, hc_ids, n_folds=2, per_class=3,
                                                    seed=1)
    assert folds == JC.make_fixed_balanced_folds_no_overlap(pd_ids, hc_ids, n_folds=2,
                                                            per_class=3, seed=1)
    labels = TC.build_subj2label(pd_ids, hc_ids)
    assert labels == JC.build_subj2label(pd_ids, hc_ids)
    tr, te = folds[0]
    got = TW.prepare_split(streams, tr, te, labels, win=64, hop=32)
    want = JW.prepare_split(streams, tr, te, labels, win=64, hop=32)
    for m in got.stats:
        for g, w in zip(got.stats[m], want.stats[m]):
            np.testing.assert_array_equal(g, w)
    for side in ("train", "test"):
        for m in TW.MODALITIES:
            g, w = getattr(got, side)[m], getattr(want, side)[m]
            np.testing.assert_array_equal(g.x, w.x)
            np.testing.assert_array_equal(g.y, w.y)
            assert g.keys == w.keys
    np.testing.assert_array_equal(got.train_sync, want.train_sync)
    np.testing.assert_array_equal(got.test_sync, want.test_sync)
    np.testing.assert_array_equal(TW.async_pool(got.train, np.random.default_rng(3)),
                                  JW.async_pool(want.train, np.random.default_rng(3)))


@pytest.mark.parametrize("n,b", [(1, 64), (64, 64), (65, 64), (900, 64), (5, 2)])
def test_batch_index_matrix_is_identical(n, b):
    order = np.random.default_rng(n).permutation(n)
    for got, want in zip(TSa.batch_index_matrix(order, b), JSa.batch_index_matrix(order, b)):
        np.testing.assert_array_equal(got, want)
