"""gaitpd_torch.data.preprocess_fbg_raw against gaitpd.data.preprocess_fbg_raw
on the CPU: every function gives exactly gaitpd's result (atol 0) on the
fixtures of tests/test_fbg_raw_oracle.py. The GRF spreadsheets go through
the same CSV-backed pd.ExcelFile/pd.read_excel monkeypatch (no Excel engine
here). The mocap files go through a stand-in for the optional ``c3d``
package, put into both modules, that reads each "c3d" file as a saved numpy
array of frames; without ``c3d`` both modules' read_pd raise the same
ImportError.
"""

import sys

import numpy as np
import pandas as pd
import pytest

pytest.importorskip("jax")

from gaitpd.data import preprocess_fbg_raw as J  # noqa: E402
from gaitpd_torch.data import preprocess_fbg_raw as T  # noqa: E402
from test_fbg_raw_oracle import (  # noqa: E402
    _FakeExcelFile,
    _fake_read_excel,
    _gappy_sequence,
    _grf_fixture_tree,
)


def test_constants_and_convert_pd_h36m_equal_gaitpd():
    assert T.PD_MARKERS == J.PD_MARKERS
    np.testing.assert_array_equal(T.NECK_OFFSET, J.NECK_OFFSET)
    np.testing.assert_array_equal(T.HEAD_OFFSET, J.HEAD_OFFSET)
    seq = np.random.default_rng(0).normal(size=(23, 44, 3)) * 100.0
    got, want = T.convert_pd_h36m(seq.copy()), J.convert_pd_h36m(seq.copy())
    assert got.shape == want.shape == (23, 17, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("zero_frames", [[], [0, 1], [3], [4, 5, 6, 10, 11], list(range(12))])
def test_identify_gaps_equals_gaitpd(zero_frames):
    seq = _gappy_sequence(zero_frames)
    assert T.identify_gaps(seq) == J.identify_gaps(seq)


@pytest.mark.parametrize("name", ["SUB09_on_walk_8.c3d", "SUB10_Off_walk_2", "SUB1_ON_walk_11",
                                  "notes.c3d"])
def test_extract_sort_key_equals_gaitpd(name):
    assert T.extract_sort_key(name) == J.extract_sort_key(name)


def test_load_skip_stems_equals_gaitpd(tmp_path):
    path = tmp_path / "removed.csv"
    path.write_text("./C3Dfiles/SUB09_on/SUB09_on_walk_8.c3d,\n\nSUB10_off_walk_1\n"
                    "./C3Dfiles/SUB09_on/SUB09_on_walk_8.c3d\n")
    assert T.load_skip_stems(path) == J.load_skip_stems(path) == {"SUB09_on_walk_8",
                                                                   "SUB10_off_walk_1"}


def test_extract_grf_data_equals_gaitpd(tmp_path, monkeypatch):
    grf_root = tmp_path / "Gait cycle"
    grf_root.mkdir()
    _grf_fixture_tree(grf_root)
    monkeypatch.setattr(pd, "ExcelFile", _FakeExcelFile)
    monkeypatch.setattr(pd, "read_excel", _fake_read_excel)
    J.extract_grf_data(str(grf_root), str(tmp_path / "jax"))
    T.extract_grf_data(str(grf_root), str(tmp_path / "port"))
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.npy"))
    assert names == sorted(p.name for p in (tmp_path / "port").glob("*.npy"))
    assert "SUB01_off_right.npy" in names
    for name in names:
        want, got = np.load(tmp_path / "jax" / name), np.load(tmp_path / "port" / name)
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_read_pd_needs_c3d(monkeypatch):
    for mod in (J, T):
        monkeypatch.setattr(mod, "c3d", None)
        with pytest.raises(ImportError, match="c3d is required"):
            mod.read_pd("SUB01_on_walk_1.c3d")


class _FakeC3D:
    """``c3d`` for the tests: Reader(fh) reads a saved (frames, markers, 5)
    array, as c3d's points rows (x, y, z, residual, cameras)."""

    class Reader:
        def __init__(self, fh):
            self.frames = np.load(fh)
            fh.close()
            self.frame_count = len(self.frames)

        def read_frames(self):
            for i, points in enumerate(self.frames):
                yield i, points, None


def _c3d_tree(root):
    """SUB*_walk_*.c3d files of 46 markers: clean, gappy (zero markers in
    some frames), all corrupted (removed), one unreadable, and files the
    walk skips (no "walk", not SUB*)."""
    rng = np.random.default_rng(3)
    files = {"SUB02_on/SUB02_on_walk_2.c3d": [], "SUB02_on/SUB02_on_walk_10.c3d": [4, 5, 9],
             "SUB01_off/SUB01_off_walk_1.c3d": [0, 1, 2, 13],
             "SUB01_on/SUB01_on_walk_3.c3d": list(range(14)),
             "SUB01_on/SUB01_on_walk_1.c3d": [7]}
    for rel, zero in files.items():
        frames = rng.normal(size=(14, 46, 5)) * 100.0
        for f in zero:
            frames[f, f % 44, :3] = 0.0
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as fh:
            np.save(fh, frames)
    (root / "SUB01_on" / "SUB01_on_walk_4.c3d").write_bytes(b"not a recording")
    (root / "SUB01_on" / "SUB01_on_static.c3d").write_bytes(b"skipped")
    (root / "SUB01_on" / "calib_walk_1.c3d").write_bytes(b"skipped")


def test_process_c3d_tree_and_main_equal_gaitpd(tmp_path, monkeypatch, capsys):
    for mod in (J, T):
        monkeypatch.setattr(mod, "c3d", _FakeC3D)
    tree = tmp_path / "data" / "C3Dfiles"
    _c3d_tree(tree)
    skip = tmp_path / "skip.csv"
    skip.write_text("./C3Dfiles/SUB02_on/SUB02_on_walk_2.c3d\n")
    rows = {}
    for name, mod in (("jax", J), ("port", T)):
        rows[name] = mod.process_c3d_tree(tree, tmp_path / name, skip_manifest=skip,
                                          removed_manifest_out=tmp_path / f"{name}.removed")
    assert rows["port"] == rows["jax"]
    assert [r["file names"] for r in rows["port"]] == [
        "SUB01_on_walk_1", "SUB01_on_walk_3", "SUB01_off_walk_1", "SUB02_on_walk_10"]
    assert (tmp_path / "port.removed").read_text() == (tmp_path / "jax.removed").read_text()
    saved = sorted(p.name for p in (tmp_path / "jax").glob("*.npy"))
    assert saved == sorted(p.name for p in (tmp_path / "port").glob("*.npy"))
    for name in saved:
        np.testing.assert_array_equal(np.load(tmp_path / "port" / name),
                                      np.load(tmp_path / "jax" / name), err_msg=name)

    # main: the same tree through the command line, GRF sheets included
    monkeypatch.setattr(pd, "ExcelFile", _FakeExcelFile)
    monkeypatch.setattr(pd, "read_excel", _fake_read_excel)
    (tmp_path / "data" / "Gait cycle").mkdir()
    _grf_fixture_tree(tmp_path / "data" / "Gait cycle")
    outputs = {}
    for name, mod in (("jax", J), ("port", T)):
        monkeypatch.setattr(sys, "argv", ["preprocess_fbg_raw", "--input_path",
                                          str(tmp_path / "data"), "--grf"])
        mod.main()
        out = {}
        for sub in ("C3Dfiles_cleaned_sequences", "GRF_processed"):
            for path in sorted((tmp_path / "data" / sub).glob("*.npy")):
                out[(sub, path.name)] = np.load(path)
                path.unlink()
        outputs[name] = out
    assert outputs["port"].keys() == outputs["jax"].keys() and outputs["port"]
    for key, want in outputs["jax"].items():
        np.testing.assert_array_equal(outputs["port"][key], want, err_msg=str(key))
    printed = capsys.readouterr().out
    assert printed.count("[GRF] Saved") == 2 * 8
