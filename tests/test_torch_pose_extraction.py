"""gaitpd_torch.data.pose_extraction against gaitpd.data.pose_extraction,
in process, on the same video folder and the same stub inferencer
(tests/test_augment.py's case): the same unfinished list, the same JSON
files and contents, the same worker logs (the PID line aside); a video whose
inference raises is logged and the others go on. mmpose is not installed:
``default_infer_fn`` imports it when called."""

import importlib
import json
import os

import pytest

MODULES = ("gaitpd.data.pose_extraction", "gaitpd_torch.data.pose_extraction")


def _folder(root):
    videos, preds = root / "vids", root / "preds"
    videos.mkdir(parents=True)
    preds.mkdir()
    for n in ("a.mp4", "b.mp4", "c.avi", "d.MKV", "notes.txt"):
        (videos / n).write_text("")
    (preds / "b_3d_predictions.json").write_text("[]")  # b is done
    return videos, preds


def _stub(fail_on=None):
    def builder():
        def infer(path):
            if fail_on and os.path.basename(path) == fail_on:
                raise RuntimeError("decoder failed")
            return [{"video": os.path.basename(path), "predictions": [[0.5, 1.0]]}]
        return infer
    return builder


def _run(module_name, root, fail_on=None):
    mod = importlib.import_module(module_name)
    videos, preds = _folder(root)
    unfinished = mod.check_unfinished_videos(videos, preds)
    n = mod.extract_all(videos, preds, root / "logs", num_workers=2,
                        infer_builder=_stub(fail_on), use_processes=False)
    outputs = {p.name: json.loads(p.read_text()) for p in sorted(preds.iterdir())}
    logs = {p.name: [line for line in p.read_text().splitlines()
                     if not line.startswith("Started. PID:")]
            for p in sorted((root / "logs").iterdir())}
    again = mod.extract_all(videos, preds, root / "logs", num_workers=2,
                            infer_builder=_stub(), use_processes=False)
    return unfinished, n, outputs, logs, again


@pytest.mark.parametrize("fail_on", [None, "c.avi"], ids=["all", "one_fails"])
def test_pose_extraction_matches_gaitpd(tmp_path, fail_on):
    pytest.importorskip("jax")
    want, got = (_run(name, tmp_path / name, fail_on) for name in MODULES)
    assert got[:4] == want[:4]
    unfinished, n, outputs, logs, again = got
    assert sorted(unfinished) == ["a.mp4", "c.avi", "d.MKV"] and n == 3
    assert outputs["a_3d_predictions.json"] == [{"video": "a.mp4",
                                                 "predictions": [[0.5, 1.0]]}]
    lines = [line for worker in logs.values() for line in worker]
    if fail_on is None:
        assert "c_3d_predictions.json" in outputs and again == want[4] == 0
    else:
        assert "c_3d_predictions.json" not in outputs
        assert any(line.startswith("Error processing c.avi: decoder failed") for line in lines)
        assert again == want[4] == 1  # the failed video is still unfinished
    assert any(line.startswith("Finished d:") for line in lines)


def test_default_infer_fn_needs_mmpose():
    from gaitpd_torch.data import pose_extraction as pe

    if importlib.util.find_spec("mmpose") is not None:
        pytest.skip("mmpose is installed")
    with pytest.raises(ImportError):
        pe.default_infer_fn("cpu")

