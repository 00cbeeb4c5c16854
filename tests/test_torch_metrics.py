"""gaitpd_torch.train.metrics, numpy alone, against sklearn and gaitpd on
the CPU: the classification report string (digits 2, zero_division 0, with
and without target names), the confusion matrix and the macro F1 equal to
sklearn's on seeded labels, among them classes absent from the predictions,
from the labels, or right nowhere; the accuracies and the ensemble equal to
gaitpd's; print_report runs with sklearn blocked.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sk = pytest.importorskip("sklearn.metrics")

from gaitpd.train import metrics as JM  # noqa: E402
from gaitpd_torch.train import metrics as TM  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _labels(seed):
    """(trues, preds) of seeded sizes and class counts; every third seed a
    class the predictions never take, every fifth one they take that no
    label has, every seventh nothing right."""
    rng = np.random.default_rng(seed)
    n, k = int(rng.integers(1, 80)), int(rng.integers(1, 6))
    trues = rng.integers(0, k, n)
    preds = rng.integers(0, k, n)
    if seed % 3 == 0:
        preds = np.where(preds == 0, min(1, k - 1), preds)
    if seed % 5 == 0:
        preds = np.where(rng.uniform(size=n) < 0.2, k, preds)
    if seed % 7 == 0:
        preds = (trues + 1) % (k + 1)
    return trues, preds


@pytest.mark.parametrize("named", [False, True], ids=["labels", "target_names"])
@pytest.mark.parametrize("block", range(4))
def test_report_matrix_and_f1_equal_sklearn(block, named):
    for seed in range(block * 50, block * 50 + 50):
        trues, preds = _labels(seed)
        names = None
        if named:
            names = [f"stage_{c}" for c in np.unique(np.concatenate([trues, preds]))]
        want = sk.classification_report(trues, preds, digits=2, zero_division=0,
                                        target_names=names)
        assert TM.classification_report_str(trues, preds, names) == want, seed
        np.testing.assert_array_equal(TM.confusion_matrix_arr(trues, preds),
                                      sk.confusion_matrix(trues, preds), err_msg=str(seed))
        assert TM.macro_f1(trues, preds) == sk.f1_score(trues, preds, average="macro",
                                                        zero_division=0), seed


def test_report_rejects_wrong_target_names():
    with pytest.raises(ValueError, match="target_names"):
        TM.classification_report_str([0, 1, 2], [0, 1, 1], ["a", "b"])


def test_accuracies_and_ensemble_equal_gaitpd():
    rng = np.random.default_rng(0)
    logits = [rng.normal(size=(40, 4)).astype(np.float32) for _ in range(2)]
    labels = rng.integers(0, 4, 40)
    preds = logits[0].argmax(1)
    assert TM.accuracy(preds, labels) == JM.accuracy(preds, labels)
    assert TM.accuracy(preds[:0], labels[:0]) == 0.0
    assert TM.topk_accuracy(logits[0], labels, (1, 2, 3)) == JM.topk_accuracy(
        logits[0], labels, (1, 2, 3))
    np.testing.assert_array_equal(TM.ensemble_probs(logits), JM.ensemble_probs(logits))
    module = torch.nn.Linear(5, 3)
    assert TM.count_params(module) == 18


def test_prints_without_sklearn(capsys):
    counts = [np.array([5, 3, 2]), np.array([4, 4, 2])]
    TM.print_class_balance(counts, 3)
    got = capsys.readouterr().out
    JM.print_class_balance(counts, 3)
    assert got == capsys.readouterr().out and "[EVAL] class balance" in got
    code = ("import sys\n"
            "for m in ('sklearn', 'sklearn.metrics'):\n"
            "    sys.modules[m] = None\n"
            "from gaitpd_torch.train import metrics as M\n"
            "M.print_report([0, 1, 2, 2], [0, 2, 2, 1], 'Best Skeleton')\n"
            "M.print_report([], [], 'Empty')\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert "Best Skeleton Report:" in done.stdout and "Empty: (no samples)" in done.stdout
    assert sk.classification_report([0, 1, 2, 2], [0, 2, 2, 1], digits=2,
                                    zero_division=0) in done.stdout
