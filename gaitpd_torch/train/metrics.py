"""Host-side metrics: accuracies, classification reports, confusion matrices.
The port's own copy of gaitpd/train/metrics.py (reference
train/learning/training_common.py:106-206), on numpy alone.

gaitpd prints its reports with sklearn; the card's machine has no sklearn,
so ``classification_report_str``, ``confusion_matrix_arr`` and ``macro_f1``
compute what sklearn's ``classification_report(digits=2,
zero_division=0)``, ``confusion_matrix`` and ``f1_score(average="macro",
zero_division=0)`` give, the report to the same string: the labels are the
sorted union of the true and predicted ones, a score whose denominator is 0
is 0, the F1 is 2·tp / (true + predicted), and the averages are numpy's
means, the weighted one by support. ``save_loss_curve`` imports matplotlib
when it is called.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


def accuracy(preds: np.ndarray, labels: np.ndarray) -> float:
    """Percent of ``preds`` equal to ``labels``; 0 for no samples."""
    if len(labels) == 0:
        return 0.0
    return float((np.asarray(preds) == np.asarray(labels)).mean() * 100.0)


def ensemble_probs(logits_list: Sequence[np.ndarray]) -> np.ndarray:
    """Softmax-mean ensembling (reference training_common.py:136-143)."""
    probs = []
    for lg in logits_list:
        e = np.exp(lg - lg.max(axis=1, keepdims=True))
        probs.append(e / e.sum(axis=1, keepdims=True))
    return np.mean(probs, axis=0)


def topk_accuracy(logits: np.ndarray, labels: np.ndarray, topk=(1,)) -> List[float]:
    """reference training_common.py:153-163."""
    order = np.argsort(-logits, axis=1)
    out = []
    for k in topk:
        hit = (order[:, :k] == labels[:, None]).any(axis=1)
        out.append(float(hit.mean() * 100.0))
    return out


def _labels(trues, preds) -> np.ndarray:
    return np.unique(np.concatenate([np.asarray(trues).ravel(), np.asarray(preds).ravel()]))


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den, 0 where den is 0 (zero_division=0)."""
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    out = np.zeros_like(num)
    np.divide(num, den, out=out, where=den != 0)
    return out


def _counts(trues, preds, labels) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(true positives, predicted, true) counts a label. Where nothing is
    right, sklearn's counts are floats (its zeros, multilabel_confusion_matrix),
    which the report prints as "1.0"; so are these."""
    t, p = np.asarray(trues).ravel(), np.asarray(preds).ravel()
    tp = np.array([np.sum((t == lab) & (p == lab)) for lab in labels], np.int64)
    pred = np.array([np.sum(p == lab) for lab in labels], np.int64)
    true = np.array([np.sum(t == lab) for lab in labels], np.int64)
    if tp.sum() == 0:
        return tp.astype(np.float64), pred.astype(np.float64), true.astype(np.float64)
    return tp, pred, true


def _prf(tp, pred, true):
    """Per-label precision, recall and F1 (sklearn's order of operations)."""
    precision = _divide(tp, pred)
    recall = _divide(tp, true)
    f1 = _divide(2.0 * tp.astype(np.float64), 1.0 * true.astype(np.float64)
                 + pred.astype(np.float64))
    return precision, recall, f1


def classification_report_str(trues, preds, label_names=None, digits: int = 2) -> str:
    """sklearn's ``classification_report(trues, preds, digits=2,
    zero_division=0, target_names=label_names)`` as a string."""
    labels = _labels(trues, preds)
    names = list(label_names) if label_names is not None else ["%s" % lab for lab in labels]
    if len(names) != len(labels):
        raise ValueError(f"Number of classes, {len(labels)}, does not match size of "
                         f"target_names, {len(names)}")
    tp, pred, true = _counts(trues, preds, labels)
    p, r, f1 = _prf(tp, pred, true)
    headers = ["precision", "recall", "f1-score", "support"]
    width = max(max(len(n) for n in names), len("weighted avg"), digits)
    head_fmt = "{:>{width}s} " + " {:>9}" * len(headers)
    report = head_fmt.format("", *headers, width=width) + "\n\n"
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    for row in zip(names, p, r, f1, true):
        report += row_fmt.format(*row, width=width, digits=digits)
    report += "\n"
    support = np.sum(true)
    # micro average: accuracy for single-label classification
    acc_f1 = float(_divide(2.0 * np.sum(tp), 1.0 * np.sum(true) + np.sum(pred)))
    acc_fmt = "{:>{width}s} " + " {:>9.{digits}}" * 2 + " {:>9.{digits}f}" + " {:>9}\n"
    report += acc_fmt.format("accuracy", "", "", acc_f1, support, width=width, digits=digits)
    macro = [float(np.mean(v)) for v in (p, r, f1)]
    report += row_fmt.format("macro avg", *macro, support, width=width, digits=digits)
    weights = true if np.sum(true) > 0 else None
    weighted = [float(np.average(v, weights=weights)) for v in (p, r, f1)]
    report += row_fmt.format("weighted avg", *weighted, support, width=width, digits=digits)
    return report


def confusion_matrix_arr(trues, preds) -> np.ndarray:
    """sklearn's ``confusion_matrix(trues, preds)``: rows true, columns
    predicted, over the sorted union of labels."""
    labels = _labels(trues, preds)
    index = {lab: i for i, lab in enumerate(labels.tolist())}
    out = np.zeros((len(labels), len(labels)), np.int64)
    for t, p in zip(np.asarray(trues).ravel().tolist(), np.asarray(preds).ravel().tolist()):
        out[index[t], index[p]] += 1
    return out


def print_report(trues, preds, name: str, label_names=None):
    """reference training_common.py:186-196."""
    trues = list(trues) if trues is not None else []
    preds = list(preds) if preds is not None else []
    if not trues or not preds:
        print(f"\n{name}: (no samples)")
        return
    print(f"\n{name} Report:")
    print(classification_report_str(trues, preds, label_names))
    print(f"{name} Confusion Matrix:")
    print(confusion_matrix_arr(trues, preds))


def macro_f1(trues, preds) -> float:
    """sklearn's ``f1_score(trues, preds, average="macro", zero_division=0)``."""
    labels = _labels(trues, preds)
    return float(np.mean(_prf(*_counts(trues, preds, labels))[2]))


def count_params(module) -> int:
    """The number of parameter entries of a torch module (reference
    training_common.py:131-133)."""
    return sum(p.numel() for p in module.parameters())


def print_class_balance(counts_per_stream, num_classes: int, tag: str = "EVAL",
                        label_names=None, stream_names=("skel", "sens")):
    """Class-balance table (reference training_common.py:106-128)."""
    names = label_names or [str(i) for i in range(num_classes)]
    totals = [max(1, int(np.sum(c))) for c in counts_per_stream]
    print(f"\n[{tag}] class balance")
    print("class " + "  ".join(f"{s}_cnt  {s}_%" for s in stream_names))
    for i, name in enumerate(names):
        cells = []
        for c, tot in zip(counts_per_stream, totals):
            cnt = int(c[i]) if i < len(c) else 0
            cells.append(f"{cnt:9d}  {cnt / tot * 100.0:6.1f}%")
        print(f"{name:>5} " + "  ".join(cells))
    return counts_per_stream


def save_loss_curve(out_dir: str, fold_idx: int, train_losses, val_losses,
                    tag: str = "loss_curve") -> Optional[str]:
    """Per-fold train/eval loss PNG at ``out_dir/fold_{fold_idx}/{tag}.png``
    (reference train/utilities.py:205-224); needs matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    epochs = list(range(1, len(train_losses) + 1))
    plt.figure()
    plt.plot(epochs, train_losses, label="Train Loss")
    plt.plot(epochs, val_losses, label="Eval Loss")
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.title(f"Fold {fold_idx} Loss Curves")
    plt.legend()
    plt.tight_layout()
    fold_dir = os.path.join(out_dir, f"fold_{fold_idx}")
    os.makedirs(fold_dir, exist_ok=True)
    path = os.path.join(fold_dir, f"{tag}.png")
    plt.savefig(path)
    plt.close()
    return path
