"""Metrics, port of ``image_classification_tpu/utils/metrics.py``: the
running average, top-1 accuracy, the confusion matrix, per-class F1,
macro-F1 and the per-class report. Float32 math, as the JAX package
computes it with 64-bit mode off (the report in float64 on the host, as
there)."""

from __future__ import annotations

import numpy as np
import torch


class AverageMeter:
    """Tracks current value, running sum, count, and average."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(1, self.count)


def accuracy_top1(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean top-1 accuracy. ``labels`` may be integer or one-hot/soft."""
    if labels.dim() == 2:
        labels = labels.argmax(dim=-1)
    return (logits.argmax(dim=-1) == labels).float().mean()


def confusion_matrix(preds: torch.Tensor, labels: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """(num_classes, num_classes) int counts with rows = true class."""
    idx = labels.long() * num_classes + preds.long()
    counts = torch.bincount(idx.reshape(-1), minlength=num_classes * num_classes)
    return counts.reshape(num_classes, num_classes)


def per_class_f1(cm) -> torch.Tensor:
    """Per-class F1 from a (K, K) confusion matrix (rows = true class);
    classes with no support and no predictions get F1 = 0 (sklearn's
    zero_division=0 convention)."""
    cm = torch.as_tensor(cm).float()
    tp = torch.diagonal(cm)
    fp = cm.sum(dim=0) - tp
    fn = cm.sum(dim=1) - tp
    denom = 2 * tp + fp + fn
    return torch.where(denom > 0, 2 * tp / torch.clamp(denom, min=1e-12),
                       torch.zeros_like(denom))


def macro_f1(cm) -> torch.Tensor:
    return per_class_f1(cm).mean()


def classification_report(cm, class_names: list[str] | None = None) -> str:
    """Human-readable per-class precision/recall/F1/support table."""
    cm = np.asarray(cm.cpu() if isinstance(cm, torch.Tensor) else cm)
    n = cm.shape[0]
    names = class_names or [str(i) for i in range(n)]
    tp = np.diagonal(cm).astype(np.float64)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    support = cm.sum(axis=1)
    prec = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
    rec = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
    f1 = np.where(prec + rec > 0, 2 * prec * rec / np.maximum(prec + rec, 1e-12), 0.0)
    lines = [f"{'class':>8} {'prec':>7} {'rec':>7} {'f1':>7} {'support':>8}"]
    for i in range(n):
        lines.append(
            f"{names[i]:>8} {prec[i]:7.4f} {rec[i]:7.4f} {f1[i]:7.4f} {int(support[i]):8d}"
        )
    lines.append(
        f"{'macro':>8} {prec.mean():7.4f} {rec.mean():7.4f} {f1.mean():7.4f} "
        f"{int(support.sum()):8d}"
    )
    return "\n".join(lines)
