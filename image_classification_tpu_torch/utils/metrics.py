"""Per-class F1 and macro-F1 from a confusion matrix, port of the part of
``image_classification_tpu/utils/metrics.py`` that ``train/loop.py:evaluate``
needs. Float32 math, as the JAX package computes it with 64-bit mode off."""

from __future__ import annotations

import torch


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
