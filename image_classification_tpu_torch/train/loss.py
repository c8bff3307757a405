"""Losses, port of ``image_classification_tpu/train/loss.py``: label-smoothed
CE (hard and soft targets), focal, class-weighted CE and the
deep-supervision combination, all in f32 on the logits.

torch-parity notes (the JAX module's):
- with integer targets, ``(1-e)*NLL + e*mean_k(-log p_k)``; with probability
  targets the targets are smoothed, ``t' = t*(1-e) + e/K``;
- class-weighted CE normalizes by the sum of the selected weights;
- focal loss is ``(1-pt)^gamma * CE`` with an optional per-class alpha;
- deep supervision is ``0.6*CE(main) + (0.4/n_aux)*sum CE(aux)``, and soft
  targets are argmaxed back to class indices first (the reference's quirk,
  ``soft_targets=False``).

Data parallelism: with a process ``group`` each rank holds its rows of the
global batch, and a mean becomes this rank's sum over the *global* row
count (the weighted CE's over the global sum of the selected weights), so
the ranks' losses and gradients sum to the global batch's.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist


def _global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (no gradient) summed over ``group``; ``x`` where it is None."""
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x


def _reduce(per: torch.Tensor, reduction: str, group=None) -> torch.Tensor:
    if reduction == "mean":
        if group is not None:
            return per.sum() / (per.shape[0] * dist.get_world_size(group))
        return per.mean()
    if reduction == "sum":
        return per.sum()
    return per


def smoothed_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    smoothing: float = 0.0,
    class_weights: torch.Tensor | None = None,
    reduction: str = "mean",
    group=None,
) -> torch.Tensor:
    """CE with integer labels, torch semantics."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    smooth = -logp.mean(dim=-1)
    per = (1.0 - smoothing) * nll + smoothing * smooth
    if class_weights is not None:
        w = class_weights[labels]
        if reduction == "mean":
            return (per * w).sum() / torch.clamp(_global_sum(w.sum(), group), min=1e-12)
        per = per * w
    return _reduce(per, reduction, group)


def soft_target_cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    smoothing: float = 0.0,
    reduction: str = "mean",
    group=None,
) -> torch.Tensor:
    """CE with probability targets, torch semantics (smooths the targets)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    t = targets * (1.0 - smoothing) + smoothing / logits.shape[-1]
    return _reduce(-(t * logp).sum(dim=-1), reduction, group)


def focal_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    gamma: float = 2.0,
    alpha: torch.Tensor | None = None,
    reduction: str = "mean",
    group=None,
) -> torch.Tensor:
    ce = smoothed_cross_entropy(logits, labels, 0.0, reduction="none")
    per = (1.0 - torch.exp(-ce)) ** gamma * ce
    if alpha is not None:
        per = alpha[labels.long()] * per
    return _reduce(per, reduction, group)


def deep_supervision_loss(
    outputs: Sequence[torch.Tensor],
    targets: torch.Tensor,
    main_weight: float = 0.6,
    smoothing: float = 0.1,
    soft_targets: bool = False,
    group=None,
) -> torch.Tensor:
    """Combine main + aux head losses (the reference's
    ``train_advanced_v4.py:153-181``)."""
    if targets.dim() == 2 and not soft_targets:
        targets = targets.argmax(dim=-1)  # the reference's quirk

    def ce(logits: torch.Tensor) -> torch.Tensor:
        if targets.dim() == 2:
            return soft_target_cross_entropy(logits, targets, smoothing, group=group)
        return smoothed_cross_entropy(logits, targets, smoothing, group=group)

    outputs = list(outputs)
    if len(outputs) == 1:
        return ce(outputs[0])
    total = main_weight * ce(outputs[0])
    aux_w = (1.0 - main_weight) / (len(outputs) - 1)
    for aux in outputs[1:]:
        total = total + aux_w * ce(aux)
    return total


def build_criterion(
    cfg,
    class_counts: torch.Tensor | None = None,
    class_weights: torch.Tensor | None = None,
    group=None,
) -> Callable:
    """``loss_fn(outputs, targets)``: weighted CE | focal | plain smoothed
    CE, deep-supervision aware. ``outputs`` is a logits tensor or a tuple
    (deep supervision); ``targets`` are int labels or soft labels.
    ``class_weights`` overrides the weights derived from ``class_counts``.
    ``group``: the data-parallel process group whose ranks hold the global
    batch (the train step's, ``parallel/mesh.py``)."""
    if class_weights is None and cfg.use_weighted_loss and class_counts is not None:
        w = 1.0 / torch.clamp(torch.as_tensor(class_counts).float(), min=1.0)
        class_weights = w / w.sum() * len(w)

    def criterion(outputs, targets):
        is_tuple = isinstance(outputs, (tuple, list))
        if cfg.use_focal_loss:
            main = outputs[0] if is_tuple else outputs
            t = targets.argmax(-1) if targets.dim() == 2 else targets
            return focal_loss(main, t, gamma=cfg.focal_gamma, alpha=class_weights,
                              group=group)
        if is_tuple and cfg.use_deep_supervision:
            return deep_supervision_loss(
                outputs, targets,
                main_weight=1.0 - cfg.aux_weight,
                smoothing=cfg.label_smoothing,
                group=group,
            )
        main = outputs[0] if is_tuple else outputs
        if targets.dim() == 2:
            return soft_target_cross_entropy(main, targets, cfg.label_smoothing,
                                             group=group)
        return smoothed_cross_entropy(
            main, targets, cfg.label_smoothing, class_weights, group=group
        )

    criterion.group = group
    return criterion
