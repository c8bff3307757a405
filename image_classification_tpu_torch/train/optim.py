"""Optimizer construction, port of ``image_classification_tpu/train/optim.py``
for the default recipe.

AdamW with torch-parity defaults: betas (0.9, 0.999), eps 1e-8, weight decay
on **all** parameters, global-norm clipping before the update. The JAX
package builds an optax chain and attaches its schedule (``ScheduledTx``) so
its step can run the fused update; the port has no optax, so
:func:`build_optimizer` returns the hyperparameters and the schedule, which
``train/fused.py:fused_adamw_ema`` applies. The generic optax path is not
ported: layer freezing and the plateau schedule raise. ``fused_update`` is
not read: the fused update computes the same math as the generic one.
"""

from __future__ import annotations

from typing import Callable, NamedTuple


class ScheduledTx(NamedTuple):
    """AdamW hyperparameters plus the LR schedule (count -> lr)."""

    b1: float
    b2: float
    eps: float
    weight_decay: float
    gradient_clip_val: float
    schedule: Callable[[int], float]


def build_optimizer(cfg, lr_schedule: Callable[[int], float] | float) -> ScheduledTx:
    if cfg.optimizer.lower() != "adamw":
        raise ValueError(f"Unsupported optimizer {cfg.optimizer!r}")
    if cfg.schedule == "plateau":
        raise NotImplementedError(
            "schedule=plateau needs the generic optax path with an injected "
            "LR, which is not ported")
    if cfg.freeze_stages > 0:
        raise NotImplementedError(
            "freeze_stages > 0 needs the generic optax path "
            "(optax.multi_transform), which is not ported")
    if callable(lr_schedule):
        schedule = lr_schedule
    else:  # constant LR ("none")
        lr_const = float(lr_schedule)
        schedule = lambda count: lr_const  # noqa: E731
    return ScheduledTx(b1=cfg.adam_b1, b2=cfg.adam_b2, eps=cfg.adam_eps,
                       weight_decay=cfg.weight_decay,
                       gradient_clip_val=cfg.gradient_clip_val,
                       schedule=schedule)
