"""Optimizer construction, port of ``image_classification_tpu/train/optim.py``
for the default recipe.

AdamW with torch-parity defaults: betas (0.9, 0.999), eps 1e-8, weight decay
on **all** parameters, global-norm clipping before the update. The JAX
package builds an optax chain and attaches its schedule (``ScheduledTx``) so
its step can run the fused update; the port has no optax, so
:func:`build_optimizer` returns the hyperparameters and the schedule, which
``train/fused.py:fused_adamw_ema`` applies. With ``schedule=plateau`` the
schedule is the constant ``cfg.lr``, and the trainer sets a new LR with
:func:`set_learning_rate` (optax's injected hyperparameter in the JAX
package). ``fused_update`` is not read: the fused update computes the same
math as the generic one.

Layer freezing (``freeze_stages > 0``): the JAX package labels the stem and
every ``stage{s}_*`` / ``downsample{s}_*`` module with ``s < freeze_stages``
frozen and wraps the whole clip + AdamW chain in ``optax.multi_transform``
with ``set_to_zero`` for them, so the global-norm clip counts only the
trainable gradients and a frozen parameter gets no moments, no decay and no
update. In timm keys (the port's parameter names) that is ``stem.*`` and
``stages.{s}.*``, under ``backbone.`` with deep supervision; the aux heads
train. :func:`trainable_indices` names the parameters the update touches.
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
    freeze_stages: int = 0


def build_optimizer(cfg, lr_schedule: Callable[[int], float] | float) -> ScheduledTx:
    if cfg.optimizer.lower() != "adamw":
        raise ValueError(f"Unsupported optimizer {cfg.optimizer!r}")
    schedule = lr_schedule if callable(lr_schedule) else _constant(lr_schedule)
    return ScheduledTx(b1=cfg.adam_b1, b2=cfg.adam_b2, eps=cfg.adam_eps,
                       weight_decay=cfg.weight_decay,
                       gradient_clip_val=cfg.gradient_clip_val,
                       schedule=schedule, freeze_stages=cfg.freeze_stages)


def is_frozen(name: str, freeze_stages: int) -> bool:
    """Whether the parameter ``name`` (a timm key) is frozen."""
    if freeze_stages <= 0:
        return False
    name = name.removeprefix("backbone.")
    return name.startswith("stem.") or any(
        name.startswith(f"stages.{s}.") for s in range(freeze_stages))


def trainable_indices(names: list[str], freeze_stages: int) -> list[int] | None:
    """Positions in ``names`` of the parameters the update touches, or None
    when nothing is frozen (all of them)."""
    if freeze_stages <= 0:
        return None
    return [i for i, n in enumerate(names) if not is_frozen(n, freeze_stages)]


def _constant(lr: float) -> Callable[[int], float]:
    lr = float(lr)
    return lambda count: lr


def set_learning_rate(tx: ScheduledTx, lr: float) -> ScheduledTx:
    """``tx`` with the constant LR ``lr`` (the plateau schedule's step)."""
    return tx._replace(schedule=_constant(lr))
