"""Training state, port of ``image_classification_tpu/train/train_state.py``.

The JAX package keeps one immutable pytree (params, optimizer state, EMA)
and every step returns a new one. In PyTorch's idiom the model is an
``nn.Module`` with f32 parameters, and the optimizer state is tensors
aligned with ``model.named_parameters()`` that the step updates in place
(``train/fused.py``): Adam's ``mu`` and ``nu``, and the EMA shadow. The
counters are host integers, as ``torch.optim`` keeps its step: ``step``
counts optimizer steps, ``count`` is Adam's count (the two advance
together; the schedule reads ``count`` before it advances). SWA is not
ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


@dataclass
class TrainState:
    step: int                           # optimizer steps completed
    model: nn.Module                    # parameters, f32, updated in place
    mu: list[torch.Tensor]              # Adam first moments
    nu: list[torch.Tensor]              # Adam second moments
    count: int                          # Adam count (optax ScaleByAdamState)
    ema: list[torch.Tensor] | None      # EMA shadow; None when EMA is off

    def names(self) -> list[str]:
        return [n for n, _ in self.model.named_parameters()]

    def params(self) -> list[torch.Tensor]:
        return [p for _, p in self.model.named_parameters()]

    def eval_params(self, use_ema: bool = True) -> dict[str, torch.Tensor]:
        """Parameters to validate with: the EMA shadow when enabled (the
        reference validates under ``ema.apply_shadow``)."""
        values = self.ema if use_ema and self.ema is not None else self.params()
        return dict(zip(self.names(), values))


def create_train_state(model: nn.Module, use_ema: bool = True) -> TrainState:
    params = [p.detach() for p in model.parameters()]
    return TrainState(
        step=0,
        model=model,
        mu=[torch.zeros_like(p) for p in params],
        nu=[torch.zeros_like(p) for p in params],
        count=0,
        ema=[p.clone() for p in params] if use_ema else None,
    )


@torch.no_grad()
def ema_update(ema: list[torch.Tensor], params: list[torch.Tensor],
               decay: float) -> None:
    """shadow = decay * shadow + (1 - decay) * param, in place."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [p.detach() for p in params], alpha=1.0 - decay)
