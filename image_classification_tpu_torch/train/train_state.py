"""Training state, port of ``image_classification_tpu/train/train_state.py``.

The JAX package keeps one immutable pytree (params, optimizer state, EMA)
and every step returns a new one. In PyTorch's idiom the model is an
``nn.Module`` with f32 parameters, and the optimizer state is tensors
aligned with ``model.named_parameters()`` that the step updates in place
(``train/fused.py``): Adam's ``mu`` and ``nu``, the EMA shadow, and SWA's
running average of the parameters. The counters are host integers, as
``torch.optim`` keeps its step: ``step`` counts optimizer steps, ``count``
is Adam's count (the two advance together; the schedule reads ``count``
before it advances), ``swa_count`` the SWA snapshots averaged. BatchNorm's
running statistics (the JAX state's ``batch_stats``) are the module's
buffers; EMA and SWA average the parameters only.
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
    swa: list[torch.Tensor] | None = None   # SWA running average; None when off
    swa_count: int = 0                  # SWA snapshots averaged

    def names(self) -> list[str]:
        return [n for n, _ in self.model.named_parameters()]

    def params(self) -> list[torch.Tensor]:
        return [p for _, p in self.model.named_parameters()]

    def eval_params(self, use_ema: bool = True) -> dict[str, torch.Tensor]:
        """Parameters to validate with: the EMA shadow when enabled (the
        reference validates under ``ema.apply_shadow``)."""
        values = self.ema if use_ema and self.ema is not None else self.params()
        return dict(zip(self.names(), values))

    def buffers(self) -> dict[str, torch.Tensor]:
        """The module's buffers by name: BatchNorm's running statistics."""
        return dict(self.model.named_buffers())

    def eval_state_dict(self, use_ema: bool = True) -> dict[str, torch.Tensor]:
        """The weights to checkpoint as the model's state dict:
        :meth:`eval_params` and the live running statistics (the JAX
        package saves the EMA parameters with the live ``batch_stats``)."""
        return {**self.eval_params(use_ema), **self.buffers()}


def create_train_state(model: nn.Module, use_ema: bool = True,
                       use_swa: bool = False) -> TrainState:
    params = [p.detach() for p in model.parameters()]
    return TrainState(
        step=0,
        model=model,
        mu=[torch.zeros_like(p) for p in params],
        nu=[torch.zeros_like(p) for p in params],
        count=0,
        ema=[p.clone() for p in params] if use_ema else None,
        swa=[torch.zeros_like(p) for p in params] if use_swa else None,
    )


@torch.no_grad()
def swa_update(state: TrainState) -> None:
    """Fold the current parameters into SWA's running average in place,
    ``(a * n + p) / (n + 1)`` (torch ``AveragedModel``'s arithmetic mean
    over snapshots)."""
    n = state.swa_count
    torch._foreach_mul_(state.swa, float(n))
    torch._foreach_add_(state.swa, [p.detach() for p in state.params()])
    torch._foreach_div_(state.swa, float(n + 1))
    state.swa_count = n + 1


@torch.no_grad()
def ema_update(ema: list[torch.Tensor], params: list[torch.Tensor],
               decay: float) -> None:
    """shadow = decay * shadow + (1 - decay) * param, in place."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [p.detach() for p in params], alpha=1.0 - decay)
