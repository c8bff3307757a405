"""Clip + AdamW + EMA in one pass over the parameter list, port of
``image_classification_tpu/train/fused.py:fused_adamw_ema``.

The JAX version is one ``jax.tree.map`` that XLA fuses per leaf; here each
step of the formula is one ``torch._foreach_*`` call over all parameters,
applied in place to the parameters, ``mu``, ``nu`` and the EMA (plain
PyTorch: the JAX version is XLA, not a Pallas kernel). Formula for formula:

- clip: ``g *= where(gnorm < clip, 1, clip / gnorm)``, ``gnorm`` the global
  L2 norm of the gradients;
- adam: ``mu = b1*mu + (1-b1)*g``; ``nu = b2*nu + (1-b2)*g*g``;
  ``u = (mu/(1-b1^c)) / (sqrt(nu/(1-b2^c)) + eps)`` with ``c = count+1``;
- adamw: ``u += wd * p`` on every parameter; ``p -= lr(count) * u``, the
  schedule read at the count before it advances;
- EMA after the update: ``e = d*e + (1-d)*p``.

The bias corrections and the LR are computed on the host in float32 from the
host count; the gradient norm and the clip scale stay on the device, so the
update never waits for the card.

With frozen parameters (``train/optim.py:trainable_indices``) the norm, the
moments and the update run over the trainable ones only, as the JAX
package's ``optax.multi_transform`` with ``set_to_zero`` does; the frozen
ones keep their bits, and the EMA still averages every parameter, as the
JAX step's EMA after its generic update does.

Under tensor parallelism (``parallel/shardings.py``) the gradients of the
split parameters are this rank's shards: the norm's square sum takes each
replicated gradient once and the shards' squares summed over the model
group, so every rank clips by JAX's global norm.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from image_classification_tpu_torch.train.train_state import TrainState, ema_update

_INT32_MAX = 2**31 - 1


def _global_norm(grads: list[torch.Tensor], sharded: list[bool] | None,
                 model_group) -> torch.Tensor:
    norms = torch._foreach_norm(grads)
    if sharded is None:
        return torch.linalg.vector_norm(torch.stack(norms))
    whole = [n for n, s in zip(norms, sharded) if not s]
    parts = torch.stack([n for n, s in zip(norms, sharded) if s]).square().sum()
    dist.all_reduce(parts, group=model_group)
    return torch.sqrt((torch.stack(whole).square().sum() if whole else 0.0) + parts)


@torch.no_grad()
def fused_adamw_ema(grads: list[torch.Tensor], state: TrainState, *,
                    tx, cfg, trainable: list[int] | None = None,
                    sharded: list[bool] | None = None,
                    model_group=None) -> torch.Tensor | None:
    """Apply one update to ``state`` in place (parameters, ``mu``, ``nu``,
    EMA, ``count``). ``grads`` align with ``state.params()``, or with its
    entries at ``trainable`` when given (the others are frozen); ``tx`` is
    ``train/optim.py:build_optimizer``'s result. Returns the global gradient
    norm (a device scalar) where the clip or ``cfg.debug_nans`` needs it,
    else None. ``sharded`` (aligned with ``grads``) marks the gradients
    split over ``model_group``."""
    all_params = state.params()
    params, mu, nu = all_params, state.mu, state.nu
    if trainable is not None:
        params, mu, nu = ([v[i] for i in trainable] for v in (all_params, mu, nu))
    b1, b2, eps, wd = tx.b1, tx.b2, tx.eps, tx.weight_decay
    count_inc = min(state.count + 1, _INT32_MAX)   # optax.safe_increment
    lr = tx.schedule(state.count)

    gnorm = None
    if tx.gradient_clip_val > 0 or cfg.debug_nans:
        gnorm = _global_norm(grads, sharded, model_group)
    if tx.gradient_clip_val > 0:
        # the clip value stays a Python scalar (cast to f32 by each op): a
        # tensor made from it would be a host copy that waits for the card
        clip = tx.gradient_clip_val
        gscale = torch.where(gnorm < clip, torch.ones_like(gnorm), clip / gnorm)
        grads = torch._foreach_mul(grads, gscale)

    f32 = np.float32
    bc1 = float(f32(1.0) - f32(b1) ** f32(count_inc))
    bc2 = float(f32(1.0) - f32(b2) ** f32(count_inc))

    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    update = torch._foreach_div(mu, bc1)
    torch._foreach_div_(update, denom)
    torch._foreach_add_(update, params, alpha=wd)
    torch._foreach_mul_(update, lr)
    torch._foreach_sub_(params, update)
    if state.ema is not None:
        ema_update(state.ema, all_params, cfg.ema_decay)
    state.count = count_inc
    return gnorm
