# Frozen copy of image_classification_tpu_torch/aug/draws.py for the benchmark's
# reference: the reference may not import the program it judges.
"""The draw steps' helpers. Every random op of the augmentation is split in
two: ``draw_*`` takes a ``torch.Generator`` and returns a NamedTuple of
tensors on the generator's device, with the distributions and shapes of the
JAX op's draws; the op itself applies those tensors. JAX's threefry keys
cannot be reproduced in torch, so tests feed the JAX package's draws to the
apply steps instead."""

from __future__ import annotations

import torch


def uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """U(lo, hi) in f32."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u if (lo, hi) == (0.0, 1.0) else u * (hi - lo) + lo


def bernoulli(gen: torch.Generator, p: float, n: int) -> torch.Tensor:
    """(n,) bool gates, ``uniform < p`` as ``jax.random.bernoulli``."""
    return uniform(gen, (n,)) < p


def randint(gen: torch.Generator, lo: int, hi: int, shape) -> torch.Tensor:
    """Integers in [lo, hi)."""
    return torch.randint(lo, hi, shape, generator=gen, device=gen.device)


def draws_to(draws, device):
    """A (nested) NamedTuple or tuple of draws with every tensor moved to
    ``device``."""
    if draws is None:
        return None
    if isinstance(draws, torch.Tensor):
        return draws.to(device)
    moved = (draws_to(d, device) for d in draws)
    return type(draws)(*moved) if hasattr(draws, "_fields") else tuple(moved)
