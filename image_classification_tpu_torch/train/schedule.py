"""LR schedules, port of ``image_classification_tpu/train/schedule.py``.

``warmup_cosine_schedule`` reproduces the reference's hand-rolled LambdaLR,
quirk included: ``min_lr`` (1e-6) is a floor on the *multiplier*, not on the
absolute LR. The schedule runs on the host, in float32 as the JAX package
evaluates it inside its step, and takes the Adam count as a Python int: the
port keeps that count on the host (``train/train_state.py``), so reading the
LR costs no device sync. The microbatch-horizon quirk is the caller's
(``train/loop.py:build_lr_schedule``).

``PlateauScheduler`` is the host-side ReduceLROnPlateau (mode='max').
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np


def warmup_cosine_schedule(
    base_lr: float,
    num_warmup_steps: int,
    num_training_steps: int,
    min_lr_multiplier: float = 1e-6,
) -> Callable[[int], float]:
    f32 = np.float32

    def schedule(count: int) -> float:
        c = f32(count)
        warm = c / f32(max(1.0, num_warmup_steps))
        progress = (c - f32(num_warmup_steps)) / f32(
            max(1.0, num_training_steps - num_warmup_steps))
        cos = max(f32(min_lr_multiplier),
                  f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * progress)))
        return float(f32(base_lr) * (warm if c < num_warmup_steps else cos))

    return schedule


class PlateauScheduler:
    """Host-side ReduceLROnPlateau (mode='max')."""

    def __init__(
        self,
        base_lr: float,
        factor: float = 0.1,
        patience: int = 3,
        min_lr: float = 0.0,
    ):
        self.lr = base_lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = -math.inf
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        """Report a (higher-is-better) metric; returns the current LR."""
        if metric > self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.min_lr, self.lr * self.factor)
                self.bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        """JSON-serializable internals, persisted in the resume checkpoint."""
        best = None if self.best == -math.inf else self.best
        return {"lr": self.lr, "best": best, "bad_epochs": self.bad_epochs}

    def load_state_dict(self, d: dict) -> None:
        self.lr = float(d["lr"])
        best = d["best"]
        self.best = -math.inf if best is None else float(best)
        self.bad_epochs = int(d["bad_epochs"])
