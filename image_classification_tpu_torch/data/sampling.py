"""Epoch index samplers, port of the inference sampler of
``image_classification_tpu/data/sampling.py``."""

from __future__ import annotations

import numpy as np


class SequentialSampler:
    def __init__(self, n: int):
        self.n = n

    def epoch_indices(self, epoch: int) -> np.ndarray:
        return np.arange(self.n)
