"""Epoch index samplers, port of ``image_classification_tpu/data/sampling.py``.

Each sampler is a pure numpy function of ``(seed, epoch)``, so any epoch's
order can be reproduced (resume needs it) and the port's orders equal the JAX
package's bit for bit.
"""

from __future__ import annotations

import numpy as np


def inverse_frequency_weights(labels: np.ndarray) -> np.ndarray:
    """Per-sample weight 1/class_count, normalized to sum to 1."""
    counts = np.bincount(labels)
    w = 1.0 / counts[labels]
    return w / w.sum()


class SequentialSampler:
    def __init__(self, n: int):
        self.n = n

    def epoch_indices(self, epoch: int) -> np.ndarray:
        return np.arange(self.n)


class ShuffleSampler:
    def __init__(self, n: int, seed: int = 42):
        self.n = n
        self.seed = seed

    def epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(self.n)


class WeightedSampler:
    """Sampling with replacement proportional to per-sample weights: ``n``
    indices an epoch, like torch's WeightedRandomSampler with
    ``num_samples=len(dataset)``."""

    def __init__(self, weights: np.ndarray, seed: int = 42,
                 num_samples: int | None = None):
        w = np.asarray(weights, dtype=np.float64)
        self.p = w / w.sum()
        self.num_samples = num_samples or len(w)
        self.seed = seed

    def epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.choice(len(self.p), size=self.num_samples, replace=True, p=self.p)
