"""Dataset channel statistics, port of ``image_classification_tpu/data/stats.py``
(numpy, on the host).

``norm_stats=dataset`` normalizes with the train set's own per-channel mean
and std instead of ImageNet's: computed exactly (float64 sums) by
:func:`compute_channel_stats`, cached as JSON in ``cache_dir`` under the
decode cache's key (``channel_stats_{key}.json``, the JAX package's file),
and written beside the checkpoints (``model_save_path/norm_stats.json``) so
that ``cli predict`` normalizes as training did without the train set.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np

logger = logging.getLogger("ic_tpu_torch")

# the stats beside the checkpoints, in ``model_save_path``
NORM_STATS_FILE = "norm_stats.json"


def compute_channel_stats(source, batch_size: int = 1024
                          ) -> tuple[tuple[float, float, float], tuple[float, float, float]]:
    """(mean, std) per RGB channel on the 0..1 scale, over every pixel of
    ``source`` (anything with ``len`` and ``get_batch(indices)``)."""
    n = len(source)
    total = np.zeros(3, np.float64)
    total_sq = np.zeros(3, np.float64)
    count = 0
    for start in range(0, n, batch_size):
        batch = source.get_batch(np.arange(start, min(start + batch_size, n)))
        batch = batch.astype(np.float64) / 255.0
        total += batch.sum(axis=(0, 1, 2))
        total_sq += (batch ** 2).sum(axis=(0, 1, 2))
        count += batch.shape[0] * batch.shape[1] * batch.shape[2]
    mean = total / count
    std = np.sqrt(np.maximum(total_sq / count - mean ** 2, 0.0))
    return tuple(float(m) for m in mean), tuple(float(s) for s in std)


def _write(path: str, mean, std) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"mean": mean, "std": std}, f)


def resolve_norm_stats(cfg, source, save_to: str | None = None):
    """``cfg`` with ``mean``/``std`` replaced by the train set's stats when
    ``cfg.norm_stats == "dataset"`` (unchanged for ``"imagenet"``). A source
    with a decode-cache key (``_cache_key()``) reads and writes the cached
    JSON in ``cfg.cache_dir``; ``save_to`` also gets the stats."""
    if cfg.norm_stats == "imagenet":
        return cfg
    key = source._cache_key() if hasattr(source, "_cache_key") else None
    path = None if key is None else os.path.join(cfg.cache_dir, f"channel_stats_{key}.json")
    if path is not None and os.path.exists(path):
        with open(path) as f:
            stats = json.load(f)
        mean, std = tuple(stats["mean"]), tuple(stats["std"])
        logger.info("dataset channel stats (cached): mean=%s std=%s", mean, std)
    else:
        mean, std = compute_channel_stats(source)
        logger.info("dataset channel stats (computed): mean=%s std=%s", mean, std)
        if path is not None:
            _write(path, mean, std)
    if save_to is not None:
        _write(save_to, mean, std)
    return cfg.replace(mean=mean, std=std)


def load_saved_norm_stats(cfg, path: str):
    """``cfg`` with the stats that ``resolve_norm_stats(save_to=path)``
    wrote, or None when ``path`` does not exist."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        stats = json.load(f)
    mean, std = tuple(stats["mean"]), tuple(stats["std"])
    logger.info("dataset channel stats (from %s): mean=%s std=%s", path, mean, std)
    return cfg.replace(mean=mean, std=std)
