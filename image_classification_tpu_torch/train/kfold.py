"""Stratified K-fold orchestration, port of
``image_classification_tpu/train/kfold.py``: read the manifest, log the class
distribution, split with the stratified K-fold (``cfg.fold_seed``), and per
fold build the loaders (the validation batch is ``batch_size *
val_batch_multiplier``), then train the fold; a fold that fails is logged
with its trace and skipped, as in the reference.

The images come from the decoded-image cache (``data/source.py:
load_decode_cache``), read once over the whole manifest; folds index into it.

Not ported, each raising ``NotImplementedError``: ``fold_parallel`` (ROADMAP
queue A, item 14), ``split_mode=holdout`` (sklearn's ``train_test_split``),
``norm_stats=dataset``, ``train_ensemble`` (ViT, queue A, item 12) and
``use_decode_cache=false`` (decoding without the cache, queue A, item 4).
``prefetch_depth > 0`` logs a warning: the loader runs in the step's thread.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np
import torch

from image_classification_tpu_torch.data.loader import DataLoader
from image_classification_tpu_torch.data.manifest import (
    Manifest,
    distribution_stats,
    verify_images,
)
from image_classification_tpu_torch.data.sampling import (
    SequentialSampler,
    ShuffleSampler,
    WeightedSampler,
    inverse_frequency_weights,
)
from image_classification_tpu_torch.data.source import load_decode_cache
from image_classification_tpu_torch.data.splits import (
    oversample_minority,
    stratified_kfold,
)
from image_classification_tpu_torch.train.loop import FoldResult, train_fold

logger = logging.getLogger("ic_tpu_torch")


def build_source(cfg, manifest: Manifest, img_dir: str):
    """The decoded uint8 images of ``manifest`` under ``img_dir``."""
    if not cfg.use_decode_cache:
        raise NotImplementedError("use_decode_cache=false: the port decodes no "
                                  "JPEGs yet and reads only the decode cache "
                                  "(ROADMAP queue A, item 4)")
    return load_decode_cache(img_dir, manifest.ids, tuple(cfg.native_size),
                             cfg.cache_dir)


def make_fold_loaders(cfg, source, manifest: Manifest, train_idx, val_idx,
                      device: str | torch.device = "cuda"):
    train_labels = manifest.labels[train_idx]
    if cfg.oversample_min_samples > 0:
        extra = oversample_minority(train_labels, cfg.oversample_min_samples,
                                    seed=cfg.seed)
        train_idx = train_idx[extra]
        train_labels = manifest.labels[train_idx]
    if cfg.use_sampler:
        sampler: Any = WeightedSampler(inverse_frequency_weights(train_labels),
                                       seed=cfg.seed)
    else:
        sampler = ShuffleSampler(len(train_idx), seed=cfg.seed)
    train_loader = DataLoader(source, manifest, indices=train_idx,
                              batch_size=cfg.batch_size, sampler=sampler,
                              drop_last=True, device=device)
    val_loader = DataLoader(source, manifest, indices=val_idx,
                            batch_size=cfg.batch_size * cfg.val_batch_multiplier,
                            sampler=SequentialSampler(len(val_idx)), pad_last=True,
                            device=device)
    return train_loader, val_loader, train_labels


def train_k_fold(cfg, manifest: Manifest | None = None, source=None,
                 resume: bool = False, model_name: str | None = None,
                 device: str | torch.device = "cuda") -> list[FoldResult]:
    if cfg.fold_parallel:
        raise NotImplementedError("fold_parallel: training the folds side by side "
                                  "is not ported (ROADMAP queue A, item 14)")
    if cfg.split_mode == "holdout":
        raise NotImplementedError("split_mode=holdout needs sklearn's "
                                  "train_test_split, which is not ported "
                                  "(ROADMAP queue A, left out of the port)")
    if cfg.norm_stats == "dataset":
        raise NotImplementedError("norm_stats=dataset is not ported yet "
                                  "(ROADMAP queue A, left out of the port)")
    if cfg.prefetch_depth > 0:
        logger.warning("prefetch_depth=%d: the port's loader has no background "
                       "prefetch; it assembles each batch in the step's thread "
                       "(ROADMAP queue A, item 4)", cfg.prefetch_depth)
    if manifest is None:
        manifest = Manifest.from_csv(cfg.train_csv, num_classes=cfg.num_classes)
    logger.info("class distribution: %s",
                distribution_stats(manifest.labels, cfg.num_classes))
    missing = verify_images(manifest, cfg.train_dir)
    if missing:
        logger.warning("%d/%d train images missing on disk (first 10: %s); the "
                       "decode cache serves them", len(missing), len(manifest),
                       missing[:10])
    if source is None:
        source = build_source(cfg, manifest, cfg.train_dir)
    results: list[FoldResult] = []
    splits = stratified_kfold(manifest.labels, cfg.num_folds, seed=cfg.fold_seed)
    for fold, (train_idx, val_idx) in enumerate(splits, start=1):
        logger.info("fold %d/%d: train %d / val %d", fold, cfg.num_folds,
                    len(train_idx), len(val_idx))
        try:
            train_loader, val_loader, train_labels = make_fold_loaders(
                cfg, source, manifest, train_idx, val_idx, device=device)
            class_counts = np.bincount(train_labels, minlength=cfg.num_classes)
            result = train_fold(cfg, train_loader, val_loader, fold=fold,
                                class_counts=class_counts, resume=resume,
                                model_name=model_name)
            results.append(result)
            logger.info("fold %d done: best val acc %.4f", fold, result.best_val_acc)
        except KeyboardInterrupt:
            raise
        except Exception:
            # the reference's per-fold tolerance, with the full trace logged
            logger.exception("fold %d failed; continuing", fold)
            continue
    return results


def train_ensemble(cfg, *args, **kwargs):
    raise NotImplementedError("train_ensemble: the multi-architecture ensemble "
                              "needs ViT, which is not ported (ROADMAP queue A, "
                              "item 12)")
