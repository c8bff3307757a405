"""Stratified K-fold orchestration, port of
``image_classification_tpu/train/kfold.py``: read the manifest, log the class
distribution, resolve ``norm_stats=dataset`` once for the run (saved as
``model_save_path/norm_stats.json``), split, and per fold build the loaders
(the validation batch is ``batch_size * val_batch_multiplier``, both loaders
``prefetch_depth`` batches ahead on a background thread), then train the
fold; a fold that fails is logged with its trace and skipped, as in the
reference. The split is the stratified K-fold (``cfg.fold_seed``), or with
``split_mode=holdout`` one stratified split of ``val_fraction`` after every
class is oversampled to 2 members, trained as fold 1.

The images are decoded once over the whole manifest (``data/source.py:
ImageSource``, from the JPEG files under ``train_dir``), into the decode
cache under ``cache_dir`` with ``use_decode_cache`` (reused when it is
complete) or else in memory; folds index into them.

``train_ensemble`` runs the whole K-fold loop once per member of
``ensemble_models`` (e.g. V2's ConvNeXt-B + ViT-B/16 + DeiT-B/16), each
under ``{model_save_path}/{name}`` and ``{output_dir}/{name}``, and weights
each fold result by its member's weight split evenly over the member's
surviving folds. A member whose folds all fail (a ViT at a size that is not
a multiple of its patch, as V2's 60x80) leaves no result and no weight.

With a ``mesh`` (``parallel/mesh.py``) the loaders yield each rank its
rows of the data axis; rank 0 decodes (and writes the decode cache and the
stats) before the other ranks read them. ``fold_parallel=true`` trains the
folds side by side, one rank group each (``train/foldpar.py``).
"""

from __future__ import annotations

import logging
import os
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
from image_classification_tpu_torch.data.source import ImageSource
from image_classification_tpu_torch.data.splits import (
    oversample_minority,
    stratified_kfold,
    stratified_split,
)
from image_classification_tpu_torch.data.stats import NORM_STATS_FILE, resolve_norm_stats
from image_classification_tpu_torch.parallel.distributed import (
    host_share,
    is_primary,
    primary_first,
)
from image_classification_tpu_torch.parallel.mesh import DATA_AXIS, check_batch_divisible
from image_classification_tpu_torch.train.loop import FoldResult, train_fold

logger = logging.getLogger("ic_tpu_torch")


# The decoder's threads on a host (JAX's ImageSource default, one process a
# host).
DECODE_THREADS = 16


def decode_threads() -> int:
    """The decoder's threads for this rank under :func:`primary_first`: rank
    0 decodes alone and takes the host's budget; the other ranks decode at
    once (where there is no decode cache to read) and share it."""
    return DECODE_THREADS if is_primary() else host_share(DECODE_THREADS)


def build_source(cfg, manifest: Manifest, img_dir: str,
                 num_threads: int = DECODE_THREADS) -> ImageSource:
    """The decoded uint8 images of ``manifest`` under ``img_dir``, through
    the decode cache when ``cfg.use_decode_cache``."""
    return ImageSource(img_dir, manifest.ids, native_size=tuple(cfg.native_size),
                       cache_dir=cfg.cache_dir if cfg.use_decode_cache else None,
                       num_threads=num_threads)


def make_fold_loaders(cfg, source, manifest: Manifest, train_idx, val_idx,
                      device: str | torch.device = "cuda", mesh=None):
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
    shard = {}
    if mesh is not None:
        check_batch_divisible(cfg.batch_size, mesh)
        shard = dict(process_index=mesh.index(DATA_AXIS),
                     process_count=mesh.size(DATA_AXIS))
    train_loader = DataLoader(source, manifest, indices=train_idx,
                              batch_size=cfg.batch_size, sampler=sampler,
                              drop_last=True, device=device,
                              prefetch_depth=cfg.prefetch_depth, **shard)
    val_loader = DataLoader(source, manifest, indices=val_idx,
                            batch_size=cfg.batch_size * cfg.val_batch_multiplier,
                            sampler=SequentialSampler(len(val_idx)), pad_last=True,
                            device=device, prefetch_depth=cfg.prefetch_depth, **shard)
    return train_loader, val_loader, train_labels


def train_k_fold(cfg, manifest: Manifest | None = None, source=None,
                 resume: bool = False, model_name: str | None = None,
                 device: str | torch.device = "cuda", mesh=None) -> list[FoldResult]:
    if manifest is None:
        manifest = Manifest.from_csv(cfg.train_csv, num_classes=cfg.num_classes)
    logger.info("class distribution: %s",
                distribution_stats(manifest.labels, cfg.num_classes))
    missing = verify_images(manifest, cfg.train_dir)
    if missing:
        logger.warning("%d/%d train images missing on disk (first 10: %s); a "
                       "complete decode cache serves them, else fallback images "
                       "are substituted", len(missing), len(manifest), missing[:10])
    # the stats ship with the checkpoints, so `cli predict` normalizes as
    # training did without the train set
    save_to = os.path.join(cfg.model_save_path, NORM_STATS_FILE) if is_primary() else None

    def prepare(source=source):
        if source is None:
            source = build_source(cfg, manifest, cfg.train_dir, decode_threads())
        return source, resolve_norm_stats(cfg, source, save_to=save_to)

    source, cfg = primary_first(prepare)
    results: list[FoldResult] = []
    if cfg.split_mode == "holdout":
        # every class oversampled to 2 members so that it can be stratified,
        # then one split, trained as fold 1
        base = oversample_minority(manifest.labels, 2, seed=cfg.seed)
        tr, va = stratified_split(manifest.labels[base], cfg.val_fraction, seed=cfg.seed)
        splits: Any = [(base[tr], base[va])]
        n_total = 1
        logger.info("holdout split: train %d / val %d (val_fraction %.2f)",
                    len(tr), len(va), cfg.val_fraction)
    else:
        splits = stratified_kfold(manifest.labels, cfg.num_folds, seed=cfg.fold_seed)
        n_total = cfg.num_folds
    if cfg.fold_parallel:
        from image_classification_tpu_torch.train.foldpar import train_k_fold_parallel

        return train_k_fold_parallel(cfg, list(splits), source, manifest, mesh,
                                     device=device, model_name=model_name,
                                     resume=resume)
    for fold, (train_idx, val_idx) in enumerate(splits, start=1):
        logger.info("fold %d/%d: train %d / val %d", fold, n_total,
                    len(train_idx), len(val_idx))
        try:
            train_loader, val_loader, train_labels = make_fold_loaders(
                cfg, source, manifest, train_idx, val_idx, device=device, mesh=mesh)
            class_counts = np.bincount(train_labels, minlength=cfg.num_classes)
            result = train_fold(cfg, train_loader, val_loader, fold=fold,
                                class_counts=class_counts, resume=resume,
                                model_name=model_name, mesh=mesh)
            results.append(result)
            logger.info("fold %d done: best val acc %.4f", fold, result.best_val_acc)
        except KeyboardInterrupt:
            raise
        except Exception:
            # the reference's per-fold tolerance, with the full trace logged
            logger.exception("fold %d failed; continuing", fold)
            continue
    return results


def train_ensemble(cfg, resume: bool = False, device: str | torch.device = "cuda",
                   mesh=None) -> tuple[list[FoldResult], list[float]]:
    """Multi-architecture ensemble training (JAX ``train_ensemble``): the
    full K-fold per member of ``cfg.ensemble_models`` (or ``model_name``
    alone), weights ``cfg.ensemble_weights`` (default 1 each); returns all
    fold results and one weight per result, its member's weight over
    ``max(1, the member's result count)``."""
    names = list(cfg.ensemble_models) or [cfg.model_name]
    arch_weights = list(cfg.ensemble_weights) or [1.0] * len(names)
    if len(arch_weights) != len(names):
        raise ValueError("ensemble_weights length must match ensemble_models")
    manifest = Manifest.from_csv(cfg.train_csv, num_classes=cfg.num_classes)
    source = primary_first(lambda: build_source(cfg, manifest, cfg.train_dir,
                                                decode_threads()))
    results: list[FoldResult] = []
    weights: list[float] = []
    for name, aw in zip(names, arch_weights):
        logger.info("ensemble member: %s (weight %.2f)", name, aw)
        arch_cfg = cfg.replace(model_name=name,
                               model_save_path=f"{cfg.model_save_path}/{name}",
                               output_dir=f"{cfg.output_dir}/{name}")
        arch_results = train_k_fold(arch_cfg, manifest=manifest, source=source,
                                    resume=resume, device=device, mesh=mesh)
        results.extend(arch_results)
        weights.extend([aw / max(1, len(arch_results))] * len(arch_results))
    return results, weights
