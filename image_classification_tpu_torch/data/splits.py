"""Fold splits, port of ``image_classification_tpu/data/splits.py``.

The JAX package calls sklearn's ``StratifiedKFold(n_splits, shuffle=True,
random_state=seed)``; the machine the port runs on has no sklearn, so
:func:`stratified_kfold` reproduces that splitter in numpy, fold for fold and
index for index (``StratifiedKFold._make_test_folds``):

- classes are numbered by first appearance in ``labels``;
- each fold's count of each class is the ``bincount`` of every
  ``n_splits``-th entry of the sorted class numbers (round robin);
- per class, in class order, one ``np.random.RandomState(seed)`` shuffles
  the class's block of fold ids, which its samples take in index order;
- fold ``k`` tests the samples with fold id ``k`` and trains on the rest,
  both in index order.

``stratified_split`` (the holdout split, sklearn's ``train_test_split``) is
not ported: ``split_mode=holdout`` raises in ``train/kfold.py``.
"""

from __future__ import annotations

import warnings
from typing import Iterator

import numpy as np


def _test_folds(labels: np.ndarray, n_splits: int, seed: int) -> np.ndarray:
    y = np.asarray(labels)
    if y.ndim != 1:
        raise ValueError(f"labels must be 1-D, got shape {y.shape}")
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv.reshape(-1)]
    n_classes = len(y_idx)
    y_counts = np.bincount(y_encoded)
    if np.all(n_splits > y_counts):
        raise ValueError(
            "n_splits=%d cannot be greater than the"
            " number of members in each class." % (n_splits))
    if n_splits > y_counts.min():
        warnings.warn(
            "The least populated class in y has only %d"
            " members, which is less than n_splits=%d."
            % (y_counts.min(), n_splits), UserWarning)
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::n_splits], minlength=n_classes)
                             for i in range(n_splits)])
    rng = np.random.RandomState(seed)
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    return test_folds


def stratified_kfold(labels: np.ndarray, num_folds: int,
                     seed: int = 42) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yields (train_idx, val_idx) per fold, equal to sklearn's
    ``StratifiedKFold(num_folds, shuffle=True, random_state=seed)``."""
    n = len(labels)
    if num_folds < 2:
        raise ValueError(
            "k-fold cross-validation requires at least one train/test split "
            f"by setting n_splits=2 or more, got n_splits={num_folds}.")
    if num_folds > n:
        raise ValueError(
            f"Cannot have number of splits n_splits={num_folds} greater than "
            f"the number of samples: n_samples={n}.")
    folds = _test_folds(labels, num_folds, seed)
    indices = np.arange(n)
    for k in range(num_folds):
        test = folds == k
        yield indices[~test], indices[test]


def oversample_minority(labels: np.ndarray, min_samples: int,
                        seed: int = 42) -> np.ndarray:
    """Indices (the original order first, duplicates appended) such that
    every class present has at least ``min_samples`` entries; a class with
    fewer samples than its deficit is drawn with replacement."""
    rng = np.random.default_rng(seed)
    out = [np.arange(len(labels))]
    counts = np.bincount(labels)
    for cls in np.nonzero((counts > 0) & (counts < min_samples))[0]:
        cls_idx = np.nonzero(labels == cls)[0]
        need = min_samples - len(cls_idx)
        out.append(rng.choice(cls_idx, size=need, replace=need > len(cls_idx)))
    return np.concatenate(out)
