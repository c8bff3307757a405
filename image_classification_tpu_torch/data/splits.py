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

:func:`stratified_split` (the holdout split) reproduces sklearn's
``train_test_split(idx, test_size=val_fraction, stratify=labels,
random_state=seed)``, which is ``StratifiedShuffleSplit`` with one split
(``_iter_indices``):

- ``n_test = ceil(val_fraction * n)``, ``n_train = n - n_test``;
- classes are numbered in sorted order, each class's indices in index order;
- one ``np.random.RandomState(seed)`` draws, in this order: the train count
  of each class (``_approximate_mode``: the floors of the proportional
  shares, then the largest remainders, ties broken by ``rng.choice``), the
  test counts from what is left the same way, one permutation per class
  (its first ``n_train`` go to train, the next ``n_test`` to test), then a
  permutation of each side, which the sort at the end undoes.
"""

from __future__ import annotations

import math
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


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """sklearn's ``utils.extmath._approximate_mode``: per class, the floor
    of its share of ``n_draws``, then one more for the largest remainders
    until the draws are used up, ties broken at random."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_split(labels: np.ndarray, val_fraction: float = 0.1,
                     seed: int = 42) -> tuple[np.ndarray, np.ndarray]:
    """(train_idx, val_idx), each sorted, equal to sklearn's stratified
    ``train_test_split`` of ``arange(len(labels))`` with ``test_size =
    val_fraction`` and ``random_state = seed``. Raises ValueError where
    sklearn does: a class with one member, or fewer train or test places
    than classes."""
    y = np.asarray(labels)
    n = len(y)
    if not 0 < val_fraction < 1:
        raise ValueError(f"test_size={val_fraction} should be either positive and "
                         f"smaller than the number of samples {n} or a float in "
                         "the (0, 1) range")
    n_test = math.ceil(val_fraction * n)
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(f"With n_samples={n}, test_size={val_fraction} and "
                         "train_size=None, the resulting train set will be empty.")
    classes, y_indices, class_counts = np.unique(y, return_inverse=True,
                                                 return_counts=True)
    if np.min(class_counts) < 2:
        raise ValueError("The least populated classes in y have only 1 member, "
                         "which is too few. Classes with too few members are: "
                         f"{classes[class_counts < 2].tolist()}")
    if n_train < len(classes):
        raise ValueError(f"The train_size = {n_train} should be greater or equal "
                         f"to the number of classes = {len(classes)}")
    if n_test < len(classes):
        raise ValueError(f"The test_size = {n_test} should be greater or equal "
                         f"to the number of classes = {len(classes)}")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train: list[int] = []
    test: list[int] = []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    train, test = rng.permutation(train), rng.permutation(test)
    return np.sort(train), np.sort(test)


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
