"""The port's fold splits, samplers, manifest statistics and train loader
against sklearn and the JAX package, on the CPU. Everything here is host
numpy, so equality is exact: the same folds index for index, the same epoch
orders, the same batches."""

import warnings

import numpy as np
import pytest
import torch
from sklearn.model_selection import StratifiedKFold

from image_classification_tpu.data import DataLoader as JaxLoader
from image_classification_tpu.data import Manifest as JaxManifest
from image_classification_tpu.data import manifest as jax_manifest
from image_classification_tpu.data import sampling as jax_sampling
from image_classification_tpu.data import splits as jax_splits
from image_classification_tpu.data.source import ArraySource as JaxArraySource
from image_classification_tpu_torch.data import (
    ArraySource,
    DataLoader,
    Manifest,
    SequentialSampler,
    ShuffleSampler,
    WeightedSampler,
)
from image_classification_tpu_torch.data import manifest, sampling, splits
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse, module scope)


def long_tail(n_classes=44, n=256, seed=3):
    """Classes of 1 + a share proportional to 0.85^k of the rest: the tail
    has classes of one sample, as the real data has; shuffled."""
    share = 0.85 ** np.arange(n_classes)
    counts = 1 + np.floor((n - n_classes) * share / share.sum()).astype(int)
    counts[0] += n - counts.sum()
    labels = np.repeat(np.arange(n_classes), counts)
    return labels[np.random.default_rng(seed).permutation(n)]


LABEL_SETS = {
    "long_tail": long_tail(),
    # labels not numbered by first appearance, with a gap (class 3 absent)
    "balanced": np.random.default_rng(5).permutation(np.repeat([7, 0, 4, 2, 5, 1], 11)),
}


@pytest.mark.parametrize("labels", list(LABEL_SETS), ids=str)
@pytest.mark.parametrize("seed", [42, 0, 7])
@pytest.mark.parametrize("n_splits", [2, 3, 5])
def test_stratified_kfold_equals_sklearn(labels, seed, n_splits):
    y = LABEL_SETS[labels]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        theirs = list(StratifiedKFold(n_splits, shuffle=True, random_state=seed)
                      .split(np.zeros(len(y)), y))
        ours = list(splits.stratified_kfold(y, n_splits, seed=seed))
    assert len(ours) == n_splits
    for (tr, va), (jtr, jva) in zip(ours, theirs):
        np.testing.assert_array_equal(tr, jtr)
        np.testing.assert_array_equal(va, jva)
        assert tr.dtype == jtr.dtype and va.dtype == jva.dtype


def test_stratified_kfold_warns_and_raises_like_sklearn():
    y = LABEL_SETS["long_tail"]
    with pytest.warns(UserWarning) as theirs:
        list(StratifiedKFold(3, shuffle=True, random_state=42).split(np.zeros(len(y)), y))
    with pytest.warns(UserWarning) as ours:
        list(splits.stratified_kfold(y, 3, seed=42))
    assert [str(w.message) for w in ours] == [str(w.message) for w in theirs]
    tiny = np.array([0, 0, 1, 1, 2])
    for n_splits in (3, 6, 1):   # more than every class, than the samples, < 2
        with pytest.raises(ValueError) as theirs:
            list(StratifiedKFold(n_splits, shuffle=True, random_state=0)
                 .split(np.zeros(len(tiny)), tiny))
        with pytest.raises(ValueError) as ours:
            list(splits.stratified_kfold(tiny, n_splits, seed=0))
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("min_samples", [2, 5])
def test_oversample_minority_matches_jax(min_samples):
    y = LABEL_SETS["long_tail"]
    np.testing.assert_array_equal(splits.oversample_minority(y, min_samples, seed=3),
                                  jax_splits.oversample_minority(y, min_samples, seed=3))


def test_samplers_match_jax_per_epoch():
    y = LABEL_SETS["long_tail"]
    w = sampling.inverse_frequency_weights(y)
    np.testing.assert_array_equal(w, jax_sampling.inverse_frequency_weights(y))
    pairs = [(ShuffleSampler(len(y), seed=9), jax_sampling.ShuffleSampler(len(y), seed=9)),
             (WeightedSampler(w, seed=9), jax_sampling.WeightedSampler(w, seed=9)),
             (WeightedSampler(w, seed=1, num_samples=40),
              jax_sampling.WeightedSampler(w, seed=1, num_samples=40))]
    for ours, theirs in pairs:
        for epoch in range(4):
            np.testing.assert_array_equal(ours.epoch_indices(epoch),
                                          theirs.epoch_indices(epoch))


def test_distribution_stats_and_verify_images_match_jax(tmp_path):
    y = LABEL_SETS["balanced"]
    assert manifest.distribution_stats(y, 8) == jax_manifest.distribution_stats(y, 8)
    ids = np.array([f"{i:03d}" for i in range(6)], object)
    for i in (0, 2, 5):
        (tmp_path / f"{ids[i]}.jpg").write_bytes(b"")
    (tmp_path / f"{ids[3]}.png").write_bytes(b"")
    ours = manifest.verify_images(Manifest(ids, np.zeros(6)), str(tmp_path))
    theirs = jax_manifest.verify_images(JaxManifest(ids, np.zeros(6)), str(tmp_path))
    assert ours == theirs == ["001", "004"]


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_matches_jax(drop_last):
    rng = np.random.default_rng(11)
    n = 37
    images = rng.integers(0, 256, (n, 6, 5, 3), dtype=np.uint8)
    labels = rng.integers(0, 4, n)
    ids = np.array([str(i) for i in range(n)], object)
    idx = np.sort(rng.choice(n, 23, replace=False))
    ours = DataLoader(ArraySource(images), Manifest(ids, labels), indices=idx,
                      batch_size=5, sampler=ShuffleSampler(len(idx), seed=4),
                      drop_last=drop_last, device="cpu")
    theirs = JaxLoader(JaxArraySource(images), JaxManifest(ids, labels), indices=idx,
                       batch_size=5, sampler=jax_sampling.ShuffleSampler(len(idx), seed=4),
                       drop_last=drop_last, prefetch_depth=0)
    assert len(ours) == len(theirs) == (4 if drop_last else 5)
    for epoch in (0, 3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        a, b = list(ours), list(theirs)
        assert len(a) == len(b) == len(ours)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x["image"].numpy(), y["image"])
            np.testing.assert_array_equal(x["label"].numpy(), y["label"])
            np.testing.assert_array_equal(x["mask"].numpy(), y["mask"])
            np.testing.assert_array_equal(x["index"], y["index"])
        assert [list(i) for i in ours.batch_ids()] == [list(i) for i in theirs.batch_ids()]
    assert a[0]["image"].dtype == torch.uint8


def test_loader_batch_carries_mask_as_a_tensor():
    """``mask`` goes to the loader's device with the image and the label
    (on a card, through the same pinned non-blocking copy), so the eval
    step makes no host copy of it."""
    n = 7
    images = np.zeros((n, 4, 4, 3), np.uint8)
    loader = DataLoader(ArraySource(images), Manifest(np.array([str(i) for i in range(n)],
                                                               object), np.zeros(n, int)),
                        batch_size=4, sampler=SequentialSampler(n), device="cpu")
    masks = [b["mask"] for b in loader]
    assert all(isinstance(m, torch.Tensor) and m.dtype == torch.bool
               and m.device == loader.device for m in masks)
    assert [m.tolist() for m in masks] == [[True] * 4, [True] * 3 + [False]]
