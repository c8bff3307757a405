"""Synthetic 44-class dataset for tests and smoke runs, port of
``image_classification_tpu/data/synthetic.py``.

Class-dependent structured images (a gradient, a per-class frequency
pattern, noise), 60x80 uint8 RGB with a long-tailed label distribution. The
numpy is the JAX package's, draw for draw; the JPEGs go through
``data/native.py:encode_rgb`` (cv2's default quality, 95) and the CSVs
through ``data/manifest.py:write_csv``.
"""

from __future__ import annotations

import os

import numpy as np

from image_classification_tpu_torch.data import native
from image_classification_tpu_torch.data.manifest import write_csv

DEFAULT_JPEG_QUALITY = 95   # cv2.imwrite's


def synthetic_images(labels: np.ndarray, native_size: tuple[int, int] = (60, 80),
                     seed: int = 0) -> np.ndarray:
    h, w = native_size
    rng = np.random.default_rng(seed)
    n = len(labels)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    images = np.empty((n, h, w, 3), dtype=np.uint8)
    for i, cls in enumerate(labels):
        phase = 2 * np.pi * cls / 44.0
        fx, fy = 1 + cls % 7, 1 + cls % 5
        base = (127 + 60 * np.sin(2 * np.pi * fx * xx / w + phase)
                + 60 * np.cos(2 * np.pi * fy * yy / h + phase))
        img = np.stack([base, np.roll(base, cls % h, axis=0),
                        np.roll(base, cls % w, axis=1)], axis=-1)
        img = img + rng.normal(0, 10, size=img.shape)
        images[i] = np.clip(img, 0, 255).astype(np.uint8)
    return images


def longtail_labels(n: int, num_classes: int = 44, seed: int = 0,
                    imbalance: float = 50.0) -> np.ndarray:
    """Long-tailed label draw (most-common / least-common ~= imbalance)."""
    rng = np.random.default_rng(seed)
    weights = np.exp(-np.log(imbalance) * np.arange(num_classes) / (num_classes - 1))
    p = weights / weights.sum()
    if n <= num_classes:
        return np.arange(num_classes)[:n].astype(np.int64)
    labels = rng.choice(num_classes, size=n - num_classes, p=p)
    # every class gets at least one sample
    return np.concatenate([np.arange(num_classes), labels]).astype(np.int64)


def write_jpegs(directory: str, ids, images: np.ndarray,
                quality: int = DEFAULT_JPEG_QUALITY) -> None:
    """``images[i]`` as ``directory/{ids[i]}.jpg``."""
    os.makedirs(directory, exist_ok=True)
    for id_, img in zip(ids, images):
        native.encode_rgb(os.path.join(directory, f"{id_}.jpg"), img, quality)


def make_synthetic_dataset(root: str, n_train: int = 200, n_test: int = 50,
                           num_classes: int = 44, native_size: tuple[int, int] = (60, 80),
                           seed: int = 0, write_images: bool = True) -> dict:
    """Train/test JPEG directories and CSVs in the reference's layout
    (train.csv: id,target; sample_submission.csv: id,predict)."""
    os.makedirs(root, exist_ok=True)
    train_dir = os.path.join(root, "train")
    test_dir = os.path.join(root, "test")
    labels = longtail_labels(n_train, num_classes, seed)
    test_labels = longtail_labels(n_test, num_classes, seed + 1)
    train_ids = [f"tr{i:05d}" for i in range(n_train)]
    test_ids = [f"te{i:05d}" for i in range(n_test)]
    if write_images:
        for ids, labs, d, s in ((train_ids, labels, train_dir, seed),
                                (test_ids, test_labels, test_dir, seed + 1)):
            os.makedirs(d, exist_ok=True)
            write_jpegs(d, ids, synthetic_images(labs, native_size, s))
    train_csv = os.path.join(root, "train.csv")
    test_csv = os.path.join(root, "sample_submission.csv")
    write_csv(train_csv, {"id": train_ids, "target": labels.tolist()})
    write_csv(test_csv, {"id": test_ids, "predict": [0] * n_test})
    return {"train_dir": train_dir, "test_dir": test_dir, "train_csv": train_csv,
            "test_csv": test_csv, "train_labels": labels, "test_labels": test_labels}
