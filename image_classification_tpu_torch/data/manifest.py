"""CSV manifests, port of ``image_classification_tpu/data/manifest.py``.

The machine the port runs on has no pandas, so ``Manifest.from_csv`` reads
with the ``csv`` module and reproduces what ``pd.read_csv(path)["id"]
.astype(str)`` gives: a column whose every value is an integer is parsed as
integers first (``"0007"`` becomes ``"7"``), a column of numbers as floats
(``"2.50"`` becomes ``"2.5"``), and any other column is kept as text. Empty
cells, which pandas keeps as NaN, are not supported.
"""

from __future__ import annotations

import csv
import os
import re
from dataclasses import dataclass
from typing import Sequence

import numpy as np

_INT = re.compile(r"^\s*[+-]?\d+\s*$")


def _float_or_none(v: str) -> float | None:
    try:
        return float(v)
    except ValueError:
        return None


def _pandas_str_column(values: list[str]) -> list[str]:
    if values and all(_INT.match(v) for v in values):
        return [str(int(v)) for v in values]
    floats = [_float_or_none(v) for v in values]
    if values and all(f is not None for f in floats):
        return [str(f) for f in floats]
    return values


@dataclass
class Manifest:
    """Immutable list of (id, label) pairs. ``labels`` is -1 for test sets."""

    ids: np.ndarray          # dtype=object (str)
    labels: np.ndarray       # int64; -1 where unknown (test)
    is_test: bool = False

    def __post_init__(self) -> None:
        self.ids = np.asarray(self.ids, dtype=object)
        self.labels = np.asarray(self.labels, dtype=np.int64)
        if len(self.ids) != len(self.labels):
            raise ValueError("ids and labels length mismatch")

    def __len__(self) -> int:
        return len(self.ids)

    @classmethod
    def from_csv(cls, path: str, is_test: bool = False,
                 num_classes: int | None = None) -> "Manifest":
        with open(path, newline="") as f:
            reader = csv.DictReader(f)
            rows = list(reader)
            columns = reader.fieldnames or []
        if "id" not in columns:
            raise ValueError(f"manifest missing 'id' column: {list(columns)}")
        ids = _pandas_str_column([r["id"] for r in rows])
        if not is_test and "target" in columns:
            labels = np.array([int(float(r["target"])) for r in rows], np.int64)
            if num_classes is not None:
                bad = (labels < 0) | (labels >= num_classes)
                if bad.any():
                    raise ValueError(f"labels out of range [0,{num_classes}): "
                                     f"{np.unique(labels[bad])}")
        else:
            labels = np.full(len(ids), -1, dtype=np.int64)
        return cls(ids=np.array(ids, dtype=object), labels=labels, is_test=is_test)

    def subset(self, indices: np.ndarray) -> "Manifest":
        return Manifest(self.ids[indices], self.labels[indices], self.is_test)


def write_csv(path: str, columns: dict[str, Sequence]) -> None:
    """Columns of equal length as a CSV, byte-identical to pandas'
    ``DataFrame(columns).to_csv(path, index=False)`` for text and integer
    values (minimal quoting, ``os.linesep``)."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator=os.linesep)
        writer.writerow(list(columns))
        writer.writerows(zip(*columns.values()))


def class_distribution(labels: np.ndarray, num_classes: int) -> np.ndarray:
    return np.bincount(labels[labels >= 0], minlength=num_classes)


def distribution_stats(labels: np.ndarray, num_classes: int) -> dict:
    counts = class_distribution(labels, num_classes)
    return {
        "num_samples": int(labels.shape[0]),
        "num_classes_present": int((counts > 0).sum()),
        "max": int(counts.max()),
        "min": int(counts.min()),
        "mean": float(counts.mean()),
        "median": float(np.median(counts)),
        "std": float(counts.std()),
    }


def verify_images(manifest: Manifest, img_dir: str,
                  extensions: tuple[str, ...] = (".jpg", ".jpeg", ".png")) -> list[str]:
    """Ids with no image file under ``img_dir``."""
    present = set(os.listdir(img_dir)) if os.path.isdir(img_dir) else set()
    return [str(id_) for id_ in manifest.ids
            if not any(f"{id_}{ext}" in present for ext in extensions)]
