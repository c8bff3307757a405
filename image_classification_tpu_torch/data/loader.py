"""Batched loader, port of the single-process path of
``image_classification_tpu/data/loader.py``.

Each batch is a fancy-index into the uint8 source, over ``indices`` (rows of
the manifest; all of them by default) in the order the sampler gives for the
current epoch (:meth:`DataLoader.set_epoch`). With ``drop_last`` a short last
batch is dropped (the train loader); otherwise, with ``pad_last``, it is
padded with zero images (label 0, index -1) to the full batch size and
``mask`` marks the real rows. For a CUDA ``device`` (the default) the images,
labels and mask go through pinned host memory and a ``non_blocking`` copy on
the current stream, so no batch waits for the card. Batches are assembled on
the calling thread; the JAX package's background prefetch and its HBM image
cache (a workaround for a remote TPU's slow host link) are not ported.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch

from image_classification_tpu_torch.data.manifest import Manifest
from image_classification_tpu_torch.data.sampling import SequentialSampler


class DataLoader:
    """Yields dicts: image (B, H, W, 3) uint8, label (B,) int64 and mask
    (B,) bool on ``device``; index (B,) int64 (the manifest row, -1 on
    padding) on the host."""

    def __init__(self, source: Any, manifest: Manifest,
                 batch_size: int = 32, sampler: Any = None,
                 pad_last: bool = True, device: str | torch.device = "cuda",
                 indices: np.ndarray | None = None, drop_last: bool = False):
        self.source = source
        self.manifest = manifest
        self.indices = (np.asarray(indices) if indices is not None
                        else np.arange(len(manifest)))
        self.batch_size = batch_size
        self.sampler = sampler or SequentialSampler(len(self.indices))
        self.drop_last = drop_last
        self.pad_last = pad_last and not drop_last
        self.device = torch.device(device)
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.sampler.epoch_indices(0))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _selections(self) -> Iterator[np.ndarray]:
        order = self.sampler.epoch_indices(self.epoch)
        n = len(order)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            yield self.indices[order[start : start + self.batch_size]]

    def __iter__(self) -> Iterator[dict[str, Any]]:
        for idx in self._selections():
            images = self.source.get_batch(idx)
            labels = self.manifest.labels[idx]
            mask = np.ones(len(idx), dtype=bool)
            if len(idx) < self.batch_size and self.pad_last:
                pad = self.batch_size - len(idx)
                images = np.concatenate(
                    [images, np.zeros((pad,) + images.shape[1:], images.dtype)])
                labels = np.concatenate([labels, np.zeros(pad, labels.dtype)])
                mask = np.concatenate([mask, np.zeros(pad, bool)])
                idx = np.concatenate([idx, np.full(pad, -1)])
            yield {"image": self._to_device(images),
                   "label": self._to_device(labels), "mask": self._to_device(mask),
                   "index": idx.astype(np.int64)}

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def batch_ids(self) -> Iterator[np.ndarray]:
        """Ids per batch in epoch order (unpadded)."""
        for idx in self._selections():
            yield self.manifest.ids[idx]
