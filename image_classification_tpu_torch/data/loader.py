"""Sequential loader, port of the single-process path of
``image_classification_tpu/data/loader.py``.

Each batch is a fancy-index into the uint8 source; the last one is padded
with zero images (label 0) to the full batch size (``pad_last``) and ``mask``
marks the real rows. For a CUDA ``device`` (the default) the images go
through pinned host memory and a ``non_blocking`` copy on the current stream.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch

from image_classification_tpu_torch.data.manifest import Manifest
from image_classification_tpu_torch.data.sampling import SequentialSampler


class DataLoader:
    """Yields dicts: image (B, H, W, 3) uint8 and label (B,) int64 on
    ``device``, and mask (B,) bool on the host (False on padding rows)."""

    def __init__(self, source: Any, manifest: Manifest,
                 batch_size: int = 32, sampler: Any = None,
                 pad_last: bool = True, device: str | torch.device = "cuda"):
        self.source = source
        self.manifest = manifest
        self.batch_size = batch_size
        self.sampler = sampler or SequentialSampler(len(manifest))
        self.pad_last = pad_last
        self.device = torch.device(device)

    def __iter__(self) -> Iterator[dict[str, Any]]:
        order = self.sampler.epoch_indices(0)
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            images = self.source.get_batch(idx)
            labels = self.manifest.labels[idx]
            mask = np.ones(len(idx), dtype=bool)
            if len(idx) < self.batch_size and self.pad_last:
                pad = self.batch_size - len(idx)
                images = np.concatenate(
                    [images, np.zeros((pad,) + images.shape[1:], images.dtype)])
                labels = np.concatenate([labels, np.zeros(pad, labels.dtype)])
                mask = np.concatenate([mask, np.zeros(pad, bool)])
            yield {"image": self._to_device(images),
                   "label": self._to_device(labels), "mask": mask}

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def batch_ids(self) -> Iterator[np.ndarray]:
        """Ids per batch in order (unpadded)."""
        order = self.sampler.epoch_indices(0)
        for start in range(0, len(order), self.batch_size):
            yield self.manifest.ids[order[start : start + self.batch_size]]
