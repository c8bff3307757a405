"""Batched loader, port of ``image_classification_tpu/data/loader.py``.

Each batch is a fancy-index into the uint8 source, over ``indices`` (rows of
the manifest; all of them by default) in the order the sampler gives for the
current epoch (:meth:`DataLoader.set_epoch`). With ``drop_last`` a short last
batch is dropped (the train loader); otherwise, with ``pad_last``, it is
padded with zero images (label 0, index -1) to the full batch size and
``mask`` marks the real rows. With ``prefetch_depth > 0`` (2 by default, as in
the JAX package) a daemon thread assembles the batches that many ahead: the
fancy-index, the padding and, for a CUDA ``device``, ``pin_memory()``; an
exception there is raised in the consumer. The consumer's thread copies
each batch to the device (``non_blocking`` on its current stream), so no
batch waits for the card; while a profiler records, each hand-over (the
wait for a host batch and the enqueue of its copies) is the span
``loader.next`` (``utils/profiler.py:span``). The JAX package's HBM image
cache (a workaround for a remote TPU's slow host link) is not ported.

With ``process_count > 1`` (one rank of the data axis each, ``train/
kfold.py:make_fold_loaders``) every rank runs the same seeded sampler, so
the global epoch order is the same everywhere, and rank ``k`` takes rows
``[k*per, (k+1)*per)`` of each global batch of ``batch_size``; a ragged last
batch is padded to the global batch with ``mask=False`` rows (index -1), so
every rank's slice has the same shape.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import numpy as np
import torch

from image_classification_tpu_torch.data.manifest import Manifest
from image_classification_tpu_torch.data.sampling import SequentialSampler
from image_classification_tpu_torch.utils.profiler import span


class DataLoader:
    """Yields dicts: image (B, H, W, 3) uint8, label (B,) int64 and mask
    (B,) bool on ``device``; index (B,) int64 (the manifest row, -1 on
    padding) on the host."""

    def __init__(self, source: Any, manifest: Manifest,
                 batch_size: int = 32, sampler: Any = None,
                 pad_last: bool = True, device: str | torch.device = "cuda",
                 indices: np.ndarray | None = None, drop_last: bool = False,
                 prefetch_depth: int = 2, process_index: int = 0,
                 process_count: int = 1):
        self.source = source
        self.manifest = manifest
        self.indices = (np.asarray(indices) if indices is not None
                        else np.arange(len(manifest)))
        self.batch_size = batch_size
        self.sampler = sampler or SequentialSampler(len(self.indices))
        self.drop_last = drop_last
        self.pad_last = pad_last and not drop_last
        self.device = torch.device(device)
        self.prefetch_depth = prefetch_depth
        self.process_index = process_index
        self.process_count = process_count
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

    def _host_batches(self) -> Iterator[dict[str, Any]]:
        """Each batch as host tensors, pinned for a CUDA device."""
        if self.process_count > 1:
            yield from self._host_batches_multiprocess()
            return
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
            yield {"image": self._host(images), "label": self._host(labels),
                   "mask": self._host(mask), "index": idx.astype(np.int64)}

    def _host_batches_multiprocess(self) -> Iterator[dict[str, Any]]:
        """This rank's slice of each global batch (JAX's
        ``_batches_multihost``)."""
        k, h = self.process_index, self.process_count
        if self.batch_size % h != 0:
            raise ValueError(f"global batch {self.batch_size} not divisible by "
                             f"process count {h}")
        if not self.drop_last and not self.pad_last:
            raise ValueError("multi-process loading requires pad_last or drop_last")
        per = self.batch_size // h
        order = self.sampler.epoch_indices(self.epoch)
        n = len(order)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            sel = order[start : start + self.batch_size]
            rows = np.full(self.batch_size, -1, dtype=np.int64)
            rows[: len(sel)] = sel
            local = rows[k * per : (k + 1) * per]
            valid = local >= 0
            idx = np.where(valid, self.indices[np.maximum(local, 0)], -1)
            decoded = self.source.get_batch(idx[valid])
            images = np.zeros((per,) + decoded.shape[1:], decoded.dtype)
            images[valid] = decoded
            labels = np.zeros(per, self.manifest.labels.dtype)
            labels[valid] = self.manifest.labels[idx[valid]]
            yield {"image": self._host(images), "label": self._host(labels),
                   "mask": self._host(valid), "index": idx.astype(np.int64)}

    def __iter__(self) -> Iterator[dict[str, Any]]:
        it = self._host_batches()
        if self.prefetch_depth > 0:
            it = _background(it, self.prefetch_depth)
        while True:
            with span("loader.next"):
                batch = next(it, None)
                if batch is None:
                    return
                batch = {k: v if k == "index" else v.to(self.device, non_blocking=True)
                         for k, v in batch.items()}
            yield batch

    def _host(self, array: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(array))
        return t.pin_memory() if self.device.type == "cuda" else t

    def batch_ids(self) -> Iterator[np.ndarray]:
        """Ids per batch in epoch order (unpadded)."""
        for idx in self._selections():
            yield self.manifest.ids[idx]


def _background(it: Iterator, depth: int) -> Iterator:
    """Run ``it`` on a daemon thread, ``depth`` items ahead; an exception
    raised there is raised here. Closing this generator early stops the
    thread at its next item."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        try:
            for item in it:
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # re-raised in the consumer below
            put(e)

    threading.Thread(target=worker, daemon=True, name="DataLoader-prefetch").start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
