"""In-memory uint8 image sources, port of ``ArraySource`` in
``image_classification_tpu/data/source.py``.

JPEG decoding (cv2) is not ported yet: the machine the port targets has no
cv2. :func:`load_decode_cache` reads the decoded-image cache the JAX
package's ``ImageSource`` writes (``use_decode_cache=true``), keyed the same
way, so a test set decoded once by either package serves the port.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np


class ArraySource:
    """In-memory source over a pre-built uint8 array (N, H, W, 3)."""

    def __init__(self, images: np.ndarray):
        if images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError("images must be uint8 (N, H, W, 3)")
        self.images = images

    def __len__(self) -> int:
        return len(self.images)

    def get_batch(self, indices: np.ndarray) -> np.ndarray:
        return np.asarray(self.images[indices])


class CachedSource(ArraySource):
    """The decoded images of one decode cache; ``_cache_key()`` names that
    cache, as the JAX package's ``ImageSource`` does, so derived caches
    (the channel stats, ``data/stats.py``) are keyed the same way."""

    def __init__(self, images: np.ndarray, key: str):
        super().__init__(images)
        self.key = key

    def _cache_key(self) -> str:
        return self.key


def decode_cache_key(img_dir: str, ids, native_size: tuple[int, int]) -> str:
    """``ImageSource._cache_key`` of the JAX package."""
    hsh = hashlib.sha256()
    hsh.update(os.path.abspath(img_dir).encode())
    hsh.update(str(tuple(native_size)).encode())
    for id_ in ids:
        hsh.update(str(id_).encode())
        hsh.update(b"\0")
    return hsh.hexdigest()[:16]


def save_decode_cache(img_dir: str, ids, images: np.ndarray, cache_dir: str) -> str:
    """Write ``images`` (uint8 (N, H, W, 3), row i the image of ``ids[i]``)
    as the decode cache of ``ids`` under ``img_dir``, in the layout
    :func:`load_decode_cache` and the JAX package's ``ImageSource`` read
    (for data made in memory, such as a synthetic set); returns the key."""
    images = np.ascontiguousarray(images, dtype=np.uint8)
    if images.ndim != 4 or len(images) != len(ids):
        raise ValueError(f"images {images.shape} for {len(ids)} ids")
    key = decode_cache_key(img_dir, ids, images.shape[1:3])
    os.makedirs(cache_dir, exist_ok=True)
    images.tofile(os.path.join(cache_dir, f"imgs_{key}.u8"))
    with open(os.path.join(cache_dir, f"imgs_{key}.json"), "w") as f:
        json.dump({"shape": list(images.shape), "complete": True}, f)
    return key


def load_decode_cache(img_dir: str, ids, native_size: tuple[int, int],
                      cache_dir: str) -> CachedSource:
    """The decoded images of ``ids`` under ``img_dir``, memory-mapped from
    ``cache_dir``; raises FileNotFoundError when no complete cache exists."""
    key = decode_cache_key(img_dir, ids, native_size)
    shape = (len(ids), *native_size, 3)
    meta_path = os.path.join(cache_dir, f"imgs_{key}.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    if tuple(meta.get("shape", ())) != shape or not meta.get("complete"):
        raise FileNotFoundError(
            f"no complete decode cache for {img_dir} in {cache_dir} "
            f"(looked for {meta_path}). The port does not decode JPEGs yet: "
            "build the cache once with the JAX package (use_decode_cache=true)")
    data = np.memmap(os.path.join(cache_dir, f"imgs_{key}.u8"), dtype=np.uint8,
                     mode="r", shape=shape)
    return CachedSource(data, key)
