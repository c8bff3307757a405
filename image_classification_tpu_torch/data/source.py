"""Image sources: decode once, then serve uint8 batches from memory. Port of
``image_classification_tpu/data/source.py``.

:class:`ImageSource` decodes every image of a manifest once, through the
host JPEG library (``data/native.py``), into one uint8 (N, H, W, 3) array,
or, with ``cache_dir``, into the memory-mapped decode cache the JAX
package's ``ImageSource`` writes: the same ``imgs_{key}.u8`` file and
``{"shape", "complete"}`` JSON under the same key, so a cache either
package writes serves the other. Every later epoch's "IO" is a fancy-index.

Where the JAX package retries with cv2 each image its native decoder
rejects, the port has no second decoder:

* a missing file, a file the decoder rejects (not a JPEG, corrupt, or a
  JPEG with other than 1 or 3 components such as CMYK) get the fallback,
  ``"black"`` or ``"random"`` (one ``np.random.default_rng(0)`` drawn in
  index order over the failures);
* a PNG, recognised by its signature, raises ``NotImplementedError``.

:func:`save_decode_cache` writes a cache from images made in memory (a
synthetic set), and :func:`load_decode_cache` reads one without decoding.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os

import numpy as np

from image_classification_tpu_torch.data import native

logger = logging.getLogger("ic_tpu_torch")

_EXTENSIONS = (".jpg", ".jpeg", ".png")
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _resolve_path(img_dir: str, id_: str) -> str | None:
    for ext in _EXTENSIONS:
        p = os.path.join(img_dir, f"{id_}{ext}")
        if os.path.exists(p):
            return p
    return None


def _is_png(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(len(_PNG_SIGNATURE)) == _PNG_SIGNATURE
    except OSError:       # unreadable: the decoder's rejection stands
        return False


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


def _cache_paths(cache_dir: str, key: str) -> tuple[str, str]:
    return (os.path.join(cache_dir, f"imgs_{key}.u8"),
            os.path.join(cache_dir, f"imgs_{key}.json"))


def _complete_cache(meta_path: str, shape: tuple[int, ...]) -> bool:
    if not os.path.exists(meta_path):
        return False
    with open(meta_path) as f:
        meta = json.load(f)
    return tuple(meta.get("shape", ())) == shape and bool(meta.get("complete"))


class ImageSource(CachedSource):
    """Serves uint8 (B, H, W, 3) batches for an id list, decoded once.

    Build it over the whole manifest; fold subsets index into it. With
    ``cache_dir`` the decoded array persists in a memmap keyed by
    (directory, ids, native size), so later runs skip decoding."""

    def __init__(self, img_dir: str, ids, native_size: tuple[int, int] = (60, 80),
                 fallback: str = "black", cache_dir: str | None = None,
                 num_threads: int = 16):
        if fallback not in ("black", "random"):
            raise ValueError(f"unknown fallback {fallback!r}")
        self.img_dir = img_dir
        self.ids = np.asarray(ids, dtype=object)
        self.native_size = tuple(native_size)
        self.fallback = fallback
        self.num_threads = num_threads
        key = decode_cache_key(img_dir, self.ids, self.native_size)
        super().__init__(self._load_or_build(cache_dir, key), key)

    def _decode_all(self, out: np.ndarray) -> None:
        paths = [_resolve_path(self.img_dir, str(i)) for i in self.ids]
        ok = (native.decode_batch(paths, out, num_threads=self.num_threads)
              if len(paths) else np.zeros(0, bool))
        failed = np.nonzero(~ok)[0]
        pngs = [paths[i] for i in failed if paths[i] is not None and _is_png(paths[i])]
        if pngs:
            raise NotImplementedError(
                f"{len(pngs)} PNG files (first: {pngs[0]}): the port decodes JPEG "
                "only; convert them to JPEG")
        rng = np.random.default_rng(0)
        for i in failed:      # index order; the decoder left them zero
            if self.fallback == "random":
                out[i] = rng.integers(0, 256, size=out.shape[1:], dtype=np.uint8)
        n_missing = sum(paths[i] is None for i in failed)
        if n_missing:
            logger.warning("ImageSource: %d/%d images missing/unreadable",
                           n_missing, len(self.ids))
        rejected = [paths[i] for i in failed if paths[i] is not None]
        if rejected:
            logger.warning("ImageSource: the %s decoder rejected %d/%d images "
                           "(first: %s); the %s fallback stands in for them",
                           native.recipe().name, len(rejected), len(self.ids),
                           rejected[0], self.fallback)

    def _load_or_build(self, cache_dir: str | None, key: str) -> np.ndarray:
        shape = (len(self.ids), *self.native_size, 3)
        if cache_dir is None:
            data = np.empty(shape, dtype=np.uint8)
            self._decode_all(data)
            return data
        os.makedirs(cache_dir, exist_ok=True)
        bin_path, meta_path = _cache_paths(cache_dir, key)
        if _complete_cache(meta_path, shape):
            logger.info("ImageSource: reusing decode cache %s", bin_path)
            return np.memmap(bin_path, dtype=np.uint8, mode="r", shape=shape)
        data = np.memmap(bin_path, dtype=np.uint8, mode="w+", shape=shape)
        logger.info("ImageSource: decoding %d images -> %s", shape[0], bin_path)
        self._decode_all(data)
        data.flush()
        del data
        with open(meta_path, "w") as f:
            json.dump({"shape": shape, "complete": True}, f)
        return np.memmap(bin_path, dtype=np.uint8, mode="r", shape=shape)


def save_decode_cache(img_dir: str, ids, images: np.ndarray, cache_dir: str) -> str:
    """Write ``images`` (uint8 (N, H, W, 3), row i the image of ``ids[i]``)
    as the decode cache of ``ids`` under ``img_dir``, in the layout
    :class:`ImageSource`, :func:`load_decode_cache` and the JAX package's
    ``ImageSource`` read (for data made in memory, such as a synthetic set);
    returns the key."""
    images = np.ascontiguousarray(images, dtype=np.uint8)
    if images.ndim != 4 or len(images) != len(ids):
        raise ValueError(f"images {images.shape} for {len(ids)} ids")
    key = decode_cache_key(img_dir, ids, images.shape[1:3])
    os.makedirs(cache_dir, exist_ok=True)
    bin_path, meta_path = _cache_paths(cache_dir, key)
    images.tofile(bin_path)
    with open(meta_path, "w") as f:
        json.dump({"shape": list(images.shape), "complete": True}, f)
    return key


def load_decode_cache(img_dir: str, ids, native_size: tuple[int, int],
                      cache_dir: str) -> CachedSource:
    """The decoded images of ``ids`` under ``img_dir``, memory-mapped from
    ``cache_dir``; raises FileNotFoundError when no complete cache exists."""
    key = decode_cache_key(img_dir, ids, native_size)
    shape = (len(ids), *native_size, 3)
    bin_path, meta_path = _cache_paths(cache_dir, key)
    if not _complete_cache(meta_path, shape):
        raise FileNotFoundError(
            f"no complete decode cache for {img_dir} in {cache_dir} (looked for "
            f"{meta_path}); ImageSource with cache_dir builds one")
    return CachedSource(np.memmap(bin_path, dtype=np.uint8, mode="r", shape=shape), key)
