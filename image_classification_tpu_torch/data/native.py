"""ctypes bindings for the host JPEG library: batch decode and encode.

Port of ``image_classification_tpu/data/native.py``, with the same
``decode_batch(paths, out, num_threads) -> ok mask`` contract, plus
:func:`encode_rgb`. The library is built by g++ at first use (never at
import) into ``image_classification_tpu_torch/_build/`` (listed in
``.gitignore``), keyed by a hash of its sources and flags, written under a
private name and renamed into place; one process a host builds (a file
lock) and the others load its library. Which library it wraps is picked
once, at build time, from what the host's toolchain offers, and never
changes at run time:

* ``libjpeg`` where ``jpeglib.h`` preprocesses: the repo's
  ``csrc/fastloader.cpp`` (a libjpeg thread pool with a bilinear resize),
  compiled unchanged from where it is, and ``csrc/jpeg_encode.cpp``. These
  decode to the JAX package's bytes and encode as ``cv2.imwrite`` does.
* ``nvjpeg`` where there is no ``jpeglib.h`` and the CUDA toolkit has
  ``nvjpeg.h``: ``csrc/nvjpeg_codec.cpp``, the same two entry points on
  nvJPEG, whose pixels differ from libjpeg's by a few grey levels.

A failed build raises with the compiler's output; there is no other decoder
behind this one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from image_classification_tpu_torch.utils.filelock import exclusive

PACKAGE_DIR = Path(__file__).resolve().parent.parent
REPO_CSRC = PACKAGE_DIR.parent / "csrc"
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX = "g++"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")


@dataclass(frozen=True)
class Recipe:
    """What the host library is built from, and its decode entry point."""

    name: str                   # "libjpeg" or "nvjpeg"
    sources: tuple[Path, ...]
    libs: tuple[str, ...]       # include paths and libraries, after the sources
    decode_symbol: str


def has_header(header: str) -> bool:
    """Whether ``#include <header>`` preprocesses with the host's g++."""
    probe = subprocess.run([CXX, "-x", "c++", "-E", "-"],
                           input=f"#include <cstdio>\n#include <{header}>\n",
                           capture_output=True, text=True)
    return probe.returncode == 0


@functools.cache
def recipe() -> Recipe:
    """The build this host gets: libjpeg if its header is there, else nvJPEG
    from the CUDA toolkit; raises when it has neither."""
    if has_header("jpeglib.h"):
        return Recipe("libjpeg", (REPO_CSRC / "fastloader.cpp", CSRC / "jpeg_encode.cpp"),
                      ("-ljpeg", "-lpthread"), "fastloader_decode_batch")
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and os.path.exists(os.path.join(CUDA_HOME, "include", "nvjpeg.h")):
        lib64 = os.path.join(CUDA_HOME, "lib64")
        return Recipe("nvjpeg", (CSRC / "nvjpeg_codec.cpp",),
                      ("-I", os.path.join(CUDA_HOME, "include"), "-L", lib64,
                       f"-Wl,-rpath,{lib64}", "-lnvjpeg", "-lcudart_static", "-ldl",
                       "-lrt", "-lpthread"),
                      "ic_nvjpeg_decode_batch")
    raise RuntimeError("no JPEG library to build on: g++ finds no jpeglib.h, and "
                       "no CUDA toolkit with include/nvjpeg.h was found")


def library_path(r: Recipe) -> Path:
    digest = hashlib.sha256(" ".join((CXX, *CXXFLAGS, *r.libs)).encode())
    for src in (*r.sources, *sorted(CSRC.glob("*.h"))):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libic_jpeg_{r.name}_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the host library if it is missing; returns (path, seconds)."""
    r = recipe()
    so = library_path(r)
    if so.exists():
        return so, 0.0
    # one build a host: the processes that wait load the first one's library
    with exclusive(BUILD_DIR / "build.lock"):
        if so.exists():
            return so, 0.0
        return so, _compile(r, so)


def _compile(r: Recipe, so: Path) -> float:
    """Build ``r`` into ``so``; returns the seconds spent."""
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run([CXX, *CXXFLAGS, "-o", f"{tmp}/lib.so",
                               *map(str, r.sources), *r.libs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build the {r.name} JPEG library:\n"
                               + proc.stdout + proc.stderr)
        os.replace(f"{tmp}/lib.so", so)
        return time.perf_counter() - t0


@functools.cache
def _library() -> tuple[ctypes.CDLL, object]:
    """The loaded library and its decode entry point (built on first call)."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    decode = getattr(lib, recipe().decode_symbol)
    decode.restype = ctypes.c_int
    decode.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                       ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    lib.ic_jpeg_encode_rgb.restype = ctypes.c_int
    lib.ic_jpeg_encode_rgb.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                                       ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ic_jpeg_lib_version.restype = ctypes.c_char_p
    lib.ic_jpeg_lib_version.argtypes = []
    return lib, decode


def lib_version() -> str:
    """The library the build wraps, e.g. ``libjpeg 62 (libjpeg-turbo
    2001005)`` or ``nvJPEG 12.4.0 (CUDA runtime 12080)``."""
    return _library()[0].ic_jpeg_lib_version().decode()


def decode_batch(paths: list[str | None], out: np.ndarray,
                 num_threads: int = 16) -> np.ndarray:
    """Decode JPEGs into ``out`` (N, H, W, 3) uint8 in place, resizing
    bilinearly where an image's size is not (H, W); returns a bool success
    mask. ``None`` marks a missing file; failed slots are zero-filled."""
    if (out.ndim != 4 or out.shape[3] != 3 or out.dtype != np.uint8
            or not out.flags["C_CONTIGUOUS"] or not out.flags["WRITEABLE"]):
        raise ValueError(f"out must be a writable C-contiguous uint8 (N, H, W, 3) "
                         f"array, got {out.dtype} {out.shape}")
    n, h, w, _ = out.shape
    if len(paths) != n:
        raise ValueError(f"{len(paths)} paths for {n} slots")
    _, decode = _library()
    arr = (ctypes.c_char_p * n)(*[None if p is None else os.fsencode(p) for p in paths])
    status = np.zeros(n, dtype=np.uint8)
    code = decode(arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
                  num_threads, status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if code < 0:
        raise RuntimeError(f"JPEG decode stopped with error {-code} "
                           "(1000 + nvjpegStatus_t, 2000 + cudaError_t)")
    return status.astype(bool)


def encode_rgb(path: str, rgb: np.ndarray, quality: int = 95) -> None:
    """Write ``rgb`` (H, W, 3) uint8 as a baseline JPEG at ``quality``, as
    ``cv2.imwrite(path, bgr, [IMWRITE_JPEG_QUALITY, quality])`` writes it
    (4:2:0 chroma, standard Huffman tables; 95 is cv2's default)."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.dtype != np.uint8:
        raise ValueError(f"rgb must be uint8 (H, W, 3), got {rgb.dtype} {rgb.shape}")
    if not 1 <= quality <= 100:
        raise ValueError(f"quality {quality} is not in [1, 100]")
    code = _library()[0].ic_jpeg_encode_rgb(
        os.fsencode(path), rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        rgb.shape[0], rgb.shape[1], quality)
    if code != 0:
        raise OSError(f"writing the JPEG {path} failed (code {code}: 1 the file, "
                      "2 the library)")
