"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with its own ``nvcc``, all started
together, and the objects link into one shared library with a plain C
interface, loaded with ``ctypes``. The build runs on first use (never at
import), writes under ``image_classification_tpu_torch/_build/`` (listed in
``.gitignore``), and is keyed by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads in milliseconds. One process a
host builds (a file lock); the others wait and load its library. It needs
the CUDA toolkit; nothing here runs on a machine without it.

Pointer and stream arguments are ``ctypes.c_void_p``; each entry point that
launches returns ``cudaGetLastError()`` after its launches, and :func:`check`
raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from image_classification_tpu_torch.utils.filelock import exclusive

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# Must match csrc/common.cuh IcDtype.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
# name -> (argtypes, restype); entry points that launch return a CUDA error
# code, the others a size.
_SIGNATURES = {
    "ic_dwconv7x7_fwd": ([_P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    "ic_dwconv7x7_wgrad_segs": ([_I, _I, _I, _I], _I),
    "ic_dwconv7x7_wgrad_partials": ([_I, _I, _I, _I], _I),
    "ic_dwconv7x7_wgrad": ([_P] * 4 + [_I] * 6 + [_P], _I),
    "ic_block_mlp_fwd": ([_P] * 14 + [_I64, _I, _I, _F, _I, _P], _I),
    "ic_block_mlp_fc_bf16": ([_I] + [_P] * 7 + [_I64, _I, _I64, _P], _I),
    "ic_block_mlp_bwd_scratch": ([_I64, _I, _I, _I], _I64),
    "ic_block_mlp_bwd": ([_P] * 22 + [_I64, _I, _I, _F, _I, _P], _I),
    "ic_block_mlp_bwd_bf16_scratch": ([_I64, _I], _I64),
    "ic_block_mlp_bwd_bf16": ([_P] * 23 + [_I64, _I, _F, _P], _I),
    "ic_block_mlp_gemm_splits": ([_I64, _I, _I64], _I),
    "ic_block_mlp_gemm": ([_P] * 3 + [_I, _I, _I64, _I, _I64, _P], _I),
    "ic_warp": ([_P] * 3 + [_I] * 7 + [_P], _I),
    "ic_gelu_fwd": ([_P, _P, _I64, _I, _P], _I),
}


def _sources() -> list[Path]:
    return sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")])


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: nvcc is needed to build "
                           "the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libic_kernels_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library if it is missing; returns (path, seconds spent).
    One build a host: under ``torchrun`` the first rank to get here compiles
    while the others wait on the lock, then find the library and load it."""
    so = library_path()
    if so.exists():
        return so, 0.0
    with exclusive(BUILD_DIR / "build.lock"):
        if so.exists():
            return so, 0.0
        return so, _compile(so)


def _compile(so: Path) -> float:
    """Compile and link the library to ``so``; returns the seconds spent."""
    cu = [p for p in _sources() if p.suffix == ".cu"]
    # Private names, then a rename: a concurrent build or reader never sees a
    # half-written library.
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in cu]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(cu, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [src.name for src, p in zip(cu, procs) if p.returncode != 0]
        if not failed:
            link = subprocess.run(
                [_nvcc(), "-shared", "-o", f"{tmp}/lib.so", *map(str, objs)],
                capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            if link.returncode != 0:
                failed.append("link")
        seconds = time.perf_counter() - t0
        (BUILD_DIR / "build.log").write_text("".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n" + "".join(logs))
        os.replace(f"{tmp}/lib.so", so)
    return seconds


@functools.cache
def library() -> ctypes.CDLL:
    """The built and loaded kernel library (built on first call)."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    lib.ic_error_string.argtypes = [ctypes.c_int]
    lib.ic_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        msg = library().ic_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {[str(u.device) for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
