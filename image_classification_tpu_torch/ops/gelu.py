"""Exact GELU with the Abramowitz & Stegun 7.1.26 erf.

Port of ``image_classification_tpu/ops/gelu.py`` (forward only). The math is
``0.5 * a * (1 + erf_AS(a / sqrt(2)))`` in f32 (one exp, a 5-term polynomial,
|erf error| <= 1.5e-7), stored in the input dtype.

``gelu`` is the op the model calls. On a CPU tensor it runs
:func:`gelu_reference`, the plain PyTorch version. On a CUDA tensor it
launches the Triton kernel below, or raises.

Triton kernel ``_gelu_kernel``:

* replaces ``image_classification_tpu/ops/gelu.py:_run_elementwise`` with
  ``_gelu_fwd_kernel`` (the forward Pallas kernel; ``_gelu_bwd_kernel`` is
  not ported yet);
* is bound by device memory on the H100: one read and one write per element
  against ~20 FLOP, at the slice's ``(256*81, 4096)`` stage-3 activation;
* does about that: one flat masked pass, 1024 elements a program, f32
  internals in registers, so the only traffic is the read and the write.
"""

from __future__ import annotations

import functools
import os

import torch

_SQRT_HALF = 0.7071067811865476
_BLOCK = 1024


def erf_as(x: torch.Tensor) -> torch.Tensor:
    """A&S 7.1.26 erf in the input's dtype (call it on f32)."""
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def gelu_f32(a: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU of an f32 tensor, in f32."""
    return 0.5 * a * (1.0 + erf_as(a * _SQRT_HALF))


def gelu_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: f32 internals, input dtype out."""
    return gelu_f32(x.float()).to(x.dtype)


@functools.cache
def _triton_kernel():
    from image_classification_tpu_torch.ops._build import BUILD_DIR

    # keep Triton's compiled kernels with the CUDA build, in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def _gelu_kernel(x_ptr, y_ptr, n, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        a = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        x = a * 0.7071067811865476
        ax = tl.abs(x)
        t = 1.0 / (1.0 + 0.3275911 * ax)
        poly = t * (0.254829592 + t * (-0.284496736 + t * (
            1.421413741 + t * (-1.453152027 + t * 1.061405429))))
        erf = 1.0 - poly * tl.exp(-ax * ax)
        erf = tl.where(x < 0.0, -erf, tl.where(x > 0.0, erf, 0.0))
        y = 0.5 * a * (1.0 + erf)
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    return _gelu_kernel


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU, any shape; bf16 or f32 on CUDA."""
    if x.device.type == "cpu":
        return gelu_reference(x)
    from image_classification_tpu_torch.ops._build import require_cuda

    require_cuda("gelu", x)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gelu: unsupported dtype {x.dtype}")
    y = torch.empty_like(x)
    n = x.numel()
    if n:
        with torch.cuda.device(x.device):
            _triton_kernel()[(-(-n // _BLOCK),)](
                x, y, n, BLOCK=_BLOCK, num_warps=4)
        gelu.launches += 1
    return y


gelu.launches = 0
