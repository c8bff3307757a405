"""Exact GELU with the Abramowitz & Stegun 7.1.26 erf, forward and backward.

Port of ``image_classification_tpu/ops/gelu.py:gelu_erf_free_pallas``. The
forward is ``0.5 * a * (1 + erf_AS(a / sqrt(2)))`` in f32 (one exp, a 5-term
polynomial, |erf error| <= 1.5e-7), stored in the input dtype. The backward
is ``dx = gelu'(x) * dy`` with the shared-exp gradient of
``image_classification_tpu/ops/block_mlp.py:_gelu_grad``: the A&S erf's
``exp(-x^2)`` at ``x = a / sqrt(2)`` is the Gaussian pdf's ``exp(-a^2 / 2)``,
so one exp serves both; f32 internals, stored in ``x``'s dtype.

``gelu`` is the op the model calls. When autograd records it, it runs as
:class:`_GeluFunction`, which saves ``x`` and whose backward is
:func:`gelu_bwd`. On a CPU tensor both directions run their plain PyTorch
versions (:func:`gelu_reference`, :func:`gelu_grad_reference`). On a CUDA
tensor they launch their kernels, or raise:

* the forward, ``ic_gelu_fwd`` in ``csrc/gelu.cu`` (CUDA C++), replaces
  ``image_classification_tpu/ops/gelu.py:_run_elementwise`` with
  ``_gelu_fwd_kernel``: a grid-stride pass over 16-byte vectors, its grid
  and cache policy chosen by whether x and y fit L2 (the note at the top
  of the source says why);
* the backward, the Triton kernel ``_gelu_bwd_kernel``, replaces
  ``_run_elementwise`` with ``_gelu_bwd_kernel``: one flat masked pass,
  1024 elements a program, f32 internals in registers.

Both are bound by device memory on the H100: the forward reads one tensor
and writes one against ~20 FLOP an element, the backward reads two (``x``,
``dy``) and writes one against ~25 FLOP.
"""

from __future__ import annotations

import functools
import math
import os

import torch

_SQRT_HALF = 0.7071067811865476
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_BLOCK = 1024


def _as_poly(t: torch.Tensor) -> torch.Tensor:
    return t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))


def erf_as(x: torch.Tensor) -> torch.Tensor:
    """A&S 7.1.26 erf in the input's dtype (call it on f32)."""
    ax = x.abs()
    return torch.sign(x) * (1.0 - _as_poly(1.0 / (1.0 + 0.3275911 * ax))
                            * torch.exp(-ax * ax))


def gelu_f32(a: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU of an f32 tensor, in f32."""
    return 0.5 * a * (1.0 + erf_as(a * _SQRT_HALF))


def gelu_grad_f32(a: torch.Tensor) -> torch.Tensor:
    """d/da of :func:`gelu_f32`, with one exp shared by the erf and the pdf."""
    x = a * _SQRT_HALF
    ax = x.abs()
    e = torch.exp(-ax * ax)
    erf = torch.sign(x) * (1.0 - _as_poly(1.0 / (1.0 + 0.3275911 * ax)) * e)
    return 0.5 * (1.0 + erf) + a * (_INV_SQRT_2PI * e)


def gelu_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: f32 internals, input dtype out."""
    return gelu_f32(x.float()).to(x.dtype)


def gelu_grad_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the backward: ``gelu'(x) * dy`` in f32,
    stored in ``x``'s dtype."""
    return (gelu_grad_f32(x.float()) * dy.float()).to(x.dtype)


@functools.cache
def _triton_bwd_kernel():
    from image_classification_tpu_torch.ops._build import BUILD_DIR

    # keep Triton's compiled kernels with the CUDA build, in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def _gelu_bwd_kernel(x_ptr, dy_ptr, dx_ptr, n, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        a = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        x = a * 0.7071067811865476
        ax = tl.abs(x)
        t = 1.0 / (1.0 + 0.3275911 * ax)
        poly = t * (0.254829592 + t * (-0.284496736 + t * (
            1.421413741 + t * (-1.453152027 + t * 1.061405429))))
        e = tl.exp(-ax * ax)  # = exp(-a^2 / 2), shared by erf and the pdf
        erf = 1.0 - poly * e
        erf = tl.where(x < 0.0, -erf, tl.where(x > 0.0, erf, 0.0))
        grad = 0.5 * (1.0 + erf) + a * (0.3989422804014327 * e)
        tl.store(dx_ptr + offs, (grad * dy).to(dx_ptr.dtype.element_ty),
                 mask=mask)

    return _gelu_bwd_kernel


def _check(name: str, *tensors: torch.Tensor) -> None:
    from image_classification_tpu_torch.ops._build import require_cuda

    require_cuda(name, *tensors)
    for t in tensors:
        if t.dtype != tensors[0].dtype or t.dtype not in (torch.float32,
                                                          torch.bfloat16):
            raise ValueError(f"{name}: needs one dtype, f32 or bf16, got "
                             f"{[u.dtype for u in tensors]}")


def _gelu_forward(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return gelu_reference(x)
    _check("gelu", x)
    from image_classification_tpu_torch.ops import _build

    n = x.numel()
    # y starts at x's offset from a 16-byte boundary (a fresh tensor's is
    # 0), so that the kernel's 16-byte vectors line up in both
    off = x.data_ptr() % 16 // x.element_size()
    y = (torch.empty(n + off, dtype=x.dtype, device=x.device)[off:].view(x.shape)
         if off else torch.empty_like(x))
    if n:
        with torch.cuda.device(x.device):
            code = _build.library().ic_gelu_fwd(
                x.data_ptr(), y.data_ptr(), n, _build.DTYPE_CODES[x.dtype],
                _build.stream_ptr(x))
        _build.check(code, "gelu")
        gelu.launches += 1
    return y


def gelu_bwd(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``gelu'(x) * dy`` in ``x``'s dtype; bf16 or f32 on CUDA."""
    if x.device.type == "cpu":
        return gelu_grad_reference(x, dy)
    if dy.shape != x.shape:
        raise ValueError(f"gelu_bwd: dy {tuple(dy.shape)} != x {tuple(x.shape)}")
    _check("gelu_bwd", x, dy)
    dx = torch.empty_like(x)
    n = x.numel()
    if n:
        with torch.cuda.device(x.device):
            _triton_bwd_kernel()[(-(-n // _BLOCK),)](
                x, dy, dx, n, BLOCK=_BLOCK, num_warps=4)
        gelu_bwd.launches += 1
    return dx


class _GeluFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _gelu_forward(x)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return gelu_bwd(x, dy.contiguous())


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU, any shape; bf16 or f32 on CUDA. Differentiable."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GeluFunction.apply(x)
    return _gelu_forward(x)


gelu.launches = 0
gelu_bwd.launches = 0
