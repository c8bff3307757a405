"""7x7 depthwise convolution, SAME, no bias, channels-last; forward and
backward.

Port of ``image_classification_tpu/ops/dwconv.py:depthwise_conv7x7`` and its
custom VJP. ``x`` is ``(B, H, W, C)`` and ``w`` is ``(7, 7, C)``.

* Forward (``_conv_same_pallas``): ``w`` is cast to ``x``'s dtype, taps
  accumulate in f32, the result is stored in ``x``'s dtype.
* Backward (``_bwd_pallas``): ``dx`` is the stencil of ``g`` with the
  spatially flipped filter, summed in f32 and stored in ``x``'s dtype;
  ``dw[i, j, c] = sum over b, h, w of x[b, h+i-3, w+j-3, c] * g[b, h, w, c]``,
  each product taken in ``x``'s dtype (as the Pallas kernel multiplies its
  tiles) and summed in f32.

As in ``_dwconv_bwd``, the gradient of ``w`` is returned rounded to the
dtype ``w`` was cast to before the op (bf16 in training), and the cast's own
gradient brings it back to the parameter's f32: :func:`depthwise_conv7x7`
casts ``w`` outside :class:`_DwconvFunction`, where autograd sees it. The
conv bias is added by the caller (``models/convnext.py``), as in
``models/layers.py:PallasDWConv``.

The backward computes ``_bwd_pallas``'s function at every shape as two
kernels: ``dx`` is the forward conv of ``g`` with the flipped filter and
``dw`` comes from the wgrad-only :func:`depthwise_conv7x7_wgrad`. The JAX
package fuses both into one pass where its VMEM estimate of an image allows;
on the H100 the backward is bound by its FP32 operations (4 x 49 FLOP an
element), not by bytes, so fusing saves only one read of ``g``, while one
thread would have to hold the 49 taps, the 49 dw sums and its dx sums at
once. Split, each kernel keeps its own register budget, and the pair beats
both the fused kernel and cuDNN's backward at every ConvNeXt-B and
ConvNeXt-L stage (``tools/time_dwconv.py``). ``dx`` has the fused kernel's
bits (both round the same f32 tap sums once) and ``dw`` sums the same
rounded products in another order.

On a CPU tensor the wrappers run the plain versions
(:func:`depthwise_conv7x7_reference`, :func:`depthwise_conv7x7_wgrad_reference`,
:func:`depthwise_conv7x7_bwd_reference`); on a CUDA tensor they launch the
hand-written kernels of ``csrc/dwconv7x7_fwd_wgrad.cu``, the forward stencil
and the wgrad-only kernel, or raise (see the note at its top).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

K = 7
PAD = K // 2


def depthwise_conv7x7_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: an f32 grouped conv, rounded to x's dtype."""
    c = x.shape[-1]
    wf = w.to(x.dtype).float().permute(2, 0, 1).unsqueeze(1)     # (C, 1, 7, 7)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), wf, padding=PAD, groups=c)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def depthwise_conv7x7_bwd_reference(x: torch.Tensor, g: torch.Tensor,
                                    w: torch.Tensor):
    """Plain PyTorch version of the backward: ``(dx, dw)``, ``dx`` in x's
    dtype and ``dw`` ``(7, 7, C)`` in f32, with the kernel's rounding points."""
    dx = depthwise_conv7x7_reference(g.to(x.dtype), w.flip(0, 1))
    return dx, depthwise_conv7x7_wgrad_reference(x, g)


def depthwise_conv7x7_wgrad_reference(x: torch.Tensor,
                                      g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the wgrad: ``dw`` (7, 7, C) f32, each product
    taken in x's dtype and summed in f32."""
    B, H, W, C = x.shape
    xp = F.pad(x, (0, 0, PAD, PAD, PAD, PAD))
    g = g.to(x.dtype)
    return torch.stack([
        torch.stack([(xp[:, i:i + H, j:j + W, :] * g).float().sum((0, 1, 2))
                     for j in range(K)])
        for i in range(K)])


def _check(name: str, x: torch.Tensor, w: torch.Tensor | None = None):
    from image_classification_tpu_torch.ops import _build

    if x.dim() != 4 or (w is not None and tuple(w.shape) != (K, K, x.shape[-1])):
        raise ValueError(f"{name}: x {tuple(x.shape)} needs (B,H,W,C), "
                         f"w {tuple(w.shape)} needs (7,7,C)")
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {x.dtype}")
    if -(-x.shape[-1] // 32) > 65535:
        raise ValueError(f"{name}: grid too large for {tuple(x.shape)}")
    return _build


def _dwconv_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return depthwise_conv7x7_reference(x, w)
    _build = _check("depthwise_conv7x7", x, w)
    w = w.to(x.dtype).contiguous()
    _build.require_cuda("depthwise_conv7x7", x, w)
    B, H, W, C = x.shape
    y = torch.empty_like(x)
    if y.numel():
        with torch.cuda.device(x.device):
            code = _build.library().ic_dwconv7x7_fwd(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), B, H, W, C,
                _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x))
        _build.check(code, "depthwise_conv7x7")
        depthwise_conv7x7.launches += 1
    return y


def _check_g(name: str, x: torch.Tensor, g: torch.Tensor) -> None:
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"{name}: g {tuple(g.shape)} {g.dtype} must match "
                         f"x {tuple(x.shape)} {x.dtype}")


def depthwise_conv7x7_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dw`` (7, 7, C) f32 of the conv at ``x`` for the output gradient
    ``g``, alone (``_wgrad_pallas``; the backward's dw)."""
    if x.device.type == "cpu":
        return depthwise_conv7x7_wgrad_reference(x, g)
    B, H, W, C = x.shape
    _build = _check("depthwise_conv7x7_wgrad", x)
    _check_g("depthwise_conv7x7_wgrad", x, g)
    _build.require_cuda("depthwise_conv7x7_wgrad", x, g)
    if not x.numel():
        return torch.zeros((K, K, C), dtype=torch.float32, device=x.device)
    dw = torch.empty((K, K, C), dtype=torch.float32, device=x.device)
    lib = _build.library()
    segs = lib.ic_dwconv7x7_wgrad_segs(B, H, W, C)
    partial = torch.empty((lib.ic_dwconv7x7_wgrad_partials(B, H, W, segs),
                           K * K, C), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.ic_dwconv7x7_wgrad(
            x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(),
            segs, B, H, W, C, _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x))
    _build.check(code, "depthwise_conv7x7_wgrad")
    depthwise_conv7x7_wgrad.launches += 1
    return dw


def depthwise_conv7x7_bwd(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor):
    """``(dx, dw)`` of the conv at ``x`` for the output gradient ``g``:
    ``dx`` like ``x``, ``dw`` ``(7, 7, C)`` f32 (not yet rounded to ``w``'s
    dtype). ``dx`` is the forward conv of ``g`` with the flipped filter and
    ``dw`` :func:`depthwise_conv7x7_wgrad`; each kernel counts its own
    launches, and this wrapper counts the backwards it ran on the card."""
    _check_g("depthwise_conv7x7_bwd", x, g)
    dx = _dwconv_forward(g, w.to(x.dtype).flip(0, 1).contiguous())
    dw = depthwise_conv7x7_wgrad(x, g)
    if x.device.type == "cuda":
        depthwise_conv7x7_bwd.launches += 1
    return dx, dw


class _DwconvFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _dwconv_forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = depthwise_conv7x7_bwd(x, g.contiguous(), w)
        return dx, dw.to(w.dtype)


def depthwise_conv7x7(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The conv, differentiable in ``x`` and ``w``."""
    w = w.to(x.dtype)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _DwconvFunction.apply(x, w)
    return _dwconv_forward(x, w)


depthwise_conv7x7.launches = 0
depthwise_conv7x7_bwd.launches = 0
depthwise_conv7x7_wgrad.launches = 0
