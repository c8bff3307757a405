"""Bilinear warp with reflect-101 borders, the one resampling of the training
augmentation.

Port of ``image_classification_tpu/ops/warp.py:warp_pallas``: sample ``img``
``(B, H, W, C)`` (f32 or bf16, C <= 4) at per-pixel float coordinates
``coords_yx`` ``(B, Ho, Wo, 2)`` (f32, ``[y, x]``, not folded) into
``(B, Ho, Wo, C)`` in the image dtype. Each coordinate is folded into the
image with OpenCV's BORDER_REFLECT_101 in f32 (:func:`reflect101_coord`).

The rounding points are the Pallas kernel's, which contracts x first:

* the x-hats ``max(0, 1 - |x - w|)`` are computed in f32 and rounded to the
  image dtype;
* for each of the two source rows, the two products with the image are
  summed in f32;
* the y-hats stay f32, and the two row sums are weighted and summed in f32;
* one rounding to the image dtype at the end.

A hat is ``1 - |x - w|`` for ``w`` in ``{floor(x), floor(x) + 1}``; after the
fold a tap past the edge has weight 0 and is not read. In bf16 this is not
the 4-tap lerp of ``aug/geometry.py:bilinear_gather`` nor XLA's
``bilinear_gather_mxu_xfirst``, which round elsewhere and differ from the
Pallas kernel by up to 2-3 grey levels.

On a CPU tensor :func:`warp` runs :func:`warp_reference`, the same
arithmetic in PyTorch; on a CUDA tensor it launches ``csrc/warp.cu`` (see
the note at its top), or raises. The kernel has two paths, and
:func:`warp_staged` alone chooses between them: where the source image,
padded to 4 channels, fits in ``STAGE_MAX_BYTES`` of shared memory and the
batch's output is large enough to pay for copying it there (V3.1's 60x80
-> 224² at batch 128), a block stages it once and reads each tap from it;
elsewhere each tap is gathered from device memory. Both give the plain
version's bits.
"""

from __future__ import annotations

import torch

MAX_CHANNELS = 4
# The staged path (a block copies its source image into shared memory, each
# pixel padded to MAX_CHANNELS elements, and reads every tap from there)
# takes sources whose copy fits STAGE_MAX_BYTES: 112 KiB leaves room for two
# blocks in an H100 SM's 228 KiB. Each block copies the whole image, so the
# copy pays only where the batch's output is large against its source: at
# least STAGE_MIN_RATIO output pixels for each source pixel. On an H100
# (tools/time_gelu_warp.py --variants, bf16), staging won by 5% at V3.1's
# 128 x 224² outputs from 60x80 sources (1,338 to one) and lost 3% at the V2
# ensemble's 64 x 224² (669), 12% at V4's 32 x 260² (450) and 27% at V2's
# 64 x 60x80 (64).
STAGE_MAX_BYTES = 112 * 1024
STAGE_MIN_RATIO = 1000


def warp_staged(h: int, w: int, c: int, dtype: torch.dtype, out_pixels: int) -> bool:
    """Whether the kernel stages an (h, w, c) source image of ``dtype`` in
    shared memory for a batch of ``out_pixels`` output pixels in all (else
    it gathers each tap from device memory): its 4-channel texels, ``4 *
    itemsize`` bytes each, within STAGE_MAX_BYTES, and at least
    STAGE_MIN_RATIO output pixels for each source pixel."""
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"warp: {c} channels (1..{MAX_CHANNELS})")
    return (h * w * MAX_CHANNELS * dtype.itemsize <= STAGE_MAX_BYTES
            and out_pixels >= STAGE_MIN_RATIO * h * w)


def floor_mod(x: torch.Tensor, period: float) -> torch.Tensor:
    """``jnp.mod`` on floats (``period > 0``): ``fmod``, then ``+ period``
    where the remainder is negative. ``x - floor(x / p) * p`` rounds
    differently."""
    r = torch.fmod(x, period)
    return torch.where(r < 0, r + period, r)


def reflect101_coord(coord: torch.Tensor, n: int) -> torch.Tensor:
    """Fold float coordinates into ``[0, n - 1]`` with reflect-101 (the edge
    pixel is not repeated: ... 2 1 | 0 1 2 ... n-1 | n-2 ...)."""
    if n == 1:
        return torch.zeros_like(coord)
    period = 2 * n - 2
    m = floor_mod(coord, float(period))
    return torch.where(m > n - 1, period - m, m)


def _hat(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - (c - w).abs(), min=0.0)


def warp_reference(img: torch.Tensor, coords_yx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: four taps, with the kernel's rounding points."""
    B, H, W, C = img.shape
    Ho, Wo = coords_yx.shape[1:3]
    coords = coords_yx.float()
    y = reflect101_coord(coords[..., 0], H)
    x = reflect101_coord(coords[..., 1], W)
    y0, x0 = torch.floor(y), torch.floor(x)
    hx = [_hat(x, x0 + k).to(img.dtype).float().unsqueeze(-1) for k in (0, 1)]
    hy = [_hat(y, y0 + k).unsqueeze(-1) for k in (0, 1)]
    # a tap past the edge has weight 0: clamp its index, read anything
    yi = [(y0 + k).long().clamp(max=H - 1) for k in (0, 1)]
    xi = [(x0 + k).long().clamp(max=W - 1) for k in (0, 1)]
    flat = img.reshape(B, H * W, C).float()

    def tap(r, s):
        idx = (yi[r] * W + xi[s]).reshape(B, Ho * Wo, 1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(B, Ho, Wo, C)

    rows = [hx[0] * tap(r, 0) + hx[1] * tap(r, 1) for r in (0, 1)]
    return (hy[0] * rows[0] + hy[1] * rows[1]).to(img.dtype)


def warp(img: torch.Tensor, coords_yx: torch.Tensor) -> torch.Tensor:
    """The warp: ``(B, H, W, C)`` image at ``(B, Ho, Wo, 2)`` coordinates."""
    if img.dim() != 4 or coords_yx.dim() != 4 or coords_yx.shape[-1] != 2 \
            or coords_yx.shape[0] != img.shape[0]:
        raise ValueError(f"warp: img {tuple(img.shape)} needs (B,H,W,C) and "
                         f"coords {tuple(coords_yx.shape)} (B,Ho,Wo,2)")
    if img.device.type == "cpu":
        return warp_reference(img, coords_yx)
    from image_classification_tpu_torch.ops import _build

    B, H, W, C = img.shape
    Ho, Wo = coords_yx.shape[1:3]
    if img.dtype not in _build.DTYPE_CODES or coords_yx.dtype != torch.float32:
        raise ValueError(f"warp: needs an f32 or bf16 image and f32 coords, "
                         f"got {img.dtype} and {coords_yx.dtype}")
    if not 1 <= C <= MAX_CHANNELS or B > 65535 or H * W == 0:
        raise ValueError(f"warp: unsupported image shape {tuple(img.shape)} "
                         f"(1 <= C <= {MAX_CHANNELS}, B <= 65535)")
    _build.require_cuda("warp", img, coords_yx)
    if coords_yx.data_ptr() % 16:
        raise ValueError("warp: coords must be 16-byte aligned (read as float4)")
    out = torch.empty((B, Ho, Wo, C), dtype=img.dtype, device=img.device)
    if out.numel():
        with torch.cuda.device(img.device):
            code = _build.library().ic_warp(
                img.data_ptr(), coords_yx.data_ptr(), out.data_ptr(),
                B, H, W, C, Ho * Wo, _build.DTYPE_CODES[img.dtype],
                int(warp_staged(H, W, C, img.dtype, B * Ho * Wo)),
                _build.stream_ptr(img))
        _build.check(code, "warp")
        warp.launches += 1
    return out


warp.launches = 0
