"""RandAugment (timm ``rand-m9-n3-mstd0.5``), port of
``image_classification_tpu/aug/randaug.py``.

Per sample, ``num_ops`` slots each hold one of the 15 ops of timm's standard
set, applied with probability 0.5 at magnitude ``clip(m + mstd * N(0, 1),
0, 10)`` with a random sign; one gate of probability ``prob`` turns the whole
block on or off for the sample. :func:`draw_rand_augment` makes those draws
on a ``torch.Generator``; :func:`apply_rand_augment` applies them slot by
slot and gives, per sample and slot, what the JAX code's ``jnp.where``
select over its 15 branches gives.

The five geometric ops (rotate, shear-x/y, translate-x/y) are reflect-101
bilinear warps. Each slot builds one 3x3 output->source matrix per sample,
the identity where the sample's op is not geometric, and resamples the whole
batch through it once: the warp kernel (``ops/warp.py``) on a CUDA tensor,
its plain version on a CPU tensor. With the identity every tap lands on an
integer coordinate, so the hats are exactly 1 and 0 (also after their
rounding to bf16), the kernel's sums add exact zeros, and each pixel comes
back with its own bits in f32 and in bf16. A batch thus launches the warp
``num_ops`` times here, against five gathers per slot in the JAX code.

The other ten ops are plain PyTorch on the tensor's device, computed for
the whole batch and selected per sample, so no step waits for the card.
They follow the JAX code, not PIL: equalize's LUT is ``(cdf - hist / 2) /
step`` with ``step = (total - hist[255]) / 255``, posterize and equalize
truncate to integers after a clip, autocontrast keeps a channel whose
maximum equals its minimum.

Dtype: the JAX code's magnitudes are f32, so in a bf16 pipeline its
branches promote the image to f32 after the first slot; the port casts each
factor to the image dtype, as ``aug/color.py`` does, and keeps the compute
dtype end to end. Thresholds (solarize) are compared in f32 on both sides.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from image_classification_tpu_torch.aug import color as color_ops
from image_classification_tpu_torch.aug.draws import randint, uniform
from image_classification_tpu_torch.aug.geometry import output_grid, sample_image


class RandAugmentCfg(NamedTuple):
    prob: float = 0.3       # gate for the whole block (V2 recipe)
    num_ops: int = 3        # n3
    magnitude: float = 9.0  # m9
    mag_std: float = 0.5    # mstd0.5


NUM_OPS = 15  # timm's _RAND_TRANSFORMS order, as the JAX branch list numbers it
OP_NAMES = ("autocontrast", "equalize", "invert", "rotate", "posterize",
            "solarize", "solarize_add", "saturation", "contrast", "brightness",
            "sharpness", "shear_x", "shear_y", "translate_x", "translate_y")
ROTATE, SHEAR_X, SHEAR_Y, TRANSLATE_X, TRANSLATE_Y = 3, 11, 12, 13, 14


class RandAugDraws(NamedTuple):
    gate: torch.Tensor     # (B,) bool, P(True) = prob
    op_ids: torch.Tensor   # (B, n) int in [0, 15)
    applies: torch.Tensor  # (B, n) bool, P(True) = 0.5
    mags: torch.Tensor     # (B, n) f32, clip(m + mstd * N(0, 1), 0, 10)
    signs: torch.Tensor    # (B, n) bool, True keeps the magnitude positive


def draw_rand_augment(gen: torch.Generator, batch: int,
                      cfg: RandAugmentCfg) -> RandAugDraws:
    n = cfg.num_ops
    normal = torch.randn((batch, n), generator=gen, device=gen.device)
    return RandAugDraws(
        uniform(gen, (batch,)) < cfg.prob,
        randint(gen, 0, NUM_OPS, (batch, n)),
        uniform(gen, (batch, n)) < 0.5,
        torch.clamp(cfg.magnitude + cfg.mag_std * normal, 0.0, 10.0),
        uniform(gen, (batch, n)) < 0.5)


# --------------------------------------------------------------------------
# the ten photometric ops, batched; per-sample parameters are (B, 1, 1, 1)
# --------------------------------------------------------------------------

def autocontrast(img: torch.Tensor) -> torch.Tensor:
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    scale = 255.0 / torch.clamp(hi - lo, min=1e-5)
    return torch.where(hi > lo, (img - lo) * scale, img)


def equalize(img: torch.Tensor) -> torch.Tensor:
    """Per-sample, per-channel histogram equalization through a 256-entry
    LUT; the histogram is a 256-bin ``scatter_add_`` per (sample, channel),
    whose f32 counts (at most H * W) are exact."""
    B, H, W, C = img.shape
    vals = torch.clamp(img, 0.0, 255.0).to(torch.int64)         # truncates
    base = torch.arange(B * C, device=img.device).reshape(B, 1, 1, C) * 256
    hist = torch.zeros(B * C * 256, dtype=torch.float32, device=img.device)
    hist.scatter_add_(0, (vals + base).reshape(-1),
                      torch.ones(vals.numel(), dtype=torch.float32, device=img.device))
    hist = hist.reshape(B * C, 256)
    cdf = torch.cumsum(hist, dim=1)
    step = (cdf[:, -1:] - hist[:, 255:]) / 255.0
    lut = torch.where(step > 0,
                      torch.clamp((cdf - hist / 2.0) / torch.clamp(step, min=1e-6),
                                  0.0, 255.0),
                      torch.arange(256, dtype=torch.float32, device=img.device))
    out = torch.gather(lut.reshape(-1), 0, (vals + base).reshape(-1))
    return out.reshape(B, H, W, C).to(img.dtype)


def posterize(img: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Keep the top ``bits`` (f32, in [0, 8]) bits of each truncated pixel."""
    shift = torch.clamp(8.0 - bits, 0.0, 8.0).to(torch.int32)
    vals = torch.clamp(img, 0.0, 255.0).to(torch.int32)
    return ((vals >> shift) << shift).to(img.dtype)


def solarize(img: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    return torch.where(img >= threshold, 255.0 - img, img)


def solarize_add(img: torch.Tensor, add: torch.Tensor) -> torch.Tensor:
    return torch.where(img < 128.0, torch.clamp(img + add, 0.0, 255.0), img)


@functools.cache
def _smooth_kernel(channels: int, dtype: torch.dtype, device) -> torch.Tensor:
    """PIL's SMOOTH kernel / 13 as (C, 1, 3, 3), made once per device: a
    copy from host memory waits for the card."""
    k = torch.tensor(((1.0, 1.0, 1.0), (1.0, 5.0, 1.0), (1.0, 1.0, 1.0)),
                     device=device) / 13.0
    return k.to(dtype).expand(channels, 1, 3, 3)


def sharpness(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """``blur + factor * (img - blur)``, the blur PIL's SMOOTH 3x3 kernel
    over an edge-padded image (one depthwise convolution for 3 channels)."""
    C = img.shape[-1]
    x = F.pad(img.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    blur = F.conv2d(x, _smooth_kernel(C, img.dtype, img.device), groups=C)
    blur = blur.permute(0, 2, 3, 1)
    return blur + factor * (img - blur)


# --------------------------------------------------------------------------
# the five geometric ops: one output->source matrix per sample
# --------------------------------------------------------------------------

def slot_matrix(op: torch.Tensor, signed: torch.Tensor, hw) -> torch.Tensor:
    """(B, 2, 3) f32 maps [x, y, 1] of an output pixel to its source: the
    op's matrix where ``op`` is geometric, else the identity. ``signed`` is
    the signed magnitude fraction in [-1, 1]."""
    H, W = hw
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    t = torch.deg2rad(signed * 30.0)
    c, s = torch.cos(t), torch.sin(t)
    one, zero = torch.ones_like(signed), torch.zeros_like(signed)
    shear, shift = signed * 0.3, signed * 0.45

    def pick(rotate, shear_x, shear_y, translate_x, translate_y, identity):
        out = torch.where(op == ROTATE, rotate, identity)
        out = torch.where(op == SHEAR_X, shear_x, out)
        out = torch.where(op == SHEAR_Y, shear_y, out)
        out = torch.where(op == TRANSLATE_X, translate_x, out)
        return torch.where(op == TRANSLATE_Y, translate_y, out)

    rows = (
        (pick(c, one, one, one, one, one),
         pick(s, shear, zero, zero, zero, zero),
         pick(cx - c * cx - s * cy, zero, zero, shift * W, zero, zero)),
        (pick(-s, zero, shear, zero, zero, zero),
         pick(c, one, one, one, one, one),
         pick(cy + s * cx - c * cy, zero, zero, zero, shift * H, zero)),
    )
    return torch.stack([torch.stack(list(r), -1) for r in rows], -2)


def affine_coords(mat: torch.Tensor, hw) -> torch.Tensor:
    """(B, H, W, 2) [y, x] source coordinates of each pixel of an (H, W)
    grid under ``mat`` (B, 2, 3): f32 products and sums written out
    elementwise (no TF32 matmul)."""
    grid = output_grid(*hw, mat.device)
    x, y = grid[None, ..., 0], grid[None, ..., 1]
    m = mat[..., None, None]
    src_x = m[:, 0, 0] * x + m[:, 0, 1] * y + m[:, 0, 2]
    src_y = m[:, 1, 0] * x + m[:, 1, 1] * y + m[:, 1, 2]
    return torch.stack([src_y, src_x], dim=-1)


def affine_warp(img: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Each sample of ``img`` (B, H, W, C) resampled at ``mat`` (B, 2, 3)
    applied to its own pixel grid, reflect-101 bilinear."""
    return sample_image(img.contiguous(), affine_coords(mat, img.shape[1:3]))


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------

def _photometric(x: torch.Tensor, frac: torch.Tensor,
                 signed: torch.Tensor) -> dict[int, torch.Tensor]:
    """Branches 0-2 and 4-10 for the whole batch, in x's dtype."""
    dt = x.dtype
    f = frac[:, None, None, None]
    factor = (1.0 + signed * 0.9)[:, None, None, None].to(dt)
    return {
        0: autocontrast(x),
        1: equalize(x),
        2: 255.0 - x,
        4: posterize(x, 4.0 - torch.floor(f * 4.0)),
        5: solarize(x, 256.0 * (1.0 - f)),
        6: solarize_add(x, (110.0 * f).to(dt)),
        7: torch.clamp(color_ops._adjust_saturation(x, factor), 0.0, 255.0),
        8: torch.clamp(color_ops._adjust_contrast(x, factor), 0.0, 255.0),
        9: torch.clamp(x * factor, 0.0, 255.0),
        10: torch.clamp(sharpness(x, factor), 0.0, 255.0),
    }


def apply_rand_augment(images: torch.Tensor, d: RandAugDraws,
                       cfg: RandAugmentCfg) -> torch.Tensor:
    """float (B, H, W, 3) in [0, 255] -> the same shape and dtype, from
    ready-made draws."""
    x = images
    hw = tuple(x.shape[1:3])
    for slot in range(cfg.num_ops):
        op = d.op_ids[:, slot]
        frac = d.mags[:, slot] / 10.0
        signed = torch.where(d.signs[:, slot], frac, -frac)
        out = affine_warp(x, slot_matrix(op, signed, hw))
        sel = op[:, None, None, None]
        for i, branch in _photometric(x, frac, signed).items():
            out = torch.where(sel == i, branch, out)
        on = (d.applies[:, slot] & d.gate)[:, None, None, None]
        x = torch.where(on, out, x)
    return x

