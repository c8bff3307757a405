# Frozen copy of image_classification_tpu_torch/aug/color.py for the benchmark's
# reference: the reference may not import the program it judges.
"""Photometric augmentation, batched and elementwise, port of
``image_classification_tpu/aug/color.py``: ColorJitter (torchvision
semantics: a random order of the four ops per sample, blend-based
brightness/contrast/saturation, HSV hue rotation) and OneOf{RGBShift,
HueSaturationValue, ToGray}, on float images in [0, 255].

The ops run in the images' dtype: each random factor is cast to it, as the
JAX code casts its draws, and every other constant is a Python scalar, which
keeps a bf16 tensor bf16. ``%`` on floats is :func:`floor_mod` (``jnp.mod``).
As in the JAX code, each jitter round computes the four ops for the whole
batch and selects per sample, so no step depends on a value on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.aug.draws import bernoulli, randint, uniform
from benchmark.reference.aug.warp import floor_mod

_GRAY_WEIGHTS = (0.299, 0.587, 0.114)


def rgb_to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma, keepdims: a dot over the channels, summed in f32 and
    rounded once to the image dtype, as XLA's dot does."""
    w0, w1, w2 = _GRAY_WEIGHTS
    x = img.float()
    return (x[..., 0:1] * w0 + x[..., 1:2] * w1 + x[..., 2:3] * w2).to(img.dtype)


def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """RGB [0, 255] -> H [0, 1), S [0, 1], V [0, 255]."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    safe = torch.where(delta > 0, delta, 1.0)
    s = torch.where(maxc > 0, delta / torch.where(maxc > 0, maxc, 1.0), 0.0)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, floor_mod(h / 6.0, 1.0), 0.0)
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(c0, c1, c2, c3, c4, c5):
        out = torch.where(i == 0, c0, c1)
        out = torch.where(i == 2, c2, out)
        out = torch.where(i == 3, c3, out)
        out = torch.where(i == 4, c4, out)
        return torch.where(i == 5, c5, out)

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


# --------------------------------------------------------------------------
# ColorJitter
# --------------------------------------------------------------------------

class ColorJitterCfg(NamedTuple):
    prob: float = 0.5
    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.2
    hue: float = 0.1


class ColorJitterDraws(NamedTuple):
    apply: torch.Tensor       # (B,) bool
    brightness: torch.Tensor  # (B, 1, 1, 1) U(max(0, 1 - b), 1 + b)
    contrast: torch.Tensor    # (B, 1, 1, 1)
    saturation: torch.Tensor  # (B, 1, 1, 1)
    hue: torch.Tensor         # (B, 1, 1) U(-hue, hue)
    order: torch.Tensor       # (B, 4) a permutation of the ops 0..3 per sample


def draw_color_jitter(gen, batch: int, cfg: ColorJitterCfg) -> ColorJitterDraws:
    def factor(amount):
        return uniform(gen, (batch, 1, 1, 1), max(0.0, 1 - amount), 1 + amount)

    return ColorJitterDraws(
        bernoulli(gen, cfg.prob, batch),
        factor(cfg.brightness), factor(cfg.contrast), factor(cfg.saturation),
        uniform(gen, (batch, 1, 1), -cfg.hue, cfg.hue),
        uniform(gen, (batch, 4)).argsort(dim=1))


def _adjust_contrast(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    mean = rgb_to_grayscale(img).mean(dim=(-3, -2, -1), keepdim=True)
    return mean + factor * (img - mean)


def _adjust_saturation(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    gray = rgb_to_grayscale(img)
    return gray + factor * (img - gray)


def _adjust_hue(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    hsv = rgb_to_hsv(img)
    h = floor_mod(hsv[..., 0] + shift, 1.0)
    return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


def color_jitter(images: torch.Tensor, d: ColorJitterDraws,
                 cfg: ColorJitterCfg) -> torch.Tensor:
    """Per-sample random factors and a random order of the four ops: each of
    the four rounds computes every op for the batch and keeps, per sample,
    the one its order names."""
    dt = images.dtype
    fb, fc, fs, fh = (t.to(dt) for t in (d.brightness, d.contrast,
                                         d.saturation, d.hue))
    x = images
    for step in range(4):
        op = d.order[:, step][:, None, None, None]
        x = torch.where(op == 0, x * fb,
                        torch.where(op == 1, _adjust_contrast(x, fc),
                                    torch.where(op == 2, _adjust_saturation(x, fs),
                                                _adjust_hue(x, fh))))
    x = torch.clamp(x, 0.0, 255.0)
    return torch.where(d.apply[:, None, None, None], x, images)


# --------------------------------------------------------------------------
# OneOf {RGBShift, HueSaturationValue, ToGray}
# --------------------------------------------------------------------------

class ColorShiftCfg(NamedTuple):
    prob: float = 0.3
    rgb_shift_limit: float = 20.0
    hsv_hue_limit: float = 20.0   # OpenCV hue units (2 degrees each)
    hsv_sat_limit: float = 30.0   # 0..255 scale
    hsv_val_limit: float = 20.0   # 0..255 scale


class ColorShiftDraws(NamedTuple):
    apply: torch.Tensor  # (B,) bool
    pick: torch.Tensor   # (B,) int: 0 RGBShift, 1 HSV, 2 ToGray
    rgb: torch.Tensor    # (B, 1, 1, 3) U(-rgb_shift_limit, rgb_shift_limit)
    hue: torch.Tensor    # (B, 1, 1) U(-hsv_hue_limit, hsv_hue_limit)
    sat: torch.Tensor    # (B, 1, 1)
    val: torch.Tensor    # (B, 1, 1)


def draw_color_shift(gen, batch: int, cfg: ColorShiftCfg) -> ColorShiftDraws:
    def symmetric(shape, limit):
        return uniform(gen, shape, -limit, limit)

    return ColorShiftDraws(
        bernoulli(gen, cfg.prob, batch),
        randint(gen, 0, 3, (batch,)),
        symmetric((batch, 1, 1, 3), cfg.rgb_shift_limit),
        symmetric((batch, 1, 1), cfg.hsv_hue_limit),
        symmetric((batch, 1, 1), cfg.hsv_sat_limit),
        symmetric((batch, 1, 1), cfg.hsv_val_limit))


def rgb_shift(images: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    return torch.clamp(images + shift.to(images.dtype), 0.0, 255.0)


def hue_saturation_value(images: torch.Tensor, d: ColorShiftDraws) -> torch.Tensor:
    """albumentations HueSaturationValue: hue shifts in OpenCV's 0..180 hue
    space (wrapping), saturation and value shift additively in 0..255."""
    hsv = rgb_to_hsv(images)
    dt = images.dtype
    h = floor_mod(hsv[..., 0] + (d.hue / 180.0).to(dt), 1.0)
    s = torch.clamp(hsv[..., 1] + (d.sat / 255.0).to(dt), 0.0, 1.0)
    v = torch.clamp(hsv[..., 2] + d.val.to(dt), 0.0, 255.0)
    return hsv_to_rgb(torch.stack([h, s, v], dim=-1))


def to_gray(images: torch.Tensor) -> torch.Tensor:
    return rgb_to_grayscale(images).expand(images.shape)


def color_shift_oneof(images: torch.Tensor, d: ColorShiftDraws,
                      cfg: ColorShiftCfg) -> torch.Tensor:
    pick = d.pick[:, None, None, None]
    sel = torch.where(pick == 0, rgb_shift(images, d.rgb),
                      torch.where(pick == 1, hue_saturation_value(images, d),
                                  to_gray(images)))
    return torch.where(d.apply[:, None, None, None], sel, images)
