# Frozen copy of image_classification_tpu_torch/aug/filters.py for the benchmark's
# reference: the reference may not import the program it judges.
"""Noise and blur, OneOf{GaussNoise, GaussianBlur, MotionBlur}, port of
``image_classification_tpu/aug/filters.py``.

The two blurs and the identity are one per-sample 7x7 depthwise convolution
whose kernel is a delta (no blur), OpenCV's fixed Gaussian for ksize in
{3, 5, 7}, or a random-direction motion line. Gaussian noise adds per-pixel
N(0, sigma), sigma^2 ~ U(var_limit), drawn over the whole batch on the
generator's device and cast to the image dtype before the add.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from benchmark.reference.aug.draws import bernoulli, randint, uniform

MAX_K = 7

# OpenCV's fixed "small gaussian" 1-D kernels for ksize <= 7 with sigma=0
# (cv2.getGaussianKernel's small_gaussian_tab), zero-padded to MAX_K.
_CV2_SMALL_GAUSSIANS = (
    (0.0, 0.0, 0.25, 0.5, 0.25, 0.0, 0.0),                                  # k=3
    (0.0, 0.0625, 0.25, 0.375, 0.25, 0.0625, 0.0),                          # k=5
    (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),      # k=7
)


class NoiseBlurCfg(NamedTuple):
    prob: float = 0.3
    gauss_noise_var: tuple[float, float] = (10.0, 50.0)
    blur_limit: tuple[int, int] = (3, 7)


class NoiseBlurDraws(NamedTuple):
    apply: torch.Tensor  # (B,) bool
    pick: torch.Tensor   # (B,) int: 0 noise, 1 gaussian blur, 2 motion blur
    var: torch.Tensor    # (B, 1, 1, 1) U(gauss_noise_var)
    noise: torch.Tensor  # (B, H, W, C) f32 standard normal
    ksize: torch.Tensor  # (B,) odd in blur_limit
    theta: torch.Tensor  # (B, 1, 1) U(0, pi), the motion direction


def draw_noise_blur(gen, shape, cfg: NoiseBlurCfg) -> NoiseBlurDraws:
    """Draws for images of ``shape`` (B, H, W, C)."""
    B = shape[0]
    lo, hi = cfg.blur_limit
    return NoiseBlurDraws(
        bernoulli(gen, cfg.prob, B),
        randint(gen, 0, 3, (B,)),
        uniform(gen, (B, 1, 1, 1), *cfg.gauss_noise_var),
        torch.randn(tuple(shape), generator=gen, device=gen.device),
        lo + 2 * randint(gen, 0, (hi - lo) // 2 + 1, (B,)),
        uniform(gen, (B, 1, 1), 0.0, torch.pi))


@functools.cache
def _gaussian_table(device: torch.device) -> torch.Tensor:
    # made once per device: a copy from host memory waits for the card
    return torch.tensor(_CV2_SMALL_GAUSSIANS, dtype=torch.float32, device=device)


def gaussian_kernels(ksizes: torch.Tensor) -> torch.Tensor:
    """(B,) odd sizes in {3, 5, 7} -> (B, 7, 7), cv2.GaussianBlur(ksize,
    sigma=0)'s kernels."""
    idx = torch.clamp(torch.div(ksizes - 3, 2, rounding_mode="floor"), 0, 2)
    g1 = _gaussian_table(ksizes.device)[idx]
    return g1[:, :, None] * g1[:, None, :]


def motion_kernels(theta: torch.Tensor, ksizes: torch.Tensor) -> torch.Tensor:
    """(B, 1, 1) angles and (B,) odd sizes -> (B, 7, 7) line kernels: a 1 px
    wide, anti-aliased line of length k through the centre, normalised."""
    c = MAX_K // 2
    r = torch.arange(MAX_K, dtype=torch.float32, device=theta.device) - c
    ys, xs = r[None, :, None], r[None, None, :]
    dx, dy = torch.cos(theta), torch.sin(theta)
    perp = (xs * dy - ys * dx).abs()
    along = (xs * dx + ys * dy).abs()
    half = torch.div(ksizes - 1, 2, rounding_mode="floor").float()[:, None, None]
    w = torch.clamp(1.0 - perp, 0.0, 1.0) * (along <= half + 0.5)
    return w / w.sum(dim=(1, 2), keepdim=True)


def depthwise_conv_per_sample(images: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Each sample convolved with its own KxK kernel (all channels alike),
    reflect-101 padding, in the images' dtype: one grouped conv over the
    B*C planes. ``images`` (B, H, W, C), ``kernels`` (B, K, K)."""
    B, H, W, C = images.shape
    K = kernels.shape[-1]
    pad = K // 2
    x = images.permute(0, 3, 1, 2).reshape(1, B * C, H, W)
    x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    w = kernels.to(images.dtype).repeat_interleave(C, dim=0).unsqueeze(1)
    y = F.conv2d(x, w, groups=B * C)
    return y.reshape(B, C, H, W).permute(0, 2, 3, 1).contiguous()


def noise_blur_oneof(images: torch.Tensor, d: NoiseBlurDraws,
                     cfg: NoiseBlurCfg) -> torch.Tensor:
    noise = (d.noise * torch.sqrt(d.var)).to(images.dtype)
    use_noise = (d.apply & (d.pick == 0))[:, None, None, None]
    noised = torch.where(use_noise, images + noise, images)
    eye = torch.zeros((MAX_K, MAX_K), device=images.device)
    eye[MAX_K // 2, MAX_K // 2].fill_(1.0)   # a setitem would copy from the host
    use_gauss = (d.apply & (d.pick == 1))[:, None, None]
    use_motion = (d.apply & (d.pick == 2))[:, None, None]
    kernel = torch.where(use_gauss, gaussian_kernels(d.ksize),
                         torch.where(use_motion, motion_kernels(d.theta, d.ksize), eye))
    out = depthwise_conv_per_sample(noised, kernel)
    return torch.clamp(out, 0.0, 255.0)
