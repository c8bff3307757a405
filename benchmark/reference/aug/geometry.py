# Frozen copy of image_classification_tpu_torch/aug/geometry.py for the benchmark's
# reference: the reference may not import the program it judges.
"""Geometric augmentation as one fused batched warp, port of
``image_classification_tpu/aug/geometry.py``.

RandomResizedCrop -> H/V flip -> ShiftScaleRotate -> OneOf{optical, grid,
elastic} distortion compose into one per-sample map

    src(p) = T @ (p + d(p)),   T = RRC . flip . SSR^-1   (3x3 affine)

and one bilinear sample from the native-resolution image with reflect-101
borders (:func:`sample_image`, the hand-written warp kernel on a CUDA
tensor, its plain version on a CPU tensor).

Each random op is a ``draw_*`` step and an apply step (``aug/draws.py``);
the draws hold uniforms already scaled to their ranges. The JAX code draws
all three distortion maps for every sample, then selects: so does this one. All
geometry is f32 whatever the image dtype; products of the 3x3 matrices and
the per-pixel coordinates are written out elementwise, so no TF32 matmul
touches them on a card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from benchmark.reference.aug.draws import bernoulli, randint, uniform
from benchmark.reference.aug.warp import reflect101_coord, warp

RRC_ATTEMPTS = 10


# --------------------------------------------------------------------------
# sampling primitives
# --------------------------------------------------------------------------

def reflect101_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Fold integer indices into [0, n-1] with OpenCV BORDER_REFLECT_101."""
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * n - 2
    m = torch.remainder(idx, period)
    return torch.where(m > n - 1, period - m, m)


def bilinear_gather(img: torch.Tensor, coords_yx: torch.Tensor) -> torch.Tensor:
    """The 4-tap lerp form of the JAX module (a reference only; the train
    path samples through :func:`sample_image`)."""
    B, H, W, C = img.shape
    Ho, Wo = coords_yx.shape[1:3]
    y, x = coords_yx[..., 0], coords_yx[..., 1]
    wdt = img.dtype if img.is_floating_point() else torch.float32
    y0, x0 = torch.floor(y), torch.floor(x)
    wy = (y - y0).unsqueeze(-1).to(wdt)
    wx = (x - x0).unsqueeze(-1).to(wdt)
    y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
    flat = img.reshape(B, H * W, C)

    def tap(yi, xi):
        idx = (reflect101_index(yi, H) * W + reflect101_index(xi, W))
        idx = idx.reshape(B, Ho * Wo, 1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(B, Ho, Wo, C)

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def sample_image(img: torch.Tensor, coords_yx: torch.Tensor) -> torch.Tensor:
    """Bilinear reflect-101 sample of ``img`` at ``coords_yx``: the warp
    kernel on a CUDA tensor, its plain version on a CPU tensor. (The JAX
    package's ``warp_impl`` chose between XLA forms and Pallas; the port's
    Config keeps the key, which selects nothing.)"""
    return warp(img, coords_yx)


def output_grid(h: int, w: int, device=None) -> torch.Tensor:
    """(h, w, 2) [x, y] pixel-centre coordinates, f32."""
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return torch.stack([xs, ys], dim=-1)


def _affine(rows) -> torch.Tensor:
    """Stack [[a, b, c], [d, e, f]] of (B,) tensors into (B, 3, 3) with the
    row [0, 0, 1]."""
    zeros = torch.zeros_like(rows[0][0])
    ones = torch.ones_like(zeros)
    rows = (*rows, (zeros, zeros, ones))
    return torch.stack([torch.stack(list(r), -1) for r in rows], -2)


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 product in f32, elementwise."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def _inverse3(m: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 inverse by the adjugate (no solver, no sync)."""
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    g, h, i = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    co = [e * i - f * h, f * g - d * i, d * h - e * g]
    det = a * co[0] + b * co[1] + c * co[2]
    adj = torch.stack([
        torch.stack([co[0], c * h - b * i, b * f - c * e], -1),
        torch.stack([co[1], a * i - c * g, c * d - a * f], -1),
        torch.stack([co[2], b * g - a * h, a * e - b * d], -1),
    ], -2)
    return adj / det[:, None, None]


# --------------------------------------------------------------------------
# per-stage affine factors (all matrices act on [x, y, 1])
# --------------------------------------------------------------------------

class RRCDraws(NamedTuple):
    area: torch.Tensor       # (B, 10) area fraction ~ U(scale)
    log_ratio: torch.Tensor  # (B, 10) ~ U(log ratio)
    ux: torch.Tensor         # (B,) U(0, 1)
    uy: torch.Tensor         # (B,)


def draw_random_resized_crop(gen, batch: int, scale, ratio) -> RRCDraws:
    return RRCDraws(
        uniform(gen, (batch, RRC_ATTEMPTS), scale[0], scale[1]),
        uniform(gen, (batch, RRC_ATTEMPTS), math.log(ratio[0]), math.log(ratio[1])),
        uniform(gen, (batch,)), uniform(gen, (batch,)))


def random_resized_crop_matrix(d: RRCDraws, native_hw, out_hw, ratio) -> torch.Tensor:
    """Per-sample affine mapping output pixel coords -> native crop coords:
    the first of the attempts whose crop fits wins, else the largest centred
    crop with the aspect clamped."""
    H, W = native_hw
    Ho, Wo = out_hw
    area = d.area * (H * W)
    r = torch.exp(d.log_ratio)
    w = torch.sqrt(area * r)
    h = torch.sqrt(area / r)
    ok = (w <= W) & (h <= H)
    first = ok.to(torch.int32).argmax(dim=1, keepdim=True)   # first True
    any_ok = ok.any(dim=1)
    w = torch.gather(w, 1, first)[:, 0]
    h = torch.gather(h, 1, first)[:, 0]
    in_ratio = W / H
    fb_w = W if in_ratio < ratio[0] else (H * ratio[1] if in_ratio > ratio[1] else W)
    fb_h = W / ratio[0] if in_ratio < ratio[0] else H
    w = torch.where(any_ok, w, fb_w)
    h = torch.where(any_ok, h, fb_h)
    x0 = torch.where(any_ok, d.ux * (W - w), (W - w) / 2)
    y0 = torch.where(any_ok, d.uy * (H - h), (H - h) / 2)
    sx, sy = w / Wo, h / Ho
    zeros = torch.zeros_like(sx)
    # src = x0 + (dst + 0.5) * s - 0.5   (half-pixel centres)
    return _affine([(sx, zeros, x0 + 0.5 * sx - 0.5),
                    (zeros, sy, y0 + 0.5 * sy - 0.5)])


class FlipDraws(NamedTuple):
    h: torch.Tensor  # (B,) bool
    v: torch.Tensor  # (B,) bool


def draw_flip(gen, batch: int, hflip_prob: float, vflip_prob: float) -> FlipDraws:
    return FlipDraws(bernoulli(gen, hflip_prob, batch),
                     bernoulli(gen, vflip_prob, batch))


def flip_matrix(d: FlipDraws, out_hw) -> torch.Tensor:
    Ho, Wo = out_hw
    h, v = d.h.to(torch.float32), d.v.to(torch.float32)
    sx, sy = 1.0 - 2.0 * h, 1.0 - 2.0 * v       # -1 where flipped, else 1
    tx, ty = h * float(Wo - 1), v * float(Ho - 1)
    zeros = torch.zeros_like(sx)
    return _affine([(sx, zeros, tx), (zeros, sy, ty)])


def ssr_forward_matrix(angle_deg, scale, dx, dy, out_hw) -> torch.Tensor:
    """cv2.getRotationMatrix2D((W-1)/2, (H-1)/2, angle, scale) plus a
    (dx*W, dy*H) translation: ShiftScaleRotate's forward warp."""
    Ho, Wo = out_hw
    theta = torch.deg2rad(angle_deg)
    cx, cy = (Wo - 1) / 2.0, (Ho - 1) / 2.0
    a = scale * torch.cos(theta)
    b = scale * torch.sin(theta)
    tx = (1 - a) * cx - b * cy + dx * Wo
    ty = b * cx + (1 - a) * cy + dy * Ho
    return _affine([(a, b, tx), (-b, a, ty)])


class SSRDraws(NamedTuple):
    apply: torch.Tensor  # (B,) bool
    shift: torch.Tensor  # (B, 2) U(-shift_limit, shift_limit)
    scale: torch.Tensor  # (B,) U(-scale_limit, scale_limit)
    angle: torch.Tensor  # (B,) U(-rotate_limit, rotate_limit) degrees


def draw_shift_scale_rotate(gen, batch: int, prob: float, shift_limit: float,
                            scale_limit: float, rotate_limit: float) -> SSRDraws:
    return SSRDraws(bernoulli(gen, prob, batch),
                    uniform(gen, (batch, 2), -shift_limit, shift_limit),
                    uniform(gen, (batch,), -scale_limit, scale_limit),
                    uniform(gen, (batch,), -rotate_limit, rotate_limit))


def shift_scale_rotate_inverse_matrix(d: SSRDraws, out_hw) -> torch.Tensor:
    """Inverse of ShiftScaleRotate's forward warp; output(p) = input(M^-1 p)."""
    scale = torch.where(d.apply, 1.0 + d.scale, 1.0)
    angle = torch.where(d.apply, d.angle, 0.0)
    dxy = torch.where(d.apply[:, None], d.shift, 0.0)
    return _inverse3(ssr_forward_matrix(angle, scale, dxy[:, 0], dxy[:, 1], out_hw))


# --------------------------------------------------------------------------
# distortion displacement maps (sampled in output space)
# --------------------------------------------------------------------------

class DistortionCfg(NamedTuple):
    prob: float = 0.3
    optical_distort_limit: float = 0.1
    optical_shift_limit: float = 0.1
    grid_distort_limit: float = 0.1
    grid_num_steps: int = 5
    elastic_alpha: float = 1.0
    elastic_sigma: float = 50.0


def elastic_grid_hw(out_hw, cfg: DistortionCfg) -> tuple[int, int]:
    sigma = max(cfg.elastic_sigma, 1.0)
    return max(2, int(out_hw[0] / sigma) + 2), max(2, int(out_hw[1] / sigma) + 2)


class DistortionDraws(NamedTuple):
    apply: torch.Tensor          # (B,) bool
    pick: torch.Tensor           # (B,) int in {0 optical, 1 grid, 2 elastic}
    optical_k: torch.Tensor      # (B, 1, 1) U(-distort_limit, distort_limit)
    optical_shift: torch.Tensor  # (B, 2) U(-shift_limit, shift_limit)
    grid_x: torch.Tensor         # (B, steps) U(-grid_limit, grid_limit)
    grid_y: torch.Tensor         # (B, steps)
    elastic: torch.Tensor        # (B, gh, gw, 2) standard normal


def draw_distortion(gen, batch: int, out_hw, cfg: DistortionCfg) -> DistortionDraws:
    n = cfg.grid_num_steps
    return DistortionDraws(
        bernoulli(gen, cfg.prob, batch),
        randint(gen, 0, 3, (batch,)),
        uniform(gen, (batch, 1, 1), -cfg.optical_distort_limit, cfg.optical_distort_limit),
        uniform(gen, (batch, 2), -cfg.optical_shift_limit, cfg.optical_shift_limit),
        uniform(gen, (batch, n), -cfg.grid_distort_limit, cfg.grid_distort_limit),
        uniform(gen, (batch, n), -cfg.grid_distort_limit, cfg.grid_distort_limit),
        torch.randn((batch, *elastic_grid_hw(out_hw, cfg), 2), generator=gen,
                    device=gen.device))


def optical_distortion_map(k: torch.Tensor, shift: torch.Tensor, out_hw) -> torch.Tensor:
    """Barrel/pincushion distortion approximating
    cv2.initUndistortRectifyMap with distCoeffs=(k, k, 0, 0), fx=fy=W.
    Returns (B, Ho, Wo, 2) [x, y]."""
    Ho, Wo = out_hw
    cx = Wo / 2.0 + shift[:, 0, None, None] * Wo
    cy = Ho / 2.0 + shift[:, 1, None, None] * Ho
    f = float(Wo)
    grid = output_grid(Ho, Wo, k.device)
    x, y = grid[None, ..., 0], grid[None, ..., 1]
    u = (x - cx) / f
    v = (y - cy) / f
    r2 = u * u + v * v
    factor = 1.0 + k * r2 + k * r2 * r2
    return torch.stack([u * factor * f + cx, v * factor * f + cy], dim=-1)


# jnp.interp's zero-width test: np.spacing(np.finfo(np.float32).eps)
_INTERP_EPS = 2.0 ** -46


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` row by row: ``x`` (B, n) at knots ``xp`` (B, k)
    increasing, values ``fp`` (k,); constant outside the knots."""
    k = xp.shape[-1]
    i = torch.searchsorted(xp, x, right=True).clamp(1, k - 1)
    xp_lo, xp_hi = torch.gather(xp, 1, i - 1), torch.gather(xp, 1, i)
    fp_lo, fp_hi = fp[i - 1], fp[i]
    dx = xp_hi - xp_lo
    tiny = dx.abs() <= _INTERP_EPS
    f = torch.where(tiny, fp_lo, fp_lo + ((x - xp_lo) / torch.where(tiny, 1.0, dx))
                    * (fp_hi - fp_lo))
    f = torch.where(x < xp[:, :1], fp[0], f)
    return torch.where(x > xp[:, -1:], fp[-1], f)


def grid_distortion_map(grid_x: torch.Tensor, grid_y: torch.Tensor, out_hw) -> torch.Tensor:
    """Piecewise-linear, per-axis-separable grid distortion: each of the
    cells along each axis has its width scaled by 1 + U(-limit, limit),
    boundaries renormalised to the full span, linear within cells."""
    Ho, Wo = out_hw
    B, n = grid_x.shape

    def axis_map(u: torch.Tensor, size: int) -> torch.Tensor:
        widths = 1.0 + u
        knots_out = torch.cat([torch.zeros((B, 1), device=u.device),
                               torch.cumsum(widths, dim=1)], dim=1)
        knots_out = knots_out / knots_out[:, -1:] * (size - 1)
        knots_in = torch.linspace(0.0, size - 1, n + 1, device=u.device)
        coords = torch.arange(size, dtype=torch.float32, device=u.device)
        return interp(coords.expand(B, size).contiguous(), knots_out.contiguous(),
                      knots_in)

    xs = axis_map(grid_x, Wo)[:, None, :].expand(B, Ho, Wo)
    ys = axis_map(grid_y, Ho)[:, :, None].expand(B, Ho, Wo)
    return torch.stack([xs, ys], dim=-1)


def elastic_map(coarse: torch.Tensor, out_hw, cfg: DistortionCfg) -> torch.Tensor:
    """Smooth random displacement: a coarse normal grid with the variance of
    a Gaussian-filtered U(-1, 1) field, upsampled bilinearly with half-pixel
    centres. The grid only grows, where ``jax.image.resize`` (linear) and
    ``F.interpolate`` (bilinear, no antialias) agree."""
    sigma = max(cfg.elastic_sigma, 1.0)
    std = (1.0 / 3.0) ** 0.5 / (2.0 * (math.pi ** 0.5) * sigma)
    disp = F.interpolate((coarse * std * cfg.elastic_alpha).permute(0, 3, 1, 2),
                         size=tuple(out_hw), mode="bilinear", align_corners=False)
    disp = disp.permute(0, 2, 3, 1)
    return output_grid(*out_hw, device=coarse.device)[None] + disp


def distortion_source_map(d: DistortionDraws, out_hw, cfg: DistortionCfg) -> torch.Tensor:
    """OneOf{optical, grid, elastic} with probability ``cfg.prob``, identity
    otherwise: per-pixel source coords (B, Ho, Wo, 2) [x, y], output space."""
    sel = torch.where(
        (d.pick == 0)[:, None, None, None],
        optical_distortion_map(d.optical_k, d.optical_shift, out_hw),
        torch.where((d.pick == 1)[:, None, None, None],
                    grid_distortion_map(d.grid_x, d.grid_y, out_hw),
                    elastic_map(d.elastic, out_hw, cfg)))
    return torch.where(d.apply[:, None, None, None], sel,
                       output_grid(*out_hw, device=sel.device)[None])


# --------------------------------------------------------------------------
# fused warp
# --------------------------------------------------------------------------

class GeometryCfg(NamedTuple):
    rrc_scale: tuple[float, float] = (0.8, 1.0)
    rrc_ratio: tuple[float, float] = (0.75, 4.0 / 3.0)
    hflip_prob: float = 0.5
    vflip_prob: float = 0.5
    ssr_prob: float = 0.5
    shift_limit: float = 0.1
    scale_limit: float = 0.2
    rotate_limit: float = 30.0
    distortion: DistortionCfg = DistortionCfg()


class GeometryDraws(NamedTuple):
    rrc: RRCDraws
    flip: FlipDraws
    ssr: SSRDraws
    distortion: DistortionDraws


def draw_geometry(gen, batch: int, out_hw, cfg: GeometryCfg) -> GeometryDraws:
    return GeometryDraws(
        draw_random_resized_crop(gen, batch, cfg.rrc_scale, cfg.rrc_ratio),
        draw_flip(gen, batch, cfg.hflip_prob, cfg.vflip_prob),
        draw_shift_scale_rotate(gen, batch, cfg.ssr_prob, cfg.shift_limit,
                                cfg.scale_limit, cfg.rotate_limit),
        draw_distortion(gen, batch, out_hw, cfg.distortion))


def source_coords(d: GeometryDraws, native_hw, out_hw, cfg: GeometryCfg) -> torch.Tensor:
    """(B, Ho, Wo, 2) [y, x] native-image coordinates of every output pixel,
    f32, not folded."""
    A = random_resized_crop_matrix(d.rrc, native_hw, out_hw, cfg.rrc_ratio)
    T = _matmul3(_matmul3(A, flip_matrix(d.flip, out_hw)),
                 shift_scale_rotate_inverse_matrix(d.ssr, out_hw))
    src = distortion_source_map(d.distortion, out_hw, cfg.distortion)
    x, y = src[..., 0], src[..., 1]
    t = T[:, :, :, None, None]
    return torch.stack([t[:, 1, 0] * x + t[:, 1, 1] * y + t[:, 1, 2],
                        t[:, 0, 0] * x + t[:, 0, 1] * y + t[:, 0, 2]], dim=-1)


def geometric_augment(images: torch.Tensor, d: GeometryDraws, out_hw,
                      cfg: GeometryCfg) -> torch.Tensor:
    """Fused RRC + flips + SSR + distortion, one sample per output pixel.
    ``images`` (B, H, W, C) float in [0, 255] -> (B, Ho, Wo, C)."""
    coords = source_coords(d, tuple(images.shape[1:3]), tuple(out_hw), cfg)
    return sample_image(images.contiguous(), coords)
