"""The warp's plain arithmetic, frozen from the port's ``ops/warp.py``
(``floor_mod``, ``reflect101_coord``, ``warp_reference``): bilinear
sampling with OpenCV's BORDER_REFLECT_101, four taps, x contracted first.
The reference runs it in f32, where its rounding points round nothing."""

from __future__ import annotations

import torch


def floor_mod(x: torch.Tensor, period: float) -> torch.Tensor:
    """``jnp.mod`` on floats (``period > 0``)."""
    r = torch.fmod(x, period)
    return torch.where(r < 0, r + period, r)


def reflect101_coord(coord: torch.Tensor, n: int) -> torch.Tensor:
    """Fold float coordinates into ``[0, n - 1]`` with reflect-101."""
    if n == 1:
        return torch.zeros_like(coord)
    period = 2 * n - 2
    m = floor_mod(coord, float(period))
    return torch.where(m > n - 1, period - m, m)


def _hat(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - (c - w).abs(), min=0.0)


def warp(img: torch.Tensor, coords_yx: torch.Tensor) -> torch.Tensor:
    """``(B, H, W, C)`` image sampled at ``(B, Ho, Wo, 2)`` [y, x] coords."""
    B, H, W, C = img.shape
    Ho, Wo = coords_yx.shape[1:3]
    coords = coords_yx.float()
    y = reflect101_coord(coords[..., 0], H)
    x = reflect101_coord(coords[..., 1], W)
    y0, x0 = torch.floor(y), torch.floor(x)
    hx = [_hat(x, x0 + k).to(img.dtype).float().unsqueeze(-1) for k in (0, 1)]
    hy = [_hat(y, y0 + k).unsqueeze(-1) for k in (0, 1)]
    yi = [(y0 + k).long().clamp(max=H - 1) for k in (0, 1)]
    xi = [(x0 + k).long().clamp(max=W - 1) for k in (0, 1)]
    flat = img.reshape(B, H * W, C).float()

    def tap(r, s):
        idx = (yi[r] * W + xi[s]).reshape(B, Ho * Wo, 1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(B, Ho, Wo, C)

    rows = [hx[0] * tap(r, 0) + hx[1] * tap(r, 1) for r in (0, 1)]
    return (hy[0] * rows[0] + hy[1] * rows[1]).to(img.dtype)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The reference runs one process: the rows are all there."""
    if group is not None:
        raise ValueError("the reference runs in one process")
    return x
