# Frozen copy of image_classification_tpu_torch/aug/erase.py for the benchmark's
# reference: the reference may not import the program it judges.
"""CoarseDropout (random erasing), port of
``image_classification_tpu/aug/erase.py``: per sample with probability p,
n ~ U{min_holes..max_holes} rectangles, each of height ~ U{H/16..H/8} and
width ~ U{W/16..W/8} at uniform positions, filled with ``fill_value``, as a
batched mask with no data-dependent shapes."""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.aug.draws import bernoulli, randint, uniform


class EraseCfg(NamedTuple):
    prob: float = 0.3
    max_holes: int = 8
    min_holes: int = 1
    fill_value: float = 0.0


class EraseDraws(NamedTuple):
    apply: torch.Tensor  # (B,) bool
    n: torch.Tensor      # (B,) holes in [min_holes, max_holes]
    hh: torch.Tensor     # (B, max_holes) heights in [H//16, H//8]
    ww: torch.Tensor     # (B, max_holes) widths in [W//16, W//8]
    uy: torch.Tensor     # (B, max_holes) U(0, 1), the top edge's fraction
    ux: torch.Tensor     # (B, max_holes)


def draw_coarse_dropout(gen, shape, cfg: EraseCfg) -> EraseDraws:
    """Draws for images of ``shape`` (B, H, W, C)."""
    B, H, W = shape[:3]
    M = cfg.max_holes
    return EraseDraws(
        bernoulli(gen, cfg.prob, B),
        randint(gen, cfg.min_holes, cfg.max_holes + 1, (B,)),
        randint(gen, H // 16, H // 8 + 1, (B, M)),
        randint(gen, W // 16, W // 8 + 1, (B, M)),
        uniform(gen, (B, M)), uniform(gen, (B, M)))


def coarse_dropout(images: torch.Tensor, d: EraseDraws, cfg: EraseCfg) -> torch.Tensor:
    B, H, W, _ = images.shape
    y0 = (d.uy * (H - d.hh)).to(torch.int32)   # truncates toward zero
    x0 = (d.ux * (W - d.ww)).to(torch.int32)
    ys = torch.arange(H, device=images.device)[None, None, :, None]
    xs = torch.arange(W, device=images.device)[None, None, None, :]
    in_y = (ys >= y0[:, :, None, None]) & (ys < (y0 + d.hh)[:, :, None, None])
    in_x = (xs >= x0[:, :, None, None]) & (xs < (x0 + d.ww)[:, :, None, None])
    active = (torch.arange(cfg.max_holes, device=images.device)[None, :]
              < d.n[:, None])[:, :, None, None]
    hole = (in_y & in_x & active).any(dim=1) & d.apply[:, None, None]
    return torch.where(hole[..., None], cfg.fill_value, images)
