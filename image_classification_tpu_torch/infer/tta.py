"""Test-time augmentation views, port of
``image_classification_tpu/infer/tta.py`` (batched, NHWC).

``scale4``: identity, horizontal flip, and resizes to 0.9x and 1.1x followed
by torchvision's CenterCrop back to the model size (zero-padding when the
resized image is smaller). ``flip6``: the notebook pipeline's six flip views,
duplicates included.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from image_classification_tpu_torch.aug.pipeline import resize_bilinear


def center_crop_or_pad(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """torchvision CenterCrop: crop when larger, zero-pad when smaller."""
    H, W = x.shape[1:3]
    Ho, Wo = out_hw
    ph, pw = max(0, Ho - H), max(0, Wo - W)
    if ph or pw:
        x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        H, W = x.shape[1:3]
    y0, x0 = (H - Ho) // 2, (W - Wo) // 2
    return x[:, y0 : y0 + Ho, x0 : x0 + Wo]


def tta_views_scale4(x: torch.Tensor) -> list[torch.Tensor]:
    H, W = x.shape[1:3]
    views = [x, torch.flip(x, dims=[2])]
    for scale in (0.9, 1.1):
        scaled = resize_bilinear(x, (int(H * scale), int(W * scale)))
        views.append(center_crop_or_pad(scaled, (H, W)))
    return views


def tta_views_flip6(x: torch.Tensor) -> list[torch.Tensor]:
    hf = torch.flip(x, dims=[2])
    vf = torch.flip(x, dims=[1])
    hv = torch.flip(x, dims=[1, 2])
    return [x, hf, vf, hv, vf, hf]  # exact reference view list


def get_tta(cfg) -> Callable | None:
    """None when TTA is off (``cfg.tta_transforms == 0``)."""
    if cfg.tta_transforms <= 0:
        return None
    return tta_views_flip6 if cfg.tta_mode == "flip6" else tta_views_scale4
