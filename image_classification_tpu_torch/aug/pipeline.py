"""Eval preprocessing, port of the eval half of
``image_classification_tpu/aug/pipeline.py``: Resize + Normalize on batched
NHWC tensors. The training augmentation is not ported yet (ROADMAP queue A,
item 5).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def normalize(images: torch.Tensor, mean: tuple[float, float, float],
              std: tuple[float, float, float]) -> torch.Tensor:
    """(x/255 - mean) / std, matching A.Normalize; keeps a float input's
    dtype (bf16 stays bf16), casts integers to f32."""
    dtype = images.dtype if images.is_floating_point() else torch.float32
    m = torch.tensor(mean, dtype=dtype, device=images.device) * 255.0
    s = torch.tensor(std, dtype=dtype, device=images.device) * 255.0
    return (images.to(dtype) - m) * (1.0 / s)


def resize_bilinear(images: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Batched bilinear resize of (B, H, W, C) with half-pixel centres,
    computed in f32 and returned in the input's float dtype.

    ``jax.image.resize(method="linear")`` antialiases when it shrinks: its
    triangle filter widens by the scale factor. ``F.interpolate`` does the
    same only with ``antialias=True``, and without it a 0.9x shrink differs by
    tens of grey levels. With ``antialias=True`` an enlarged dimension keeps
    the plain bilinear filter, so antialias is on whenever any dimension
    shrinks."""
    h, w = images.shape[1:3]
    shrink = out_hw[0] < h or out_hw[1] < w
    x = images.float().permute(0, 3, 1, 2)
    y = F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=shrink)
    return y.permute(0, 2, 3, 1).contiguous().to(images.dtype)


def eval_preprocess(
    images_u8: torch.Tensor,
    image_size: tuple[int, int],
    mean: tuple[float, float, float] = (0.485, 0.456, 0.406),
    std: tuple[float, float, float] = (0.229, 0.224, 0.225),
    dtype: torch.dtype = torch.float32,
    round_uint8: bool = True,
) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> normalized (B, *image_size, 3) in ``dtype``.

    ``round_uint8`` rounds the resized image back to integers in [0, 255]
    before Normalize, as albumentations' A.Resize on a uint8 image does
    (``torch.round`` is half-to-even, like ``jnp.round``)."""
    x = images_u8.to(dtype)
    if tuple(x.shape[1:3]) != tuple(image_size):
        x = resize_bilinear(x, tuple(image_size))
        if round_uint8:
            x = torch.clamp(torch.round(x), 0.0, 255.0)
    return normalize(x, mean, std)
