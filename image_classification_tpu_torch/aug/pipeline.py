"""The augmentation pipelines, port of
``image_classification_tpu/aug/pipeline.py``.

``train_augment`` takes a batched uint8 tensor straight from the loader and
runs, on the tensor's device,

    fused geometric warp (RRC + flips + SSR + distortion, one resampling)
    -> RandAugment (when ``use_randaugment``)
    -> OneOf{noise, gaussian blur, motion blur}
    -> ColorJitter
    -> OneOf{RGBShift, HSV, ToGray}
    -> CoarseDropout
    -> Normalize

in the compute dtype (bf16 when ``compute_dtype`` is bf16). Its random draws
come from one ``torch.Generator`` (:func:`draw_train_augment`) and are
applied by :func:`apply_train_augment` (``aug/draws.py``).
``eval_preprocess`` is the val/test path: Resize + Normalize.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from image_classification_tpu_torch.aug import color as color_ops
from image_classification_tpu_torch.aug import erase as erase_ops
from image_classification_tpu_torch.aug import filters as filter_ops
from image_classification_tpu_torch.aug import geometry as geom
from image_classification_tpu_torch.aug import randaug as randaug_ops


@functools.cache
def _normalize_constants(mean, std, dtype, device):
    """``mean * 255`` and ``1 / (std * 255)`` in ``dtype``, made once per
    device: a copy from host memory waits for the card."""
    m = torch.tensor(mean, dtype=dtype, device=device) * 255.0
    s = torch.tensor(std, dtype=dtype, device=device) * 255.0
    return m, 1.0 / s


def normalize(images: torch.Tensor, mean: tuple[float, float, float],
              std: tuple[float, float, float]) -> torch.Tensor:
    """(x/255 - mean) / std, matching A.Normalize; keeps a float input's
    dtype (bf16 stays bf16), casts integers to f32."""
    dtype = images.dtype if images.is_floating_point() else torch.float32
    m, inv_s = _normalize_constants(tuple(mean), tuple(std), dtype, images.device)
    return (images.to(dtype) - m) * inv_s


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


# --------------------------------------------------------------------------
# training augmentation
# --------------------------------------------------------------------------

def aug_configs_from(cfg) -> dict:
    """The per-stage configs from the Config. ``warp_impl`` selects nothing
    in the port (the warp kernel always runs on a card)."""
    return {
        "geometry": geom.GeometryCfg(
            rrc_scale=tuple(cfg.rrc_scale),
            rrc_ratio=tuple(cfg.rrc_ratio),
            hflip_prob=cfg.hflip_prob,
            vflip_prob=cfg.vflip_prob,
            ssr_prob=cfg.ssr_prob,
            shift_limit=cfg.shift_limit,
            scale_limit=cfg.scale_limit,
            rotate_limit=cfg.rotate_limit,
            distortion=geom.DistortionCfg(
                prob=cfg.distortion_prob,
                optical_distort_limit=cfg.optical_distort_limit,
                optical_shift_limit=cfg.optical_shift_limit,
                grid_distort_limit=cfg.grid_distort_limit,
                grid_num_steps=cfg.grid_num_steps,
                elastic_alpha=cfg.elastic_alpha,
                elastic_sigma=cfg.elastic_sigma,
            ),
        ),
        "noise_blur": filter_ops.NoiseBlurCfg(
            prob=cfg.noise_blur_prob,
            gauss_noise_var=tuple(cfg.gauss_noise_var),
            blur_limit=tuple(cfg.blur_limit),
        ),
        "jitter": color_ops.ColorJitterCfg(
            prob=cfg.color_jitter_prob,
            brightness=cfg.brightness,
            contrast=cfg.contrast,
            saturation=cfg.saturation,
            hue=cfg.hue,
        ),
        "color_shift": color_ops.ColorShiftCfg(
            prob=cfg.color_shift_prob,
            rgb_shift_limit=cfg.rgb_shift_limit,
            hsv_hue_limit=cfg.hsv_hue_limit,
            hsv_sat_limit=cfg.hsv_sat_limit,
            hsv_val_limit=cfg.hsv_val_limit,
        ),
        "erase": erase_ops.EraseCfg(
            prob=cfg.random_erasing_prob,
            max_holes=cfg.erase_max_holes,
            min_holes=cfg.erase_min_holes,
        ),
        "randaugment": (
            None if not cfg.use_randaugment
            else randaug_ops.RandAugmentCfg(
                prob=cfg.randaugment_prob,
                num_ops=cfg.randaugment_num_ops,
                magnitude=cfg.randaugment_magnitude,
                mag_std=cfg.randaugment_mag_std,
            )
        ),
        "image_size": tuple(cfg.image_size),
        "mean": tuple(cfg.mean),
        "std": tuple(cfg.std),
        # bf16 halves the traffic through the chain; Python-scalar constants
        # keep the ops in this dtype end to end.
        "dtype": torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32,
    }


class AugDraws(NamedTuple):
    geometry: geom.GeometryDraws
    noise_blur: filter_ops.NoiseBlurDraws
    jitter: color_ops.ColorJitterDraws
    color_shift: color_ops.ColorShiftDraws
    erase: erase_ops.EraseDraws
    randaug: randaug_ops.RandAugDraws | None = None   # None when it is off


def draw_train_augment(generator: torch.Generator, shape, aug: dict) -> AugDraws:
    """Every random draw of :func:`train_augment` for a uint8 batch of
    ``shape`` (B, H, W, C), on ``generator``'s device, in a fixed order
    (RandAugment's last, so turning it on leaves the others' draws as they
    were)."""
    B, C = shape[0], shape[-1]
    out_shape = (B, *aug["image_size"], C)
    ra = aug.get("randaugment")
    return AugDraws(
        geom.draw_geometry(generator, B, aug["image_size"], aug["geometry"]),
        filter_ops.draw_noise_blur(generator, out_shape, aug["noise_blur"]),
        color_ops.draw_color_jitter(generator, B, aug["jitter"]),
        color_ops.draw_color_shift(generator, B, aug["color_shift"]),
        erase_ops.draw_coarse_dropout(generator, out_shape, aug["erase"]),
        None if ra is None else randaug_ops.draw_rand_augment(generator, B, ra),
    )


def apply_train_augment(images_u8: torch.Tensor, d: AugDraws, aug: dict) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> augmented, normalized (B, Ho, Wo, 3) in
    ``aug['dtype']``, from ready-made draws."""
    x = images_u8.to(aug["dtype"])
    x = geom.geometric_augment(x, d.geometry, aug["image_size"], aug["geometry"])
    if aug.get("randaugment") is not None:
        x = randaug_ops.apply_rand_augment(x, d.randaug, aug["randaugment"])
    x = filter_ops.noise_blur_oneof(x, d.noise_blur, aug["noise_blur"])
    x = color_ops.color_jitter(x, d.jitter, aug["jitter"])
    x = color_ops.color_shift_oneof(x, d.color_shift, aug["color_shift"])
    x = erase_ops.coarse_dropout(x, d.erase, aug["erase"])
    return normalize(x, aug["mean"], aug["std"])


def train_augment(images_u8: torch.Tensor, generator: torch.Generator,
                  aug: dict) -> torch.Tensor:
    """Draw, then apply: the training augmentation of one batch."""
    return apply_train_augment(
        images_u8, draw_train_augment(generator, tuple(images_u8.shape), aug), aug)

