"""The training augmentation and the eval preprocessing, as plain PyTorch
for the benchmark's reference (the semantics of the port's
``aug/pipeline.py``, frozen): the fused geometric warp, OneOf noise/blur,
colour jitter, OneOf colour shift, coarse dropout, normalize; then
MixUp/CutMix. Every stage's parameters come from the configuration file's
``config`` dict; the draws come from a ``torch.Generator`` in the program's
documented order (geometry, noise/blur, jitter, colour shift, erase, then
the mix). RandAugment is not in any configuration the benchmark runs, and
is refused here."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from benchmark.reference.aug import color, erase, filters, geometry, mix


def stage_configs(cfg: dict, dtype: torch.dtype = torch.float32) -> dict:
    """Each stage's config from the configuration file's values."""
    if cfg.get("use_randaugment"):
        raise ValueError("the reference has no RandAugment")
    return {
        "geometry": geometry.GeometryCfg(
            rrc_scale=tuple(cfg["rrc_scale"]), rrc_ratio=tuple(cfg["rrc_ratio"]),
            hflip_prob=cfg["hflip_prob"], vflip_prob=cfg["vflip_prob"],
            ssr_prob=cfg["ssr_prob"], shift_limit=cfg["shift_limit"],
            scale_limit=cfg["scale_limit"], rotate_limit=cfg["rotate_limit"],
            distortion=geometry.DistortionCfg(
                prob=cfg["distortion_prob"],
                optical_distort_limit=cfg["optical_distort_limit"],
                optical_shift_limit=cfg["optical_shift_limit"],
                grid_distort_limit=cfg["grid_distort_limit"],
                grid_num_steps=cfg["grid_num_steps"],
                elastic_alpha=cfg["elastic_alpha"],
                elastic_sigma=cfg["elastic_sigma"])),
        "noise_blur": filters.NoiseBlurCfg(
            prob=cfg["noise_blur_prob"], gauss_noise_var=tuple(cfg["gauss_noise_var"]),
            blur_limit=tuple(cfg["blur_limit"])),
        "jitter": color.ColorJitterCfg(
            prob=cfg["color_jitter_prob"], brightness=cfg["brightness"],
            contrast=cfg["contrast"], saturation=cfg["saturation"], hue=cfg["hue"]),
        "color_shift": color.ColorShiftCfg(
            prob=cfg["color_shift_prob"], rgb_shift_limit=cfg["rgb_shift_limit"],
            hsv_hue_limit=cfg["hsv_hue_limit"], hsv_sat_limit=cfg["hsv_sat_limit"],
            hsv_val_limit=cfg["hsv_val_limit"]),
        "erase": erase.EraseCfg(prob=cfg["random_erasing_prob"],
                                max_holes=cfg["erase_max_holes"],
                                min_holes=cfg["erase_min_holes"]),
        "mix": (mix.MixCfg(mixup_alpha=cfg["mixup_alpha"], cutmix_alpha=cfg["cutmix_alpha"],
                           prob=cfg["mix_prob"], num_classes=cfg["num_classes"])
                if cfg["mixup_alpha"] > 0 or cfg["cutmix_alpha"] > 0 else None),
        "image_size": tuple(cfg["image_size"]),
        "mean": tuple(cfg["mean"]),
        "std": tuple(cfg["std"]),
        "dtype": dtype,
    }


class Draws(NamedTuple):
    geometry: geometry.GeometryDraws
    noise_blur: filters.NoiseBlurDraws
    jitter: color.ColorJitterDraws
    color_shift: color.ColorShiftDraws
    erase: erase.EraseDraws
    mix: mix.MixDraws | None


def draw(gen: torch.Generator, shape, st: dict) -> Draws:
    """One train step's aug and mix draws for a uint8 batch of ``shape``."""
    B, C = shape[0], shape[-1]
    out_shape = (B, *st["image_size"], C)
    return Draws(
        geometry.draw_geometry(gen, B, st["image_size"], st["geometry"]),
        filters.draw_noise_blur(gen, out_shape, st["noise_blur"]),
        color.draw_color_jitter(gen, B, st["jitter"]),
        color.draw_color_shift(gen, B, st["color_shift"]),
        erase.draw_coarse_dropout(gen, out_shape, st["erase"]),
        None if st["mix"] is None else mix.draw_mix(gen, out_shape, st["mix"]))


def normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    m = torch.tensor(mean, dtype=x.dtype, device=x.device) * 255.0
    s = torch.tensor(std, dtype=x.dtype, device=x.device) * 255.0
    return (x - m) / s


def augment(images_u8: torch.Tensor, labels: torch.Tensor, d: Draws, st: dict):
    """uint8 (B, h, w, 3) -> (normalized images (B, H, W, 3), targets): soft
    f32 (B, classes) targets where the config mixes, else the labels."""
    x = images_u8.to(st["dtype"])
    x = geometry.geometric_augment(x, d.geometry, st["image_size"], st["geometry"])
    x = filters.noise_blur_oneof(x, d.noise_blur, st["noise_blur"])
    x = color.color_jitter(x, d.jitter, st["jitter"])
    x = color.color_shift_oneof(x, d.color_shift, st["color_shift"])
    x = erase.coarse_dropout(x, d.erase, st["erase"])
    x = normalize(x, st["mean"], st["std"])
    if st["mix"] is None:
        return x, labels
    return mix.mixup_cutmix_batch(x, labels, d.mix, st["mix"])


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(B, H, W, C) bilinear, half-pixel centres, antialiased where a
    dimension shrinks (``jax.image.resize``'s triangle filter)."""
    h, w = x.shape[1:3]
    shrink = out_hw[0] < h or out_hw[1] < w
    y = F.interpolate(x.float().permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=shrink)
    return y.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def eval_preprocess(images_u8: torch.Tensor, cfg: dict) -> torch.Tensor:
    """uint8 -> resized (rounded back to whole grey levels, as A.Resize on a
    uint8 image where ``eval_resize_uint8``) and normalized f32 images."""
    x = images_u8.float()
    size = tuple(cfg["image_size"])
    if tuple(x.shape[1:3]) != size:
        x = resize_bilinear(x, size)
        if cfg["eval_resize_uint8"]:
            x = torch.clamp(torch.round(x), 0.0, 255.0)
    return normalize(x, cfg["mean"], cfg["std"])


def center_crop_or_pad(x: torch.Tensor, out_hw) -> torch.Tensor:
    """torchvision's CenterCrop: crop where larger, zero-pad where smaller."""
    H, W = x.shape[1:3]
    Ho, Wo = out_hw
    ph, pw = max(0, Ho - H), max(0, Wo - W)
    if ph or pw:
        x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        H, W = x.shape[1:3]
    y0, x0 = (H - Ho) // 2, (W - Wo) // 2
    return x[:, y0:y0 + Ho, x0:x0 + Wo]


def tta_view_count(cfg: dict) -> int:
    """The views a test image gets: scale4's four, or none but itself."""
    if cfg["tta_transforms"] <= 0:
        return 1
    if cfg["tta_mode"] != "scale4":
        raise ValueError(f"the reference has no {cfg['tta_mode']!r} views")
    return 4


def tta_views(x: torch.Tensor, cfg: dict) -> list[torch.Tensor]:
    """The configured test-time views of preprocessed images: identity,
    horizontal flip, and 0.9x and 1.1x resizes centre-cropped or padded
    back to size (scale4)."""
    if tta_view_count(cfg) == 1:
        return [x]
    H, W = x.shape[1:3]
    views = [x, x.flip(2)]
    for scale in (0.9, 1.1):
        views.append(center_crop_or_pad(resize_bilinear(x, (int(H * scale), int(W * scale))),
                                        (H, W)))
    return views
