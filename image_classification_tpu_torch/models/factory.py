"""Model factory, port of ``image_classification_tpu/models/factory.py``:
the ConvNeXt, EfficientNet and ViT/DeiT families, each optionally wrapped
for deep supervision."""

from __future__ import annotations

import logging
from dataclasses import dataclass

import torch
from torch import nn

from image_classification_tpu_torch.models.convnext import (
    CONVNEXT_CONFIGS,
    build_convnext,
    init_convnext_,
)
from image_classification_tpu_torch.models.deep_supervision import (
    DeepSupervisionModel,
)
from image_classification_tpu_torch.models.efficientnet import (
    EFFNET_V1_SCALING,
    build_efficientnet,
    init_efficientnet_,
)
from image_classification_tpu_torch.models.vit import VIT_CONFIGS, build_vit, init_vit_

logger = logging.getLogger("ic_tpu_torch")


def _family(name: str) -> str:
    base = name.split(".")[0]
    if "convnext" in base:
        return "convnext"
    if "efficientnet" in base:
        return "efficientnet"
    if base.startswith(("vit_", "deit_")):
        return "vit"
    raise ValueError(f"Unknown model family for {name!r}")


def list_models() -> list[str]:
    return (sorted(CONVNEXT_CONFIGS) + sorted(EFFNET_V1_SCALING)
            + ["tf_efficientnetv2_s"] + sorted(VIT_CONFIGS))


@dataclass
class ModelBundle:
    """A constructed model plus what the train and predict steps need to
    drive it."""

    name: str
    module: nn.Module
    deep_supervised: bool
    input_size: tuple[int, int]
    has_batch_stats: bool = False   # BatchNorm running statistics in buffers


def create_model(cfg, model_name: str | None = None,
                 generator: torch.Generator | None = None) -> ModelBundle:
    """Build the configured model on the CPU, in f32, with flax's
    initialisation drawn from ``generator`` (seeded from ``cfg.seed`` when
    omitted). Move it with ``.to(device)``. It is returned in eval mode; the
    train step puts it in train mode (EfficientNet's BatchNorm, dropout and
    drop-path act only there). Like the JAX factory, it passes
    ``cfg.drop_rate`` and ``cfg.drop_path_rate`` itself, so a V1 model
    trains without head dropout unless the config sets one, and a ConvNeXt
    takes ``cfg.block_remat`` (EfficientNet and ViT ignore it, as in JAX). A ViT sizes its
    position embedding from ``cfg.image_size`` and raises ``ValueError``
    where that is not a multiple of its patch (V2's 60x80)."""
    name = model_name or cfg.model_name
    family = _family(name)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    kwargs = dict(drop_rate=cfg.drop_rate, drop_path_rate=cfg.drop_path_rate,
                  dtype=dtype)
    if family == "efficientnet":
        module: nn.Module = build_efficientnet(name, cfg.num_classes, **kwargs)
        init = init_efficientnet_
    elif family == "vit":
        module = build_vit(name, cfg.num_classes, image_size=tuple(cfg.image_size),
                           **kwargs)
        init = init_vit_
    else:
        module = build_convnext(name, cfg.num_classes,
                                gelu_approximate=cfg.gelu_approximate,
                                block_remat=cfg.block_remat, **kwargs)
        init = init_convnext_
    deep = bool(cfg.use_deep_supervision)
    if deep:
        module = DeepSupervisionModel(module, cfg.num_classes)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    init(module, generator)
    return ModelBundle(name=name, module=module.eval(), deep_supervised=deep,
                       input_size=tuple(cfg.image_size),
                       has_batch_stats=family == "efficientnet")


def load_pretrained_into(model: nn.Module, cfg) -> nn.Module:
    """Import the local checkpoint ``cfg.pretrained_path`` into ``model`` in
    place (``models/pretrained.py:load_checkpoint_into``); keeps the random
    init when ``cfg.pretrained`` is off or the file is missing."""
    if not cfg.pretrained:
        return model
    path = cfg.pretrained_path
    if not path:
        logger.warning("pretrained=True but no pretrained_path set; using random "
                       "init (no network download path exists).")
        return model
    from image_classification_tpu_torch.models.pretrained import load_checkpoint_into

    try:
        load_checkpoint_into(model, path,
                             strip_head=getattr(cfg, "pretrained_strip_head", False))
    except FileNotFoundError:
        logger.warning("pretrained checkpoint %s not found; random init", path)
    return model
