"""Model factory, port of ``image_classification_tpu/models/factory.py`` for
the ConvNeXt family. EfficientNet and ViT are not ported yet (ROADMAP queue A,
item 6)."""

from __future__ import annotations

import logging
from dataclasses import dataclass

import torch
from torch import nn

from image_classification_tpu_torch.models.convnext import (
    build_convnext,
    init_convnext_,
)
from image_classification_tpu_torch.models.deep_supervision import (
    DeepSupervisionModel,
)

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


@dataclass
class ModelBundle:
    """A constructed model plus what the train and predict steps need to
    drive it."""

    name: str
    module: nn.Module
    deep_supervised: bool
    input_size: tuple[int, int]


def create_model(cfg, model_name: str | None = None,
                 generator: torch.Generator | None = None) -> ModelBundle:
    """Build the configured model on the CPU, in f32, with flax's
    initialisation drawn from ``generator`` (seeded from ``cfg.seed`` when
    omitted). Move it with ``.to(device)``. The module has no dropout or
    batch statistics, so its train and eval modes compute the same."""
    name = model_name or cfg.model_name
    family = _family(name)
    if family != "convnext":
        raise NotImplementedError(
            f"{name}: only ConvNeXt is ported; EfficientNet and ViT are "
            "ROADMAP queue A, item 6")
    if cfg.drop_path_rate > 0 or cfg.drop_rate > 0:
        raise NotImplementedError(
            "drop_path_rate > 0 and drop_rate > 0 (stochastic depth, head "
            "dropout) are not ported; V4 uses neither")
    if cfg.gelu_approximate:
        raise NotImplementedError("tanh GELU (gelu_approximate=true) is not "
                                  "ported; the block-tail kernel is exact GELU")
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    module: nn.Module = build_convnext(name, cfg.num_classes, dtype=dtype)
    deep = bool(cfg.use_deep_supervision)
    if deep:
        module = DeepSupervisionModel(module, cfg.num_classes)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    init_convnext_(module, generator)
    return ModelBundle(name=name, module=module.eval(), deep_supervised=deep,
                       input_size=tuple(cfg.image_size))


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
