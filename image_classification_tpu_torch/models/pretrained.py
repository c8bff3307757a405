"""The weight carriers: flax variables -> the port's state dict.

``convnext_state_dict_from_jax(params)`` takes the flax ``params`` collection
as nested dicts of arrays (numpy, or anything ``np.asarray`` reads) and
returns the state dict of the port's model, which loads with
``strict=True``. With deep supervision the tree holds ``backbone/...`` and
``aux_head{i}``; those heads, which the JAX package's ``export_convnext``
leaves out, map to ``aux_head{i}.{weight,bias}``. The backbone keys and
tensors equal ``export_convnext``'s: flax conv kernels HWIO become OIHW (the
depthwise ``(7, 7, 1, C)`` becomes ``(C, 1, 7, 7)``) and Dense ``(in, out)``
becomes Linear ``(out, in)``. Depths are read from the tree.

``efficientnet_state_dict_from_jax(params, batch_stats)`` does the same for
an EfficientNet: its keys and tensors equal the JAX package's
``export_efficientnet`` (the block form of each block is read from the
tree), BatchNorm's running statistics come from ``batch_stats``, and with
deep supervision the tree's ``backbone`` and ``aux_head{i}`` map as for
ConvNeXt. Without ``batch_stats`` only the parameters' keys are written
(for trees shaped like the parameters: EMA, Adam's moments, SWA).

``vit_state_dict_from_jax(params)`` does the same for a ViT/DeiT: the
inverse of the JAX package's ``import_vit`` (timm's keys, the query, key and
value kernels (D, heads, head_dim) fused into ``attn.qkv`` (3·D, D) and
their biases into ``attn.qkv.bias``, the output kernel (heads, head_dim, D)
into ``attn.proj.weight``, the patch conv HWIO -> OIHW and the Dense
kernels (in, out) -> (out, in)); depth is read from the tree.
``state_dict_from_jax`` picks the carrier by the tree (a ``cls_token``: a
ViT; a stem BatchNorm: an EfficientNet; else a ConvNeXt).

``load_pretrained_into(model, cfg)`` imports a local timm-keyed checkpoint
file (``cfg.pretrained_path``) into a freshly initialised model, as the JAX
package's ``load_checkpoint_into_variables`` does: nested
``model_state_dict``/``state_dict``/``model`` entries are unwrapped, the
classifier keys are dropped with ``pretrained_strip_head``, tensors whose
shapes differ from the model's are skipped, the backbone of a
deep-supervised model takes the timm keys (its aux heads keep their init),
and a missing file leaves the random init with a warning.

``load_checkpoint_into`` copies the parameters and the BatchNorm running
statistics; timm's ``num_batches_tracked`` has no counterpart and is
skipped, as the JAX package's ``import_efficientnet`` skips it.

``train_state_from_jax`` carries a whole train state the same way: the
parameters and, for an EfficientNet, ``batch_stats`` load into the model;
the EMA shadow, Adam's ``mu`` and ``nu`` and SWA's running average (trees
shaped like the parameters) become tensors aligned with
``model.named_parameters()``, and the counters become host integers, so
both frameworks can start from one non-trivial optimizer state.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Mapping

import numpy as np
import torch

logger = logging.getLogger("ic_tpu_torch")

# The final classifier's keys (what timm strips when num_classes differs):
# ConvNeXt's, EfficientNet's and ViT's.
_HEAD_KEYS = ("head.fc.weight", "head.fc.bias", "classifier.weight", "classifier.bias",
              "head.weight", "head.bias")


def _conv(w) -> np.ndarray:  # flax HWIO -> torch OIHW
    return np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1))


def _linear(w) -> np.ndarray:  # flax (in, out) -> torch (out, in)
    return np.transpose(np.asarray(w, np.float32), (1, 0))


def _vec(v) -> np.ndarray:
    return np.asarray(v, np.float32)


def _backbone(p: Mapping[str, Any]) -> dict[str, np.ndarray]:
    sd = {
        "stem.0.weight": _conv(p["stem_conv"]["kernel"]),
        "stem.0.bias": _vec(p["stem_conv"]["bias"]),
        "stem.1.weight": _vec(p["stem_norm"]["scale"]),
        "stem.1.bias": _vec(p["stem_norm"]["bias"]),
    }
    i = 0
    while f"stage{i}_block0" in p:
        if i > 0:
            norm, conv = p[f"downsample{i}_norm"], p[f"downsample{i}_conv"]
            sd[f"stages.{i}.downsample.0.weight"] = _vec(norm["scale"])
            sd[f"stages.{i}.downsample.0.bias"] = _vec(norm["bias"])
            sd[f"stages.{i}.downsample.1.weight"] = _conv(conv["kernel"])
            sd[f"stages.{i}.downsample.1.bias"] = _vec(conv["bias"])
        j = 0
        while f"stage{i}_block{j}" in p:
            b, tp = p[f"stage{i}_block{j}"], f"stages.{i}.blocks.{j}"
            sd[f"{tp}.conv_dw.weight"] = _conv(b["conv_dw"]["kernel"])
            sd[f"{tp}.conv_dw.bias"] = _vec(b["conv_dw"]["bias"])
            sd[f"{tp}.norm.weight"] = _vec(b["norm"]["scale"])
            sd[f"{tp}.norm.bias"] = _vec(b["norm"]["bias"])
            for fc in ("fc1", "fc2"):
                sd[f"{tp}.mlp.{fc}.weight"] = _linear(b[f"mlp_{fc}"]["kernel"])
                sd[f"{tp}.mlp.{fc}.bias"] = _vec(b[f"mlp_{fc}"]["bias"])
            sd[f"{tp}.gamma"] = _vec(b["gamma"])
            j += 1
        i += 1
    sd["head.norm.weight"] = _vec(p["head_norm"]["scale"])
    sd["head.norm.bias"] = _vec(p["head_norm"]["bias"])
    sd["head.fc.weight"] = _linear(p["head_fc"]["kernel"])
    sd["head.fc.bias"] = _vec(p["head_fc"]["bias"])
    return sd


def _effnet_backbone(p: Mapping[str, Any],
                     bs: Mapping[str, Any] | None) -> dict[str, np.ndarray]:
    """``export_efficientnet``'s keys and tensors; the running statistics
    only where ``bs`` is given."""
    sd: dict[str, np.ndarray] = {}

    def conv(key: str, node) -> None:
        sd[f"{key}.weight"] = _conv(node["kernel"])
        if "bias" in node:
            sd[f"{key}.bias"] = _vec(node["bias"])

    def bn(key: str, node, stats) -> None:
        sd[f"{key}.weight"] = _vec(node["scale"])
        sd[f"{key}.bias"] = _vec(node["bias"])
        if stats is not None:
            sd[f"{key}.running_mean"] = _vec(stats["mean"])
            sd[f"{key}.running_var"] = _vec(stats["var"])

    def sub(tree, *path):
        for k in path:
            if tree is None:
                return None
            tree = tree[k]
        return tree

    conv("conv_stem", p["stem_conv"])
    bn("bn1", p["stem_bn"], sub(bs, "stem_bn"))
    conv("conv_head", p["head_conv"])
    bn("bn2", p["head_bn"], sub(bs, "head_bn"))
    sd["classifier.weight"] = _linear(p["classifier"]["kernel"])
    sd["classifier.bias"] = _vec(p["classifier"]["bias"])
    s = 0
    while f"stage{s}_block0" in p:
        b = 0
        while f"stage{s}_block{b}" in p:
            ours, tp = f"stage{s}_block{b}", f"blocks.{s}.{b}"
            q = p[ours]
            if "conv_exp" in q:        # EdgeResidual
                names = [("conv_exp", "conv_exp", "bn1"), ("conv_pwl", "conv_proj", "bn2")]
            elif "conv_pw" in q:       # InvertedResidual
                names = [("conv_pw", "conv_pw", "bn1"), ("conv_dw", "conv_dw", "bn2"),
                         ("conv_pwl", "conv_proj", "bn3")]
            elif "conv_dw" in q:       # DepthwiseSeparable
                names = [("conv_dw", "conv_dw", "bn1"), ("conv_pw", "conv_proj", "bn2")]
            else:                      # ConvBnAct
                names = [("conv", "conv_proj", "bn1")]
            for timm_conv, flax_conv, timm_bn in names:
                flax_bn = "bn_" + flax_conv.removeprefix("conv_")
                conv(f"{tp}.{timm_conv}", q[flax_conv])
                bn(f"{tp}.{timm_bn}", q[flax_bn], sub(bs, ours, flax_bn))
            if "se" in q:
                conv(f"{tp}.se.conv_reduce", q["se"]["reduce"])
                conv(f"{tp}.se.conv_expand", q["se"]["expand"])
            b += 1
        s += 1
    return sd


def _vit_backbone(p: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """The inverse of JAX ``import_vit``: timm's keys and layouts."""
    sd = {
        "cls_token": _vec(p["cls_token"]),
        "pos_embed": _vec(p["pos_embed"]),
        "patch_embed.proj.weight": _conv(p["patch_embed"]["kernel"]),
        "patch_embed.proj.bias": _vec(p["patch_embed"]["bias"]),
        "norm.weight": _vec(p["norm"]["scale"]),
        "norm.bias": _vec(p["norm"]["bias"]),
        "head.weight": _linear(p["head"]["kernel"]),
        "head.bias": _vec(p["head"]["bias"]),
    }
    i = 0
    while f"block{i}" in p:
        b, tp = p[f"block{i}"], f"blocks.{i}"
        attn = b["attn"]
        dim = np.shape(attn["query"]["kernel"])[0]
        # (D, heads, hd) each -> (D, 3 D) with columns q | k | v -> (3 D, D)
        sd[f"{tp}.attn.qkv.weight"] = _linear(np.concatenate(
            [np.asarray(attn[n]["kernel"], np.float32).reshape(dim, -1)
             for n in ("query", "key", "value")], axis=1))
        sd[f"{tp}.attn.qkv.bias"] = np.concatenate(
            [_vec(attn[n]["bias"]).reshape(-1) for n in ("query", "key", "value")])
        # (heads, hd, D) -> (D_in, D) -> (D, D_in)
        sd[f"{tp}.attn.proj.weight"] = _linear(
            np.asarray(attn["out"]["kernel"], np.float32).reshape(-1, dim))
        sd[f"{tp}.attn.proj.bias"] = _vec(attn["out"]["bias"])
        for norm in ("norm1", "norm2"):
            sd[f"{tp}.{norm}.weight"] = _vec(b[norm]["scale"])
            sd[f"{tp}.{norm}.bias"] = _vec(b[norm]["bias"])
        for fc in ("fc1", "fc2"):
            sd[f"{tp}.mlp.{fc}.weight"] = _linear(b[f"mlp_{fc}"]["kernel"])
            sd[f"{tp}.mlp.{fc}.bias"] = _vec(b[f"mlp_{fc}"]["bias"])
        i += 1
    return sd


def _with_heads(params: Mapping[str, Any], backbone) -> dict[str, np.ndarray]:
    """A deep-supervised tree (``backbone`` + ``aux_head{i}``) or a bare
    backbone, through ``backbone(tree)``."""
    if "backbone" not in params:
        return backbone(params)
    sd = {f"backbone.{k}": v for k, v in backbone(params["backbone"]).items()}
    i = 0
    while f"aux_head{i}" in params:
        head = params[f"aux_head{i}"]
        sd[f"aux_head{i}.weight"] = _linear(head["kernel"])
        sd[f"aux_head{i}.bias"] = _vec(head["bias"])
        i += 1
    return sd


def _tensors(sd: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def convnext_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The port's state dict for the flax ``params`` tree (any tree of that
    shape: parameters, EMA, Adam moments)."""
    return _tensors(_with_heads(params, _backbone))


def efficientnet_state_dict_from_jax(
        params: Mapping[str, Any],
        batch_stats: Mapping[str, Any] | None = None) -> dict[str, torch.Tensor]:
    """The port's state dict for a flax EfficientNet's ``params`` and
    ``batch_stats`` (``export_efficientnet``'s keys and tensors); without
    ``batch_stats``, the parameters' keys only."""
    if batch_stats is not None and "backbone" in batch_stats:
        batch_stats = batch_stats["backbone"]
    return _tensors(_with_heads(params, lambda p: _effnet_backbone(p, batch_stats)))


def vit_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The port's state dict for a flax ViT/DeiT ``params`` tree (any tree
    of that shape), deep-supervision heads included."""
    return _tensors(_with_heads(params, _vit_backbone))


def state_dict_from_jax(params: Mapping[str, Any],
                        batch_stats: Mapping[str, Any] | None = None
                        ) -> dict[str, torch.Tensor]:
    """The carrier for the tree's family (a ViT has a ``cls_token``, an
    EfficientNet a stem BatchNorm, ConvNeXt a stem LayerNorm)."""
    tree = params.get("backbone", params)
    if "cls_token" in tree:
        return vit_state_dict_from_jax(params)
    if "stem_bn" in tree:
        return efficientnet_state_dict_from_jax(params, batch_stats)
    return convnext_state_dict_from_jax(params)


def train_state_from_jax(model: torch.nn.Module, params: Mapping[str, Any],
                         ema: Mapping[str, Any] | None, mu: Mapping[str, Any],
                         nu: Mapping[str, Any], count: int, step: int,
                         batch_stats: Mapping[str, Any] | None = None,
                         swa: Mapping[str, Any] | None = None, swa_count: int = 0):
    """The port's ``TrainState`` for the JAX package's (params, EMA, Adam
    mu/nu, Adam count, step, and for an EfficientNet batch_stats, SWA's
    average and count): ``params`` and ``batch_stats`` load into ``model``
    with ``strict=True``; the other trees go to the device of its
    parameters."""
    from image_classification_tpu_torch.train.train_state import TrainState

    model.load_state_dict(state_dict_from_jax(params, batch_stats), strict=True)
    names = [n for n, _ in model.named_parameters()]
    device = next(model.parameters()).device

    def aligned(tree):
        sd = state_dict_from_jax(tree)
        if set(sd) != set(names):
            raise ValueError("tree does not match the model's parameters")
        # copies: the step updates these in place, and the arrays may be
        # the caller's (or views of JAX buffers)
        return [sd[n].to(device, copy=True) for n in names]

    return TrainState(step=int(step), model=model, mu=aligned(mu),
                      nu=aligned(nu), count=int(count),
                      ema=None if ema is None else aligned(ema),
                      swa=None if swa is None else aligned(swa),
                      swa_count=int(swa_count))


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The tensors of a ``.pt``/``.pth`` or ``.safetensors`` file, with a
    nested ``model_state_dict``/``state_dict``/``model`` unwrapped."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return dict(load_file(path))
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for wrap in ("model_state_dict", "state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(wrap), dict):
            obj = obj[wrap]
    return {k: torch.as_tensor(v) for k, v in obj.items()}


@torch.no_grad()
def load_checkpoint_into(model: torch.nn.Module, path: str,
                         strip_head: bool = False) -> int:
    """Copy the timm-keyed tensors of ``path`` into ``model``'s parameters
    and BatchNorm statistics in place; returns how many were loaded.
    ``dwconv`` is read as ``conv_dw``; keys the model does not have (timm's
    ``num_batches_tracked``) are skipped."""
    sd = load_state_dict(path)
    if strip_head:
        sd = {k: v for k, v in sd.items() if k not in _HEAD_KEYS}
    params = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    prefix = "backbone." if any(k.startswith("backbone.") for k in params) else ""
    n = 0
    for key, val in sd.items():
        target = params.get(prefix + key.replace(".dwconv.", ".conv_dw."))
        if target is None:
            continue
        if tuple(target.shape) != tuple(val.shape):
            logger.warning("skip %s: shape %s vs %s (classifier-strip semantics)",
                           key, tuple(val.shape), tuple(target.shape))
            continue
        target.copy_(val.to(target.dtype))
        n += 1
    logger.info("loaded %d tensors from %s", n, path)
    if n == 0:
        logger.warning("no tensors matched; check checkpoint naming")
    return n
