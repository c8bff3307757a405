"""The weight carrier: flax ConvNeXt variables -> the port's state dict.

``convnext_state_dict_from_jax(params)`` takes the flax ``params`` collection
as nested dicts of arrays (numpy, or anything ``np.asarray`` reads) and
returns the state dict of the port's model, which loads with
``strict=True``. With deep supervision the tree holds ``backbone/...`` and
``aux_head{i}``; those heads, which the JAX package's ``export_convnext``
leaves out, map to ``aux_head{i}.{weight,bias}``. The backbone keys and
tensors equal ``export_convnext``'s: flax conv kernels HWIO become OIHW (the
depthwise ``(7, 7, 1, C)`` becomes ``(C, 1, 7, 7)``) and Dense ``(in, out)``
becomes Linear ``(out, in)``. Depths are read from the tree.

``load_pretrained_into(model, cfg)`` imports a local timm-keyed checkpoint
file (``cfg.pretrained_path``) into a freshly initialised model, as the JAX
package's ``load_checkpoint_into_variables`` does: nested
``model_state_dict``/``state_dict``/``model`` entries are unwrapped, the
classifier keys are dropped with ``pretrained_strip_head``, tensors whose
shapes differ from the model's are skipped, the backbone of a
deep-supervised model takes the timm keys (its aux heads keep their init),
and a missing file leaves the random init with a warning.

``train_state_from_jax`` carries a whole train state the same way: the
parameters, the EMA shadow and Adam's ``mu`` and ``nu`` (trees shaped like
the parameters) become tensors aligned with ``model.named_parameters()``,
and the counters become host integers, so both frameworks can start from
one non-trivial optimizer state.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Mapping

import numpy as np
import torch

logger = logging.getLogger("ic_tpu_torch")

# The final classifier's keys (what timm strips when num_classes differs).
_HEAD_KEYS = ("head.fc.weight", "head.fc.bias")


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


def convnext_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The port's state dict for the flax ``params`` tree (any tree of that
    shape: parameters, EMA, Adam moments)."""
    if "backbone" in params:
        sd = {f"backbone.{k}": v for k, v in _backbone(params["backbone"]).items()}
        i = 0
        while f"aux_head{i}" in params:
            head = params[f"aux_head{i}"]
            sd[f"aux_head{i}.weight"] = _linear(head["kernel"])
            sd[f"aux_head{i}.bias"] = _vec(head["bias"])
            i += 1
    else:
        sd = _backbone(params)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def train_state_from_jax(model: torch.nn.Module, params: Mapping[str, Any],
                         ema: Mapping[str, Any] | None, mu: Mapping[str, Any],
                         nu: Mapping[str, Any], count: int, step: int):
    """The port's ``TrainState`` for the JAX package's (params, EMA, Adam
    mu/nu, Adam count, step): ``params`` load into ``model`` with
    ``strict=True``; the other trees go to the device of its parameters."""
    from image_classification_tpu_torch.train.train_state import TrainState

    model.load_state_dict(convnext_state_dict_from_jax(params), strict=True)
    names = [n for n, _ in model.named_parameters()]
    device = next(model.parameters()).device

    def aligned(tree):
        sd = convnext_state_dict_from_jax(tree)
        if set(sd) != set(names):
            raise ValueError("tree does not match the model's parameters")
        # copies: the step updates these in place, and the arrays may be
        # the caller's (or views of JAX buffers)
        return [sd[n].to(device, copy=True) for n in names]

    return TrainState(step=int(step), model=model, mu=aligned(mu),
                      nu=aligned(nu), count=int(count),
                      ema=None if ema is None else aligned(ema))


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
    """Copy the timm-keyed tensors of ``path`` into ``model`` in place;
    returns how many were loaded. ``dwconv`` is read as ``conv_dw``."""
    sd = load_state_dict(path)
    if strip_head:
        sd = {k: v for k, v in sd.items() if k not in _HEAD_KEYS}
    params = dict(model.named_parameters())
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
