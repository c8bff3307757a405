"""ConvNeXt with deep supervision, as plain PyTorch over a dict of tensors,
for the benchmark's reference.

Liu et al. 2022, "A ConvNet for the 2020s" (timm ``convnext_base``): a 4x4/4
patchify stem and LayerNorm; four stages, each (after the first) opened by a
LayerNorm and a 2x2/2 conv; blocks of 7x7 depthwise conv -> LayerNorm ->
Linear(C, 4C) -> exact GELU -> Linear(4C, C) -> layer scale -> residual; a
global average pool -> LayerNorm -> Linear head. LayerNorm's eps is 1e-6.
The recipe's departures, which the configuration runs: a 2x2/2 conv on an
odd size pads one row and column at the bottom and right (flax's SAME), so
260 px gives 65, 33, 17 and 9; with ``use_deep_supervision`` each of stages
1-3 adds a global-average-pool -> Linear head (the loss:
``reference/train.py:per_row_loss``). No drop-path or dropout: the
configurations it serves have none.

Parameter names are timm's under ``backbone.`` (the aux heads beside it),
so the same tensors load into the program with ``strict=True``.
``quant`` rounds both operands of every conv and matmul (the control's
lower precision, ``benchmark/reference/quant.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

CONFIGS = {
    "convnext_atto": ((2, 2, 6, 2), (40, 80, 160, 320)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
}
EPS = 1e-6


def arch(cfg: dict) -> tuple[tuple[int, ...], tuple[int, ...]]:
    if cfg["model_name"] not in CONFIGS:
        raise ValueError(f"the reference has no {cfg['model_name']}")
    return CONFIGS[cfg["model_name"]]


def param_spec(cfg: dict) -> list[tuple[str, tuple[int, ...], str, int]]:
    """(name, shape, kind, fan_in) of every parameter: kind is ``matrix``
    (a conv or linear weight), ``bias``, ``ln_w``, ``ln_b`` or ``gamma``."""
    depths, dims = arch(cfg)
    k = cfg["num_classes"]
    out: list = []

    def conv(name, cout, cin, p):
        out.append((f"{name}.weight", (cout, cin, p, p), "matrix", cin * p * p))
        out.append((f"{name}.bias", (cout,), "bias", 0))

    def ln(name, c):
        out.append((f"{name}.weight", (c,), "ln_w", 0))
        out.append((f"{name}.bias", (c,), "ln_b", 0))

    def linear(name, cout, cin):
        out.append((f"{name}.weight", (cout, cin), "matrix", cin))
        out.append((f"{name}.bias", (cout,), "bias", 0))

    b = "backbone." if cfg["use_deep_supervision"] else ""
    conv(f"{b}stem.0", dims[0], 3, 4)
    ln(f"{b}stem.1", dims[0])
    for i, (depth, c) in enumerate(zip(depths, dims)):
        s = f"{b}stages.{i}"
        if i > 0:
            ln(f"{s}.downsample.0", dims[i - 1])
            conv(f"{s}.downsample.1", c, dims[i - 1], 2)
        for j in range(depth):
            blk = f"{s}.blocks.{j}"
            out.append((f"{blk}.conv_dw.weight", (c, 1, 7, 7), "matrix", 49))
            out.append((f"{blk}.conv_dw.bias", (c,), "bias", 0))
            ln(f"{blk}.norm", c)
            linear(f"{blk}.mlp.fc1", 4 * c, c)
            linear(f"{blk}.mlp.fc2", c, 4 * c)
            out.append((f"{blk}.gamma", (c,), "gamma", 0))
    ln(f"{b}head.norm", dims[-1])
    linear(f"{b}head.fc", k, dims[-1])
    if cfg["use_deep_supervision"]:
        for i, c in enumerate(dims[1:]):
            linear(f"aux_head{i}", k, c)
    return out


def _id(t: torch.Tensor) -> torch.Tensor:
    return t


def _ln_nchw(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    y = F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), w, b, EPS)
    return y.permute(0, 3, 1, 2)


def forward(p: dict, x: torch.Tensor, cfg: dict, masks=(), quant=None) -> list[torch.Tensor]:
    """NHWC images (B, H, W, 3) -> [main logits, aux logits...] in f32."""
    if masks:
        raise ValueError("the reference ConvNeXt has no drop-path or dropout")
    q = quant or _id
    depths, dims = arch(cfg)
    b = "backbone." if cfg["use_deep_supervision"] else ""
    x = x.permute(0, 3, 1, 2)
    x = F.conv2d(q(x), q(p[f"{b}stem.0.weight"]), p[f"{b}stem.0.bias"], stride=4)
    x = _ln_nchw(x, p[f"{b}stem.1.weight"], p[f"{b}stem.1.bias"])
    taps = []
    for i, (depth, c) in enumerate(zip(depths, dims)):
        s = f"{b}stages.{i}"
        if i > 0:
            x = _ln_nchw(x, p[f"{s}.downsample.0.weight"], p[f"{s}.downsample.0.bias"])
            x = F.pad(x, (0, x.shape[3] % 2, 0, x.shape[2] % 2))   # SAME, 2x2/2
            x = F.conv2d(q(x), q(p[f"{s}.downsample.1.weight"]),
                         p[f"{s}.downsample.1.bias"], stride=2)
        for j in range(depth):
            blk = f"{s}.blocks.{j}"
            y = F.conv2d(q(x), q(p[f"{blk}.conv_dw.weight"]), p[f"{blk}.conv_dw.bias"],
                         padding=3, groups=c)
            y = F.layer_norm(y.permute(0, 2, 3, 1), (c,), p[f"{blk}.norm.weight"],
                             p[f"{blk}.norm.bias"], EPS)
            y = F.linear(q(y), q(p[f"{blk}.mlp.fc1.weight"]), p[f"{blk}.mlp.fc1.bias"])
            y = F.gelu(y)
            y = F.linear(q(y), q(p[f"{blk}.mlp.fc2.weight"]), p[f"{blk}.mlp.fc2.bias"])
            x = x + (y * p[f"{blk}.gamma"]).permute(0, 3, 1, 2)
        if i > 0:
            taps.append(x)
    pooled = F.layer_norm(x.mean(dim=(2, 3)), (dims[-1],), p[f"{b}head.norm.weight"],
                          p[f"{b}head.norm.bias"], EPS)
    outs = [F.linear(q(pooled), q(p[f"{b}head.fc.weight"]), p[f"{b}head.fc.bias"])]
    if cfg["use_deep_supervision"]:
        for i, t in enumerate(taps):
            outs.append(F.linear(q(t.mean(dim=(2, 3))), q(p[f"aux_head{i}.weight"]),
                                 p[f"aux_head{i}.bias"]))
    return outs
