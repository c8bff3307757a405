"""EfficientNetV2-S, as plain PyTorch over a dict of tensors, for the
benchmark's reference.

Tan & Le 2021, "EfficientNetV2" (timm ``tf_efficientnetv2_s``): a 3x3/2 stem
conv (24) + BatchNorm + SiLU; six stages of blocks (expand, channels,
blocks, stride, fused, squeeze-excite): (1, 24, 2, 1, fused), (4, 48, 4, 2,
fused), (4, 64, 4, 2, fused), (4, 128, 6, 2, SE), (6, 160, 9, 1, SE),
(6, 256, 15, 2, SE), all 3x3; a 1x1 head conv (1280) + BatchNorm + SiLU,
global average pool, dropout and a linear classifier. A fused block is a
kxk conv (expanding where expand > 1) then a 1x1 projection; the others a
1x1 expansion, a kxk depthwise conv, SE, a 1x1 projection. The SE gate
pools, reduces to a quarter of the block's input width with SiLU, expands
with a sigmoid and scales. A block with stride 1 and equal widths adds its
input, its branch under drop-path (rates rising linearly over all blocks).
Convs pad as TensorFlow's SAME (the extra pixel at the bottom and right).
BatchNorm normalises with the batch's mean and biased variance, eps 1e-3.

``masks`` holds one keep-mask per drop site, in the forward's order (the
residual blocks with a positive rate, then the head's dropout); a kept
value is divided by ``1 - rate``. Parameter and buffer names are timm's,
so the same tensors load into the program with ``strict=True``. ``quant``
rounds both operands of every conv and matmul (the control)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

# (expand, channels, blocks, stride, kernel, fused, se)
STAGES = ((1, 24, 2, 1, 3, True, False), (4, 48, 4, 2, 3, True, False),
          (4, 64, 4, 2, 3, True, False), (4, 128, 6, 2, 3, False, True),
          (6, 160, 9, 1, 3, False, True), (6, 256, 15, 2, 3, False, True))
STEM, HEAD, EPS = 24, 1280, 1e-3


def check_model(cfg: dict) -> None:
    if cfg["model_name"] != "tf_efficientnetv2_s":
        raise ValueError(f"the reference has no {cfg['model_name']}")


def blocks(cfg: dict):
    """(name, in, out, expand, kernel, stride, fused, se, drop-path rate) of
    every block, in order."""
    check_model(cfg)
    n = sum(s[2] for s in STAGES)
    out, i, cin = [], 0, STEM
    for s, (e, c, nb, st, k, fused, se) in enumerate(STAGES):
        for b in range(nb):
            rate = cfg["drop_path_rate"] * i / max(1, n - 1)
            out.append((f"blocks.{s}.{b}", cin, c, e, k, st if b == 0 else 1, fused, se, rate))
            cin, i = c, i + 1
    return out


def drop_sites(cfg: dict, rows: int) -> list[tuple[tuple[int, ...], float]]:
    """(mask shape, rate) of every drop site, in the forward's order."""
    sites = [((rows,), r) for _, cin, cout, _, _, st, _, _, r in blocks(cfg)
             if st == 1 and cin == cout and r > 0]
    if cfg["drop_rate"] > 0:
        sites.append(((rows, HEAD), cfg["drop_rate"]))
    return sites


def param_spec(cfg: dict) -> list[tuple[str, tuple[int, ...], str, int]]:
    """(name, shape, kind, fan_in) of every parameter and BatchNorm buffer."""
    out: list = []

    def conv(name, cout, cin, k, groups=1, bias=False):
        out.append((f"{name}.weight", (cout, cin // groups, k, k), "matrix", cin // groups * k * k))
        if bias:
            out.append((f"{name}.bias", (cout,), "bias", 0))

    def bn(name, c):
        out.extend([(f"{name}.weight", (c,), "ln_w", 0), (f"{name}.bias", (c,), "ln_b", 0),
                    (f"{name}.running_mean", (c,), "zeros", 0),
                    (f"{name}.running_var", (c,), "ones", 0)])

    conv("conv_stem", STEM, 3, 3)
    bn("bn1", STEM)
    for name, cin, cout, e, k, st, fused, se, _ in blocks(cfg):
        mid = cin * e
        if fused and e != 1:
            conv(f"{name}.conv_exp", mid, cin, k)
            bn(f"{name}.bn1", mid)
        elif fused:
            conv(f"{name}.conv", cout, cin, k)
            bn(f"{name}.bn1", cout)
        else:
            conv(f"{name}.conv_pw", mid, cin, 1)
            bn(f"{name}.bn1", mid)
            conv(f"{name}.conv_dw", mid, mid, k, groups=mid)
            bn(f"{name}.bn2", mid)
        if se:
            conv(f"{name}.se.conv_reduce", max(1, cin // 4), mid, 1, bias=True)
            conv(f"{name}.se.conv_expand", mid, max(1, cin // 4), 1, bias=True)
        if e != 1 or not fused:
            conv(f"{name}.conv_pwl", cout, mid, 1)
            bn(f"{name}.bn2" if fused else f"{name}.bn3", cout)
    conv("conv_head", HEAD, STAGES[-1][1], 1)
    bn("bn2", HEAD)
    out.append(("classifier.weight", (cfg["num_classes"], HEAD), "matrix", HEAD))
    out.append(("classifier.bias", (cfg["num_classes"],), "bias", 0))
    return out



def _id(t):
    return t


def _conv(x, w, stride, groups, q, bias=None):
    k = w.shape[-1]
    pads = []
    for n in (x.shape[3], x.shape[2]):       # width, then height, as F.pad reads them
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(q(F.pad(x, pads)), q(w), bias, stride, 0, 1, groups)


def _bn(x, p, name):
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = (x * x).mean(dim=(0, 2, 3), keepdim=True) - mean * mean
    y = (x - mean) * torch.rsqrt(var.clamp_min(0.0) + EPS)
    return y * p[f"{name}.weight"][None, :, None, None] + p[f"{name}.bias"][None, :, None, None]


def _drop(x, mask, rate):
    mask = mask.reshape(*mask.shape, *[1] * (x.dim() - mask.dim()))
    return torch.where(mask, x / (1.0 - rate), 0.0)


def forward(p: dict, x: torch.Tensor, cfg: dict, masks=(), quant=None) -> list[torch.Tensor]:
    """NHWC images (B, H, W, 3) -> [logits] in f32, BatchNorm on the
    batch's statistics (train mode)."""
    q = quant or _id
    masks = list(masks)
    x = F.silu(_bn(_conv(x.permute(0, 3, 1, 2), p["conv_stem.weight"], 2, 1, q), p, "bn1"))
    for name, cin, cout, e, k, st, fused, se, rate in blocks(cfg):
        mid = cin * e

        def se_gate(h):
            if not se:
                return h
            s = h.mean(dim=(2, 3))
            s = F.silu(F.linear(q(s), q(p[f"{name}.se.conv_reduce.weight"].flatten(1)),
                                p[f"{name}.se.conv_reduce.bias"]))
            s = torch.sigmoid(F.linear(q(s), q(p[f"{name}.se.conv_expand.weight"].flatten(1)),
                                       p[f"{name}.se.conv_expand.bias"]))
            return h * s[:, :, None, None]

        if fused and e != 1:
            h = se_gate(F.silu(_bn(_conv(x, p[f"{name}.conv_exp.weight"], st, 1, q), p,
                                   f"{name}.bn1")))
            h = _bn(_conv(h, p[f"{name}.conv_pwl.weight"], 1, 1, q), p, f"{name}.bn2")
        elif fused:
            h = F.silu(_bn(_conv(se_gate(x), p[f"{name}.conv.weight"], st, 1, q), p,
                           f"{name}.bn1"))
        else:
            h = F.silu(_bn(_conv(x, p[f"{name}.conv_pw.weight"], 1, 1, q), p, f"{name}.bn1"))
            h = se_gate(F.silu(_bn(_conv(h, p[f"{name}.conv_dw.weight"], st, mid, q), p,
                                   f"{name}.bn2")))
            h = _bn(_conv(h, p[f"{name}.conv_pwl.weight"], 1, 1, q), p, f"{name}.bn3")
        if st == 1 and cin == cout:
            if rate > 0:
                h = _drop(h, masks.pop(0), rate)
            h = h + x
        x = h
    x = F.silu(_bn(_conv(x, p["conv_head.weight"], 1, 1, q), p, "bn2"))
    x = x.mean(dim=(2, 3))
    if cfg["drop_rate"] > 0:
        x = _drop(x, masks.pop(0), cfg["drop_rate"])
    if masks:
        raise ValueError(f"{len(masks)} drop masks left over")
    return [F.linear(q(x), q(p["classifier.weight"]), p["classifier.bias"])]
