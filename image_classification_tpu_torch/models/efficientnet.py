"""EfficientNet (V1 B0-B4) and EfficientNetV2-S, channels-last.

Port of ``image_classification_tpu/models/efficientnet.py``: a 3x3/2 stem
conv + BN + silu, stages of MBConv blocks (expand 1x1 -> depthwise kxk ->
squeeze-excite -> project 1x1, or V2-S's fused kxk expand), a 1x1 head conv
+ BN + silu, global average pooling, dropout and an f32 classifier. Every
conv has flax's SAME padding (``layers.conv_nhwc``) and runs as
``F.conv2d`` on cuDNN: the JAX package computes them with ``lax.conv``, and
no Pallas kernel. BatchNorm is flax's (``layers.BatchNorm``), with its
running statistics in the module's buffers.

Module names are timm's, so ``state_dict()`` keys are those the JAX
package's ``export_efficientnet`` writes: ``conv_stem``, ``bn1``,
``conv_head``, ``bn2``, ``classifier`` and ``blocks.{s}.{b}.`` in one of four
block forms (``MBConv``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from image_classification_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    DropPath,
    Dropout,
    SqueezeExcite,
    drop_path_rates,
    global_avg_pool,
    lecun_normal_,
)

# (width_mult, depth_mult, default_res, dropout)
EFFNET_V1_SCALING = {
    "efficientnet_b0": (1.0, 1.0, 224, 0.2),
    "efficientnet_b1": (1.0, 1.1, 240, 0.2),
    "efficientnet_b2": (1.1, 1.2, 260, 0.3),
    "efficientnet_b3": (1.2, 1.4, 300, 0.3),
    "efficientnet_b4": (1.4, 1.8, 380, 0.4),
}

# base B0 stage spec: (expand, channels, blocks, stride, kernel)
_V1_STAGES = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]

# EfficientNetV2-S: (expand, channels, blocks, stride, kernel, fused, se)
_V2_S_STAGES = [
    (1, 24, 2, 1, 3, True, False),
    (4, 48, 4, 2, 3, True, False),
    (4, 64, 4, 2, 3, True, False),
    (4, 128, 6, 2, 3, False, True),
    (6, 160, 9, 1, 3, False, True),
    (6, 256, 15, 2, 3, False, True),
]


def round_channels(c: float, mult: float, divisor: int = 8) -> int:
    c *= mult
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return new_c


def round_repeats(r: int, mult: float) -> int:
    return int(math.ceil(mult * r))


class StageSpec(NamedTuple):
    expand: int
    channels: int
    blocks: int
    stride: int
    kernel: int
    fused: bool
    se: bool


class MBConv(nn.Module):
    """One block, in timm's four forms (names as ``export_efficientnet``
    writes them):

    - EdgeResidual (fused, expand > 1): ``conv_exp`` kxk/s + ``bn1`` + silu,
      [``se``], ``conv_pwl`` 1x1 + ``bn2``;
    - ConvBnAct (fused, expand 1): [``se``], ``conv`` kxk/s + ``bn1`` + silu;
    - InvertedResidual (expand > 1): ``conv_pw`` 1x1 + ``bn1`` + silu,
      ``conv_dw`` kxk/s depthwise + ``bn2`` + silu, [``se``], ``conv_pwl``
      1x1 + ``bn3``;
    - DepthwiseSeparable (expand 1): ``conv_dw`` + ``bn1`` + silu, [``se``],
      ``conv_pw`` 1x1 + ``bn2``.

    The SE hidden width is ``max(1, in_ch // 4)`` of the block's input. The
    residual, with DropPath on the branch, is there only when ``stride ==
    1 and in_ch == out_ch``."""

    def __init__(self, in_ch: int, out_ch: int, expand: int, kernel: int,
                 stride: int, fused: bool = False, use_se: bool = True,
                 drop_path: float = 0.0):
        super().__init__()
        mid = in_ch * expand
        self.fused, self.expand = fused, expand
        k, s = kernel, stride
        if fused and expand != 1:
            self.conv_exp, self.bn1 = Conv(in_ch, mid, k, s), BatchNorm(mid)
            self.conv_pwl, self.bn2 = Conv(mid, out_ch, 1), BatchNorm(out_ch)
        elif fused:
            self.conv, self.bn1 = Conv(in_ch, out_ch, k, s), BatchNorm(out_ch)
        elif expand != 1:
            self.conv_pw, self.bn1 = Conv(in_ch, mid, 1), BatchNorm(mid)
            self.conv_dw, self.bn2 = Conv(mid, mid, k, s, groups=mid), BatchNorm(mid)
            self.conv_pwl, self.bn3 = Conv(mid, out_ch, 1), BatchNorm(out_ch)
        else:
            self.conv_dw, self.bn1 = Conv(mid, mid, k, s, groups=mid), BatchNorm(mid)
            self.conv_pw, self.bn2 = Conv(mid, out_ch, 1), BatchNorm(out_ch)
        self.se = SqueezeExcite(mid, max(1, in_ch // 4)) if use_se else None
        self.has_residual = stride == 1 and in_ch == out_ch
        self.drop_path = DropPath(drop_path) if self.has_residual else None

    def _se(self, h: torch.Tensor) -> torch.Tensor:
        return h if self.se is None else self.se(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused and self.expand != 1:
            h = self._se(F.silu(self.bn1(self.conv_exp(x))))
            h = self.bn2(self.conv_pwl(h))
        elif self.fused:
            h = F.silu(self.bn1(self.conv(self._se(x))))
        elif self.expand != 1:
            h = F.silu(self.bn1(self.conv_pw(x)))
            h = self._se(F.silu(self.bn2(self.conv_dw(h))))
            h = self.bn3(self.conv_pwl(h))
        else:
            h = self._se(F.silu(self.bn1(self.conv_dw(x))))
            h = self.bn2(self.conv_pw(h))
        if self.has_residual:
            h = self.drop_path(h) + x
        return h


class EfficientNet(nn.Module):
    """NHWC input (B, H, W, 3) -> logits (B, num_classes) in f32; with
    ``return_features`` also the outputs of the last three stages (the
    deep-supervision taps). Activations are (B, H, W, C) tensors in
    ``dtype`` throughout; parameters stay f32."""

    def __init__(self, num_classes: int = 44, stages: tuple[StageSpec, ...] = (),
                 stem_ch: int = 32, head_ch: int = 1280, drop_rate: float = 0.2,
                 drop_path_rate: float = 0.0, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stage_channels = tuple(s.channels for s in stages)
        self.conv_stem, self.bn1 = Conv(3, stem_ch, 3, 2), BatchNorm(stem_ch)
        rates = drop_path_rates(drop_path_rate, tuple(s.blocks for s in stages))
        self.blocks = nn.ModuleList()
        cin = stem_ch
        for spec, stage_rates in zip(stages, rates):
            stage = nn.ModuleList()
            for b, rate in enumerate(stage_rates):
                stage.append(MBConv(cin, spec.channels, spec.expand, spec.kernel,
                                    spec.stride if b == 0 else 1, spec.fused,
                                    spec.se, rate))
                cin = spec.channels
            self.blocks.append(stage)
        self.conv_head, self.bn2 = Conv(cin, head_ch, 1), BatchNorm(head_ch)
        self.dropout = Dropout(drop_rate, head_ch)
        self.classifier = nn.Linear(head_ch, num_classes)

    @property
    def feature_dims(self) -> tuple[int, ...]:
        return self.stage_channels[-3:]

    def forward(self, x: torch.Tensor, return_features: bool = False):
        x = F.silu(self.bn1(self.conv_stem(x.to(self.dtype))))
        features = []
        for stage in self.blocks:
            for block in stage:
                x = block(x)
            features.append(x)
        x = F.silu(self.bn2(self.conv_head(x)))
        x = self.dropout(global_avg_pool(x))
        # the classifier runs in f32 (the JAX model's Dense, dtype f32)
        logits = (torch.matmul(x.float(), self.classifier.weight.float().t())
                  + self.classifier.bias.float())
        return (logits, features[-3:]) if return_features else logits


def init_efficientnet_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's initialisation, in place: lecun-normal kernels (fan-in
    ``cin / groups * k * k``), zero biases, BN scale 1 and bias 0, running
    mean 0 and variance 1. Covers the deep-supervision heads too."""
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            lecun_normal_(mod.weight, mod.in_features, generator)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, Conv):
            w = mod.weight
            lecun_normal_(w, w.shape[1] * w.shape[2] * w.shape[3], generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, BatchNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
            nn.init.zeros_(mod.running_mean)
            nn.init.ones_(mod.running_var)
    return model


def efficientnet_base_name(name: str) -> str:
    """timm's name without its ``tf_`` prefix and weight-set suffixes."""
    base = name.split(".")[0].removeprefix("tf_")
    for suffix in ("_ns", "_ap", "_in21ft1k", "_in21k", "_in1k"):
        base = base.replace(suffix, "")
    return base


def build_efficientnet(name: str, num_classes: int, **kwargs) -> EfficientNet:
    """``efficientnet_b0``-``b4`` and ``efficientnetv2_s`` under timm's
    names. A V1 model's ``drop_rate`` defaults to its scaling row's; the
    factory always passes the configured one."""
    base = efficientnet_base_name(name)
    if base == "efficientnetv2_s":
        stages = tuple(StageSpec(*s) for s in _V2_S_STAGES)
        return EfficientNet(num_classes=num_classes, stages=stages, stem_ch=24,
                            head_ch=1280, **kwargs)
    if base in EFFNET_V1_SCALING:
        w, d, _res, drop = EFFNET_V1_SCALING[base]
        stages = tuple(StageSpec(e, round_channels(c, w), round_repeats(b, d), s, k,
                                 fused=False, se=True)
                       for (e, c, b, s, k) in _V1_STAGES)
        kwargs.setdefault("drop_rate", drop)
        return EfficientNet(num_classes=num_classes, stages=stages,
                            stem_ch=round_channels(32, w),
                            head_ch=round_channels(1280, w), **kwargs)
    raise ValueError(f"Unknown EfficientNet variant: {name}")
