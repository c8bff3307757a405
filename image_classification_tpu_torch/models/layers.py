"""Shared building blocks, channels-last (NHWC), as in
``image_classification_tpu/models/layers.py``.

Every module keeps f32 parameters (or the bf16 ones ``infer/predict.py``
casts to) and casts them to the activation's dtype at use. Stochastic depth
(``DropPath``) is not ported: it is the identity at inference, and
``models/factory.py:create_model`` refuses a configuration that trains with
it (V4 does not).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C): f32 sum, rounded to x's dtype (jnp.mean)."""
    return x.float().mean(dim=(1, 2)).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dim in f32, rounded to x's dtype (flax
    nn.LayerNorm with a low-precision ``dtype``)."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(),
                        bias.float(), eps).to(x.dtype)


def patch_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
               patch: int) -> torch.Tensor:
    """Stride-``patch`` conv with kernel ``patch`` and SAME padding, as
    space-to-depth + one matmul. ``x`` (B, H, W, Cin), ``weight`` in torch's
    OIHW layout (Cout, Cin, P, P). Odd sizes take flax's SAME padding (for
    P = 2: one row/column of zeros at the bottom/right), so 260 px gives
    stage sizes 65, 33, 17, 9. The product accumulates in f32 and is rounded
    to x's dtype before the bias is added, as in the JAX ``patch_conv``."""
    B, H, W, Cin = x.shape
    P = patch
    pads = []
    for n in (H, W):
        total = max((-(-n // P) - 1) * P + P - n, 0)
        pads.append((total // 2, total - total // 2))
    if any(p for pair in pads for p in pair):
        (top, bottom), (left, right) = pads
        x = F.pad(x, (0, 0, left, right, top, bottom))
    Hp, Wp = x.shape[1], x.shape[2]
    x = x.reshape(B, Hp // P, P, Wp // P, P, Cin).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, Hp // P, Wp // P, P * P * Cin)
    # (Cout, Cin, P, P) -> (Cout, P, P, Cin): the (i, j, c) order of x's
    # channels after the space-to-depth.
    w = weight.permute(0, 2, 3, 1).reshape(weight.shape[0], -1).to(x.dtype)
    out = torch.matmul(x, w.t())
    return out if bias is None else out + bias.to(out.dtype)


class PatchConv(nn.Module):
    """Params of ``nn.Conv2d(cin, cout, patch, stride=patch)`` (timm keys
    ``weight``, ``bias``), forward through :func:`patch_conv` on NHWC."""

    def __init__(self, cin: int, cout: int, patch: int):
        super().__init__()
        self.patch = patch
        self.weight = nn.Parameter(torch.zeros(cout, cin, patch, patch))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return patch_conv(x, self.weight, self.bias, self.patch)


class LayerNorm(nn.Module):
    """Channels-last LayerNorm, eps 1e-6 (timm keys ``weight``, ``bias``)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated normal at +-2 std, variance 1/fan_in
    after truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
