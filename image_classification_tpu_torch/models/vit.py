"""Vision Transformer (ViT / DeiT), channels-last input, port of
``image_classification_tpu/models/vit.py``.

Patch embed (a stride-16 conv as space-to-depth + one matmul), a cls token,
learned position embeddings, pre-LN transformer blocks and an f32 head on
the cls token. DeiT is the same architecture (the ensemble uses no
distillation token). Parameter names are timm's (``cls_token``,
``pos_embed``, ``patch_embed.proj``,
``blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}``, ``norm``,
``head``) in torch layouts, so a timm checkpoint loads by name.

The arithmetic is flax's ``MultiHeadDotProductAttention`` in the working
dtype: q, k and v are products rounded to the dtype with the bias added
after; q is divided by ``sqrt(head_dim)`` rounded to the dtype before
q·kᵀ; softmax of the dtype scores, rounded to the dtype; the attention
dropout; weights·v; the output projection. Those products and the softmax
are plain ``torch.matmul`` / ``torch.softmax``, as they are XLA ops outside
any Pallas kernel in the JAX package (``F.scaled_dot_product_attention``
scales after the product, runs its softmax in f32 and cannot take flax's
broadcast dropout mask). The MLP's exact GELU is ``ops.gelu``, the A&S erf
that JAX's ``gelu_exact`` computes: on the card its Triton kernels, forward
and backward, at (B·N, 4·D).

Dropout sites, registered in the order JAX draws their keys: the token
dropout (B, N, D) after the position embedding, then per block the
attention dropout (1, 1, N, N) and two DropPaths (the attention branch's,
then the MLP branch's), each with its own mask.

``pos_embed`` is sized from ``image_size`` when the model is built (JAX
sizes it at ``init``). A side that is not a multiple of the patch raises
``ValueError``: the JAX model raises ``TypeError`` there (its patch conv
falls back to a SAME conv whose patches do not reshape to (H//P)·(W//P)
tokens), which is why V2's ViT members fail at its 60x80.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from image_classification_tpu_torch.models.layers import (
    AttentionDropout,
    Dropout,
    DropPath,
    LayerNorm,
    PatchConv,
    copy_to_model,
    dense,
    dense_row_parallel,
    drop_path_rates,
    init_flax_,
)
from image_classification_tpu_torch.ops import gelu

VIT_CONFIGS: dict[str, dict] = {
    "vit_tiny_patch16_224": dict(patch=16, dim=192, depth=12, heads=3),
    "vit_small_patch16_224": dict(patch=16, dim=384, depth=12, heads=6),
    "vit_base_patch16_224": dict(patch=16, dim=768, depth=12, heads=12),
    "vit_large_patch16_224": dict(patch=16, dim=1024, depth=24, heads=16),
    "deit_tiny_patch16_224": dict(patch=16, dim=192, depth=12, heads=3),
    "deit_small_patch16_224": dict(patch=16, dim=384, depth=12, heads=6),
    "deit_base_patch16_224": dict(patch=16, dim=768, depth=12, heads=12),
}


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   attn_drop: AttentionDropout) -> torch.Tensor:
    """(B, heads, N, hd) q, k, v -> (B, heads, N, hd): q divided by
    sqrt(hd) rounded to the dtype, q·kᵀ, softmax, the attention dropout,
    weights·v, each rounded to the dtype (flax's
    ``dot_product_attention``)."""
    q = q / float(torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype))
    w = torch.softmax(torch.matmul(q, k.transpose(-2, -1)), dim=-1).to(q.dtype)
    return torch.matmul(attn_drop(w), v)


class Attention(nn.Module):
    """Multi-head self-attention with timm's parameters (``qkv`` fused as
    (3·D, D), rows q, k, v, each head-major; ``proj``)."""

    def __init__(self, dim: int, heads: int, tokens: int, drop_rate: float = 0.0):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.attn_drop = AttentionDropout(drop_rate, tokens)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        hd = D // self.heads
        qkv = dense(x, self.qkv).view(B, N, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        o = attention_core(qkv[0], qkv[1], qkv[2], self.attn_drop)
        return dense(o.transpose(1, 2).reshape(B, N, D), self.proj)


class Mlp(nn.Module):
    group = None   # the model group when fc1/fc2 are split (parallel/shardings.py)

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = dense(copy_to_model(x, self.group), self.fc1)
        h = gelu(h.reshape(-1, h.shape[-1])).view(h.shape)
        return dense_row_parallel(h, self.fc2, self.group)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, tokens: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, drop_rate: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, heads, tokens, drop_rate)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path1(self.attn(self.norm1(x)))
        return x + self.drop_path2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = PatchConv(3, dim, patch)


class VisionTransformer(nn.Module):
    """NHWC input (B, H, W, 3) -> logits (B, num_classes) in f32; with
    ``return_features`` also the token sequences after blocks
    ``depth//2``, ``3*depth//4`` and ``depth-1`` (a set: 3 taps at depth 12,
    2 at depth 4, 1 at depth 2), the deep-supervision taps."""

    def __init__(self, num_classes: int = 44, patch: int = 16, dim: int = 768,
                 depth: int = 12, heads: int = 12, mlp_ratio: float = 4.0,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16,
                 image_size: tuple[int, int] = (224, 224)):
        super().__init__()
        H, W = image_size
        if H % patch or W % patch:
            raise ValueError(f"ViT: image size {H}x{W} is not a multiple of its "
                             f"{patch}-pixel patch (the JAX model raises TypeError "
                             "there)")
        self.patch, self.dim, self.dtype = patch, dim, dtype
        tokens = (H // patch) * (W // patch) + 1
        self.taps = sorted({depth // 2, 3 * depth // 4, depth - 1})
        self.patch_embed = PatchEmbed(dim, patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, dim))
        self.pos_drop = Dropout(drop_rate, (tokens, dim))
        dp = drop_path_rates(drop_path_rate, (depth,))[0]
        self.blocks = nn.ModuleList(
            TransformerBlock(dim, heads, tokens, mlp_ratio, dp[i], drop_rate)
            for i in range(depth))
        self.norm = LayerNorm(dim)
        self.head = nn.Linear(dim, num_classes)

    @property
    def feature_dims(self) -> tuple[int, ...]:
        return (self.dim,) * len(self.taps)

    def forward(self, x: torch.Tensor, return_features: bool = False):
        B = x.shape[0]
        x = self.patch_embed.proj(x.to(self.dtype)).reshape(B, -1, self.dim)
        cls = self.cls_token.to(self.dtype).expand(B, 1, self.dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        x = self.pos_drop(x)
        features = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in self.taps:
                features.append(x)
        x = self.norm(x)
        # the classifier runs in f32 on the cls token (JAX: Dense, dtype f32)
        logits = (torch.matmul(x[:, 0].float(), self.head.weight.float().t())
                  + self.head.bias.float())
        return (logits, features) if return_features else logits


def init_vit_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's initialisation, in place: ``cls_token`` and ``pos_embed``
    first, from ``truncated_normal(0.02)`` (0.02 times a normal truncated at
    ±2, not rescaled), then ``layers.init_flax_``: lecun-normal Dense
    kernels with flax's fan-in (D for q, k and v, heads·head_dim for the
    output projection: the in-features of each Linear) and the patch conv's
    with P·P·3."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, VisionTransformer):
                for p in (mod.cls_token, mod.pos_embed):
                    nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04, generator=generator)
    return init_flax_(model, generator)


def build_vit(name: str, num_classes: int, **kwargs) -> VisionTransformer:
    base = name.split(".")[0]
    if base not in VIT_CONFIGS:
        raise ValueError(f"Unknown ViT variant: {name}")
    c = VIT_CONFIGS[base]
    return VisionTransformer(num_classes=num_classes, patch=c["patch"], dim=c["dim"],
                             depth=c["depth"], heads=c["heads"], **kwargs)
