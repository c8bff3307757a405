"""ConvNeXt family, channels-last, forward for inference and training.

Port of ``image_classification_tpu/models/convnext.py``: patchify stem (4x4/4
conv + LN), four stages of blocks (7x7 depthwise conv -> LN -> 4x MLP with
exact GELU -> layer scale -> residual), LN + 2x2/2 downsample between stages,
and a global-average-pool -> LN -> Linear head. Parameter names are timm's
(``stem.0``, ``stages.{i}.downsample.{0,1}``,
``stages.{i}.blocks.{j}.{conv_dw,norm,mlp.fc1,mlp.fc2,gamma}``,
``head.{norm,fc}``) in torch layouts, so a timm state dict loads with
``strict=True``.

In each block the depthwise conv runs ``ops.depthwise_conv7x7``; the tail runs
the fused ``ops.block_mlp`` where ``block_mlp_available(C)`` (stages 0-2 of
ConvNeXt-B) and the block has no drop-path and exact GELU, else the composed
route (JAX ``convnext.py:136-141``): LN, ``torch.matmul``, GELU,
``torch.matmul``, layer scale, the view back to (B, H, W, C), ``DropPath``
(one mask entry per sample) and the residual, in the working dtype like the
flax layers. Its GELU is ``ops.gelu`` (exact, the A&S erf) or, with
``gelu_approximate``, tanh GELU (``jax.nn.gelu(approximate=True)``), a plain
op in both packages. Drop-path rates rise linearly over all blocks
(``layers.drop_path_rates``), so block 0 (rate 0) keeps the fused tail; the
head applies ``Dropout(drop_rate)`` between its LN and its classifier.
Under autograd the three kernel ops run as ``torch.autograd.Function``s
whose backwards are kernels too; the stem, downsamples, LayerNorms, pooling,
the composed route's matmuls (left to XLA in the JAX package as well) and
the heads are plain autograd.

``block_remat`` is JAX's (``convnext.py:239-257``): ``"full"`` recomputes
each block from its input in the backward; ``"dots"`` keeps the depthwise
output (JAX's ``dwconv_out``) and the outputs of the matmuls, and
recomputes the rest of the tail: on the composed route LayerNorm, GELU,
layer scale and drop-path, with the two products saved by a
selective-checkpoint policy; on the fused route the whole tail, one
``autograd.Function`` that, like JAX's Pallas ``custom_vjp``, is not a
dot, so its kernel runs again in the backward. A block recomputes with the
drop-path mask of its own forward, which it reads once and hands to the
checkpointed function. Under tensor parallelism (a split MLP, always on the
composed route) both modes run, as JAX's ``nn.remat`` does under GSPMD:
``"full"`` recomputes the model group's all-reduce with the rest of the
block (every rank of the group recomputes in autograd's order, so the
collectives stay matched), and ``"dots"`` also keeps the all-reduce's
output, as JAX's ``checkpoint_dots`` keeps the dot's reduced result, so
its recompute runs no collective.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from image_classification_tpu_torch.models.layers import (
    MODEL_SUM_OPS,
    Dropout,
    DropPath,
    LayerNorm,
    PatchConv,
    copy_to_model,
    dense,
    dense_row_parallel,
    drop_path_rates,
    global_avg_pool,
    init_flax_,
)
from image_classification_tpu_torch.ops import (
    block_mlp,
    block_mlp_available,
    depthwise_conv7x7,
    gelu,
)

# name -> (depths, dims); aligned with timm model names
CONVNEXT_CONFIGS: dict[str, tuple[tuple[int, ...], tuple[int, ...]]] = {
    "convnext_atto": ((2, 2, 6, 2), (40, 80, 160, 320)),
    "convnext_femto": ((2, 2, 6, 2), (48, 96, 192, 384)),
    "convnext_pico": ((2, 2, 6, 2), (64, 128, 256, 512)),
    "convnext_nano": ((2, 2, 8, 2), (80, 160, 320, 640)),
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
    "convnext_xlarge": ((3, 3, 27, 3), (256, 512, 1024, 2048)),
}


BLOCK_REMAT = ("none", "dots", "full")


_DOTS = (torch.ops.aten.mm.default, *MODEL_SUM_OPS)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``"dots"``' policy (JAX's ``checkpoint_dots``): keep the outputs of
    the composed tail's two matmuls, rank 2 after its reshape, and of a
    split fc2's sum over the model group."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


_dots_context = functools.partial(create_selective_checkpoint_contexts, _save_dots)


class DepthwiseConv(nn.Module):
    """Params of ``nn.Conv2d(dim, dim, 7, padding=3, groups=dim)``."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dim, 1, 7, 7))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (C, 1, 7, 7) -> the kernel's (7, 7, C); a C*49-element copy
        w = self.weight[:, 0].permute(1, 2, 0).to(x.dtype).contiguous()
        return depthwise_conv7x7(x, w) + self.bias.to(x.dtype)


class Mlp(nn.Module):
    group = None   # the model group when fc1/fc2 are split (parallel/shardings.py)

    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init: float = 1e-6,
                 drop_path: float = 0.0, gelu_approximate: bool = False,
                 block_remat: str = "none"):
        super().__init__()
        if block_remat not in BLOCK_REMAT:
            raise ValueError(f"unknown block_remat {block_remat!r}")
        self.gelu_approximate = gelu_approximate
        self.block_remat = block_remat
        self.conv_dw = DepthwiseConv(dim)
        self.norm = LayerNorm(dim)
        self.mlp = Mlp(dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))
        self.drop_path = DropPath(drop_path)

    @property
    def fused(self) -> bool:
        """Whether the tail runs the fused kernel (JAX's routing; a split MLP
        takes the composed route, as JAX demotes the kernel on a model
        axis)."""
        return (block_mlp_available(self.gamma.shape[0]) and self.drop_path.rate == 0.0
                and not self.gelu_approximate and self.mlp.group is None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # read here: the site's mask is cleared when its drop_masks block
        # exits, before a recompute in the backward
        mask = self.drop_path.active_mask()
        if self.block_remat == "none" or not torch.is_grad_enabled():
            return self._block(x, mask)
        if self.block_remat == "full":
            return checkpoint(self._block, x, mask, use_reentrant=False)
        context = {} if self.fused else {"context_fn": _dots_context}
        return checkpoint(self._tail, self.conv_dw(x), x, mask, use_reentrant=False,
                          **context)

    def _block(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        return self._tail(self.conv_dw(x), x, mask)

    def _tail(self, y: torch.Tensor, shortcut: torch.Tensor,
              mask: torch.Tensor | None) -> torch.Tensor:
        """LN -> fc1 -> GELU -> fc2 -> layer scale -> drop-path -> residual
        on the depthwise output ``y``; ``mask`` is the drop-path keep-mask,
        None where the block drops nothing."""
        shape, c = y.shape, y.shape[-1]
        if self.fused:
            out = block_mlp(
                y.reshape(-1, c), shortcut.reshape(-1, c),
                self.norm.weight, self.norm.bias,
                self.mlp.fc1.weight, self.mlp.fc1.bias,
                self.mlp.fc2.weight, self.mlp.fc2.bias, self.gamma, 1e-6,
            )
            return out.view(shape)
        group = self.mlp.group
        h = dense(copy_to_model(self.norm(y.reshape(-1, c)), group), self.mlp.fc1)
        h = F.gelu(h, approximate="tanh") if self.gelu_approximate else gelu(h)
        h = (dense_row_parallel(h, self.mlp.fc2, group) * self.gamma.to(h.dtype)).view(shape)
        return shortcut + (h if mask is None else self.drop_path.apply_mask(h, mask))


class Stage(nn.Module):
    def __init__(self, cin: int, dim: int, drop_paths: list[float], downsample: bool,
                 gelu_approximate: bool = False, block_remat: str = "none"):
        super().__init__()
        self.downsample = (
            nn.Sequential(LayerNorm(cin), PatchConv(cin, dim, 2))
            if downsample else nn.Identity()
        )
        self.blocks = nn.Sequential(*[
            ConvNeXtBlock(dim, drop_path=rate, gelu_approximate=gelu_approximate,
                          block_remat=block_remat)
            for rate in drop_paths])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(self.downsample(x))


class Head(nn.Module):
    def __init__(self, dim: int, num_classes: int, drop_rate: float = 0.0):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.drop = Dropout(drop_rate, dim)
        self.fc = nn.Linear(dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop(self.norm(global_avg_pool(x)))
        # the classifier runs in f32 (models/convnext.py head_fc, dtype f32)
        return torch.matmul(x.float(), self.fc.weight.float().t()) + self.fc.bias.float()


class ConvNeXt(nn.Module):
    """NHWC input (B, H, W, 3) -> logits (B, num_classes) in f32; with
    ``return_features`` also the outputs of stages 1..3 (the deep-supervision
    taps)."""

    def __init__(self, num_classes: int = 44,
                 depths: tuple[int, ...] = (3, 3, 27, 3),
                 dims: tuple[int, ...] = (128, 256, 512, 1024),
                 dtype: torch.dtype = torch.bfloat16,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 gelu_approximate: bool = False, block_remat: str = "none"):
        super().__init__()
        self.dims = tuple(dims)
        self.dtype = dtype
        self.stem = nn.Sequential(PatchConv(3, dims[0], 4), LayerNorm(dims[0]))
        dp = drop_path_rates(drop_path_rate, tuple(depths))
        self.stages = nn.ModuleList(
            Stage(dims[max(i - 1, 0)], dims[i], dp[i], downsample=i > 0,
                  gelu_approximate=gelu_approximate, block_remat=block_remat)
            for i in range(len(depths))
        )
        self.head = Head(dims[-1], num_classes, drop_rate)

    @property
    def feature_dims(self) -> tuple[int, ...]:
        return self.dims[1:]

    def forward(self, x: torch.Tensor, return_features: bool = False):
        x = self.stem(x.to(self.dtype))
        features = []
        for i, stage in enumerate(self.stages):
            x = stage(x)
            if i > 0:
                features.append(x)
        logits = self.head(x)
        return (logits, features) if return_features else logits


def init_convnext_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's initialisation, in place (``layers.init_flax_``), the depthwise
    convs included; gamma keeps its layer-scale init."""
    return init_flax_(model, generator, (PatchConv, DepthwiseConv))


def build_convnext(name: str, num_classes: int, **kwargs) -> ConvNeXt:
    base = name.split(".")[0]
    for suffix in ("_in22k", "_in1k", "_384"):
        base = base.replace(suffix, "")
    if base not in CONVNEXT_CONFIGS:
        raise ValueError(f"Unknown ConvNeXt variant: {name}")
    depths, dims = CONVNEXT_CONFIGS[base]
    return ConvNeXt(num_classes=num_classes, depths=depths, dims=dims, **kwargs)
