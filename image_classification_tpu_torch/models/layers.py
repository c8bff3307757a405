"""Shared building blocks, channels-last (NHWC), as in
``image_classification_tpu/models/layers.py``.

Every module keeps f32 parameters (or the bf16 ones ``infer/predict.py``
casts to) and casts them to the activation's dtype at use.

Random masks are explicit draws, as the augmentation's are
(``aug/draws.py``): in train mode each ``DropPath``, ``Dropout`` and
``AttentionDropout`` with a positive rate applies the keep-mask it was
handed (:func:`drop_sites`, :func:`draw_drop_masks`, :func:`drop_masks`),
and refuses to run without one. JAX's ``make_rng("dropout")`` keys cannot
be reproduced in torch, so tests hand both sides the same masks. In eval
mode each is the identity.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
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


def dense(x: torch.Tensor, fc: nn.Linear) -> torch.Tensor:
    """flax Dense / DenseGeneral in x's dtype: the product is rounded, then
    the bias is added."""
    return torch.matmul(x, fc.weight.to(x.dtype).t()) + fc.bias.to(x.dtype)


def model_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the model group in x's dtype, into a new tensor:
    a functional collective (``_c10d_functional.all_reduce`` and its
    ``wait_tensor``), not the in-place ``dist.all_reduce``, so that a
    selective-checkpoint policy can name its output and keep it
    (``models/convnext.py``'s ``"dots"``)."""
    y = torch.ops._c10d_functional.all_reduce(x.contiguous(), "sum", group.group_name)
    return torch.ops._c10d_functional.wait_tensor(y)


MODEL_SUM_OPS = (torch.ops._c10d_functional.all_reduce.default,
                 torch.ops._c10d_functional.wait_tensor.default)


class _CopyToModel(torch.autograd.Function):
    """Megatron's ``f``: the identity forward, the gradient summed over the
    model group (every rank's shard of the MLP used the whole input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return model_sum(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's ``g``: the ranks' partial products summed forward, the
    gradient passed through."""

    @staticmethod
    def forward(ctx, x, group):
        return model_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel layer (``parallel/shardings.py``);
    ``x`` itself without a model group."""
    return x if group is None else _CopyToModel.apply(x, group)


def dense_row_parallel(x: torch.Tensor, fc: nn.Linear, group) -> torch.Tensor:
    """:func:`dense` of a row-parallel layer: this rank's product with its
    columns of the weight, summed over the model group in x's dtype, then
    the (whole) bias, added once; :func:`dense` without a group."""
    if group is None:
        return dense(x, fc)
    y = _ReduceFromModel.apply(torch.matmul(x, fc.weight.to(x.dtype).t()), group)
    return y + fc.bias.to(x.dtype)


def init_flax_(model: nn.Module, generator: torch.Generator,
               convs: tuple[type, ...] = (PatchConv,)) -> nn.Module:
    """flax's initialisation of a ConvNeXt or ViT module tree, in place:
    lecun-normal Dense kernels (fan-in: the Linear's in-features) and conv
    kernels of the types in ``convs`` (fan-in kh·kw·cin), zero biases, unit
    LN scales. Covers the deep-supervision heads too."""
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            lecun_normal_(mod.weight, mod.in_features, generator)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, convs):
            w = mod.weight
            lecun_normal_(w, w.shape[1] * w.shape[2] * w.shape[3], generator)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
    return model


# --------------------------------------------------------------- BatchNorm
def _reduce_dims(x: torch.Tensor) -> tuple[int, ...]:
    return tuple(range(x.dim() - 1))


class _BatchNormTrain(torch.autograd.Function):
    """flax ``nn.BatchNorm`` on batch statistics over every dim but the
    last: mean and E[x^2] - mean^2 in f32 (for bf16 inputs too), the
    variance clipped at 0, then ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias`` in f32, rounded once to x's dtype (flax 0.12 ``_compute_stats``
    and ``_normalize``). Autograd saves x in its own dtype and the f32
    per-channel mean and rstd, not the f32 copies of x the plain ops would
    keep; the backward is the closed form of that function's gradient, with
    JAX's weights for the clip (0 below it, 1/2 at 0).

    With a process ``group`` (data parallelism) the statistics are those of
    the global batch, as XLA computes them over a sharded batch: the
    forward all-reduces Σx, Σx² and the row count, and the backward the
    per-channel sums of dy and dy·x̂ that dx needs. The scale and bias
    gradients it returns stay this rank's sums, which the step's gradient
    all-reduce completes."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, group=None):
        dims = _reduce_dims(x)
        xf = x.float()
        if group is None:
            n = x.numel() // x.shape[-1]
            mean = xf.mean(dims)
            raw = (xf * xf).mean(dims) - mean * mean
        else:
            c = x.shape[-1]
            sums = torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                              xf.new_full((1,), x.numel() // c)])
            dist.all_reduce(sums, group=group)
            n = sums[2 * c:]
            mean = sums[:c] / n
            raw = sums[c:2 * c] / n - mean * mean
        var = raw.clamp_min(0.0)
        rstd = torch.rsqrt(var + eps)
        y = ((xf - mean) * (rstd * weight.float()) + bias.float()).to(x.dtype)
        ctx.save_for_backward(x, mean, rstd, raw, weight)
        ctx.n, ctx.group = n, group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, mean, rstd, raw, weight = ctx.saved_tensors
        dims = _reduce_dims(x)
        n = ctx.n
        gyf = gy.float()
        xhat = (x.float() - mean) * rstd
        dbias = gyf.sum(dims)
        dscale = (gyf * xhat).sum(dims)
        gbias, gscale = dbias, dscale
        if ctx.group is not None:
            both = torch.cat([dbias, dscale])
            dist.all_reduce(both, group=ctx.group)
            gbias, gscale = both.chunk(2)
        clip = (raw > 0).float() + 0.5 * (raw == 0).float()
        dx = (weight.float() * rstd) * (gyf - gbias / n - xhat * (clip * gscale / n))
        return (dx.to(x.dtype), dscale.to(weight.dtype), dbias.to(weight.dtype),
                None, None)


class BatchNorm(nn.Module):
    """Channels-last BatchNorm with flax's arithmetic (not
    ``torch.nn.BatchNorm2d``'s): batch statistics E[x^2] - E[x]^2 in f32,
    clipped at 0, and a running variance that takes the biased batch
    variance, ``ra = momentum * ra + (1 - momentum) * batch``. Defaults are
    EfficientNet's (momentum 0.9, eps 1e-3). timm's keys: ``weight``,
    ``bias`` and the f32 buffers ``running_mean``, ``running_var``. flax
    keeps no batch count, so there is no ``num_batches_tracked``: a timm
    state dict's is dropped when it loads.

    Train mode normalises with the batch statistics and updates the running
    ones in place; eval mode normalises with the running ones. Under
    :func:`batchnorm_group` the batch statistics are the global batch's,
    reduced over the data-parallel group, and so every rank's running
    statistics take the same update."""

    group = None   # the data-parallel process group (batchnorm_group)

    def __init__(self, dim: int, momentum: float = 0.9, eps: float = 1e-3):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight.float()
            return ((x.float() - self.running_mean) * mul
                    + self.bias.float()).to(x.dtype)
        y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias, self.eps,
                                             self.group)
        m = self.momentum
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return y


@contextlib.contextmanager
def batchnorm_group(model: nn.Module, group):
    """Batch statistics over ``group`` (the data-parallel ranks) for every
    :class:`BatchNorm` of ``model``, in the forwards inside the block; the
    backward keeps the group it ran its forward with. A no-op for None."""
    norms = ([m for m in model.modules() if isinstance(m, BatchNorm)]
             if group is not None else [])
    for m in norms:
        m.group = group
    try:
        yield
    finally:
        for m in norms:
            m.group = None


# ------------------------------------------------------------ convolutions
def same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """flax/XLA ``SAME`` padding of one side of ``n``: the total is split
    with the extra pixel at the end (bottom/right), so a stride-2 3x3 on 60
    rows pads (0, 1) and a stride-2 5x5 on 30 rows pads (1, 2)."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
              groups: int = 1) -> torch.Tensor:
    """``lax.conv`` with SAME padding on (B, H, W, Cin), ``weight`` in
    torch's OIHW layout, in x's dtype. The NCHW view of an NHWC tensor is
    channels_last in memory, the layout cuDNN's tensor-core kernels take
    without a transpose, and its output comes back channels_last, so the
    permutes on either side copy nothing. Symmetric padding goes to the
    conv; only the extra bottom/right pixel of an uneven SAME pad is an
    explicit ``F.pad``."""
    k = weight.shape[-1]
    (top, bottom), (left, right) = (same_pads(n, k, stride) for n in x.shape[1:3])
    if bottom != top or right != left:
        x = F.pad(x, (0, 0, 0, right - left, 0, bottom - top))
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), None, stride,
                 (top, left), 1, groups)
    return y.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """Params of ``nn.Conv2d(cin, cout, k, stride, groups=groups,
    bias=bias)`` (timm keys ``weight`` and ``bias``), forward through
    :func:`conv_nhwc` on NHWC. The bias is added after the product is
    rounded to x's dtype, as flax's ``nn.Conv`` adds it."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1, bias: bool = False):
        super().__init__()
        self.stride, self.groups = stride, groups
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_nhwc(x, self.weight, self.stride, self.groups)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class SqueezeExcite(nn.Module):
    """EfficientNet's SE gate: global average pool, 1x1 conv with bias,
    silu, 1x1 conv with bias, sigmoid, times x (JAX ``SqueezeExcite``).
    timm keys ``conv_reduce``, ``conv_expand``. On the pooled (B, C) rows
    a 1x1 conv is a matmul."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.conv_reduce = Conv(dim, hidden, 1, bias=True)
        self.conv_expand = Conv(hidden, dim, 1, bias=True)

    @staticmethod
    def _dense(s: torch.Tensor, conv: Conv) -> torch.Tensor:
        w = conv.weight.reshape(conv.weight.shape[0], -1).to(s.dtype)
        return torch.matmul(s, w.t()) + conv.bias.to(s.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.silu(self._dense(global_avg_pool(x), self.conv_reduce))
        s = torch.sigmoid(self._dense(s, self.conv_expand))
        return x * s[:, None, None, :]


# ------------------------------------------------------- stochastic layers
class _Masked(nn.Module):
    """A layer that, in train mode with ``rate > 0``, keeps the rows its
    mask marks, scaled by 1 / keep, and zeroes the rest (flax: ``where(mask,
    x / keep, 0)``; ``keep`` is rounded to x's dtype first, as JAX's weakly
    typed scalar is)."""

    per_row = True   # the mask's first dim is the batch's rows

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.mask: torch.Tensor | None = None

    def mask_shape(self, rows: int) -> tuple[int, ...]:
        raise NotImplementedError

    def active_mask(self) -> torch.Tensor | None:
        """The keep-mask this forward applies: None where the layer acts as
        the identity (eval mode or rate 0); raises where it needs one and
        none was handed in."""
        if not self.training or self.rate == 0.0:
            return None
        if self.mask is None:
            raise RuntimeError(
                f"{type(self).__name__}(rate={self.rate}) in train mode needs its "
                "keep-mask: draw it with draw_drop_masks and apply it with drop_masks")
        return self.mask

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mask = self.active_mask()
        return x if mask is None else self.apply_mask(x, mask)

    def apply_mask(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        keep = float(torch.tensor(1.0 - self.rate, dtype=x.dtype))
        mask = mask.reshape(*mask.shape, *[1] * (x.dim() - mask.dim()))
        return torch.where(mask, x / keep, 0.0)


class DropPath(_Masked):
    """Stochastic depth: the whole residual branch of a sample is dropped
    (JAX ``DropPath``); one mask entry per sample."""

    def mask_shape(self, rows: int) -> tuple[int, ...]:
        return (rows,)


class Dropout(_Masked):
    """flax ``nn.Dropout`` on (B, *features): one mask entry per element
    (``features`` an int for (B, C) rows, a tuple for ViT's (B, N, D)
    tokens)."""

    def __init__(self, rate: float, features: int | tuple[int, ...]):
        super().__init__(rate)
        self.features = (features,) if isinstance(features, int) else tuple(features)

    def mask_shape(self, rows: int) -> tuple[int, ...]:
        return (rows, *self.features)


class AttentionDropout(_Masked):
    """flax's attention-weight dropout (``dot_product_attention_weights``
    with ``broadcast_dropout=True``): one (1, 1, N, N) keep-mask shared by
    every sample and head, applied as ``weights * (keep / keep_prob)`` with
    the multiplier computed in the weights' dtype, not as ``where``."""

    per_row = False

    def __init__(self, rate: float, tokens: int):
        super().__init__(rate)
        self.tokens = tokens

    def mask_shape(self, rows: int) -> tuple[int, ...]:
        return (1, 1, self.tokens, self.tokens)

    def apply_mask(self, w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        # keep / keep_prob in the dtype: 0, or 1 / keep_prob with keep_prob
        # rounded first and the quotient rounded again (exact in the dtype)
        inv = float(torch.tensor(1.0, dtype=w.dtype)
                    / torch.tensor(1.0 - self.rate, dtype=w.dtype))
        return w * (mask.to(w.dtype) * inv)


def drop_path_rates(total: float, depths: tuple[int, ...]) -> list[list[float]]:
    """Linearly increasing stochastic-depth rates over all blocks:
    ``total * i / max(1, n - 1)`` for block i of n, split by stage."""
    n = sum(depths)
    rates = [total * i / max(1, n - 1) for i in range(n)]
    out, i = [], 0
    for d in depths:
        out.append(rates[i:i + d])
        i += d
    return out


def drop_sites(model: nn.Module) -> list[_Masked]:
    """The model's DropPath, Dropout and AttentionDropout layers with a
    positive rate, in the order the forward runs them, which is the order
    JAX draws their keys: ConvNeXt's and EfficientNet's blocks, then the
    head; ViT's token dropout, then per block the attention dropout and the
    two DropPaths. Each model registers its sites in that order."""
    return [m for m in model.modules() if isinstance(m, _Masked) and m.rate > 0]


def draw_drop_masks(generator: torch.Generator, sites: list[_Masked],
                    rows: int) -> tuple[torch.Tensor, ...]:
    """One bool keep-mask per site for a batch of ``rows``, ``uniform <
    1 - rate`` as ``jax.random.bernoulli``, on ``generator``'s device."""
    return tuple(torch.rand(s.mask_shape(rows), generator=generator,
                            device=generator.device) < 1.0 - s.rate for s in sites)


@contextlib.contextmanager
def drop_masks(sites: list[_Masked], masks):
    """Hand each site its mask for the forwards inside the block."""
    if len(sites) != len(masks):
        raise ValueError(f"{len(masks)} drop masks for {len(sites)} sites")
    for s, m in zip(sites, masks):
        s.mask = m
    try:
        yield
    finally:
        for s in sites:
            s.mask = None
