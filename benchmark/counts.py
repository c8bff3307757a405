"""The yardstick's arithmetic: one H100's peaks, a ConvNeXt's operations
from its shapes, and the operations and bytes of the kernels' ops, as the
rooflines count them.

Peaks (NVIDIA's H100 SXM data sheet, dense): 989 TFLOP/s in bf16 on the
tensor cores, 67 TFLOP/s in f32 outside them, 3.35 TB/s of HBM. The 7x7
depthwise conv is no matrix product: its operations count at the f32
rate, as ``PERF.md``'s kernel table bounds it.

A model's operations count the multiply-adds of its convs and matmuls,
two operations each (a trained image: the forward's three times, no
recomputation); normalisations, activations and the loss are left out.
A kernel op's bytes count each input once and each output once: the
op's own inputs and outputs, whatever an implementation saves between its
forward and its backward."""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2
F32 = 4


def same_out(n: int, stride: int) -> int:
    return -(-n // stride)


def convnext_stage_sizes(image_hw, n_stages: int = 4) -> list[tuple[int, int]]:
    """(H, W) of each stage: the 4x4/4 stem, then a 2x2/2 SAME conv."""
    h, w = image_hw[0] // 4, image_hw[1] // 4
    sizes = [(h, w)]
    for _ in range(n_stages - 1):
        h, w = same_out(h, 2), same_out(w, 2)
        sizes.append((h, w))
    return sizes


def convnext_forward_flops(depths, dims, image_hw, num_classes: int,
                           deep_supervision: bool) -> int:
    """Operations of one image's forward."""
    sizes = convnext_stage_sizes(image_hw, len(dims))
    h, w = sizes[0]
    total = 2 * h * w * dims[0] * 3 * 16                       # stem
    for i, ((h, w), depth, c) in enumerate(zip(sizes, depths, dims)):
        if i > 0:
            total += 2 * h * w * c * dims[i - 1] * 4           # 2x2/2 conv
        total += depth * (2 * h * w * c * 49 + 16 * h * w * c * c)
    total += 2 * dims[-1] * num_classes
    if deep_supervision:
        total += sum(2 * c * num_classes for c in dims[1:])
    return total


def efficientnet_forward_flops(blocks, stem: int, head: int, image_hw,
                               num_classes: int) -> int:
    """Operations of one image's forward of an EfficientNet whose blocks
    are ``(name, in, out, expand, kernel, stride, fused, se, rate)``
    (``reference/efficientnet.py:blocks``): the 3x3/2 stem, each block's
    convs (a depthwise conv k*k a channel) and its SE gate's two products,
    the 1x1 head, the classifier."""
    h, w = same_out(image_hw[0], 2), same_out(image_hw[1], 2)
    total = 2 * h * w * stem * 3 * 9
    for _, cin, cout, e, k, st, fused, se, _ in blocks:
        mid = cin * e
        ho, wo = same_out(h, st), same_out(w, st)
        if fused:
            total += 2 * ho * wo * (mid if e != 1 else cout) * cin * k * k
        else:
            total += 2 * h * w * mid * cin + 2 * ho * wo * mid * k * k
        if se:
            total += 2 * 2 * mid * max(1, cin // 4)
        if e != 1 or not fused:
            total += 2 * ho * wo * cout * mid
        h, w = ho, wo
    return total + 2 * h * w * head * blocks[-1][2] + 2 * head * num_classes


def block_tail_work(m: int, c: int, backward: bool) -> tuple[int, int]:
    """(operations, bytes) of the block tail over ``m`` rows of width ``c``
    (LayerNorm -> fc1 -> GELU -> fc2 -> layer scale -> residual), bf16
    activations. Forward: reads y and the shortcut, the two bf16 weights,
    writes the output: 6 m c + 16 c^2 bytes, 16 m c^2 operations.
    Backward: reads the output's gradient, y and the weights, writes y's
    gradient and the f32 weight gradients: 6 m c + 48 c^2 bytes, 32 m c^2
    operations."""
    if backward:
        return 32 * m * c * c, 3 * BF16 * m * c + 8 * c * c * (BF16 + F32)
    return 16 * m * c * c, 3 * BF16 * m * c + 8 * c * c * BF16


def dwconv_work(n: int, h: int, w: int, c: int, which: str) -> tuple[int, int]:
    """(operations, bytes) of the 7x7 depthwise conv on (n, h, w, c) bf16:
    ``fwd`` and ``dx`` read one map and write one (4 n h w c bytes), ``dw``
    reads two and writes the f32 (7, 7, c) gradient; 98 n h w c operations
    each."""
    ops = 2 * 49 * n * h * w * c
    if which == "dw":
        return ops, 2 * BF16 * n * h * w * c + 49 * c * F32
    return ops, 2 * BF16 * n * h * w * c + 49 * c * BF16


def least_seconds(ops: int, nbytes: int, peak_flops: float) -> float:
    """The least time the card could take: the larger of the operations at
    ``peak_flops`` and the bytes at HBM's rate."""
    return max(ops / peak_flops, nbytes / PEAK_HBM_BYTES)
