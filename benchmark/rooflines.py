"""The rooflines' shared arithmetic: the least time of an op over one
optimizer step or one predict batch, from the configuration's shapes
(``counts.py``), and a kernel roofline from a run's traces. Each metric's
own file names its kernels and the op's scope."""

from __future__ import annotations

from benchmark import counts
from benchmark.reference.aug.pipeline import tta_view_count
from benchmark.reference import efficientnet
from benchmark.reference.convnext import arch


def images_per_unit(ctx: dict) -> int:
    """Images through the model a step (train) or a batch (predict: every
    view of every image, for each model)."""
    if ctx["role"] == "train":
        return ctx["cfg"]["batch_size"]
    return ctx["traffic"]["batch"] * tta_view_count(ctx["cfg"])


def block_tail_least_s(ctx: dict, max_c: int) -> float:
    """One step's or batch's block tails of width <= ``max_c``: forward,
    and in training the backward."""
    cfg = ctx["cfg"]
    depths, dims = arch(cfg)
    sizes = counts.convnext_stage_sizes(cfg["image_size"], len(dims))
    n = images_per_unit(ctx)
    models = ctx["traffic"].get("models", 1) if ctx["role"] == "predict" else 1
    total = 0.0
    for (h, w), depth, c in zip(sizes, depths, dims):
        if c > max_c:
            continue
        m = n * h * w
        least = counts.least_seconds(*counts.block_tail_work(m, c, False),
                                     counts.PEAK_BF16_FLOPS)
        if ctx["role"] == "train":
            least += counts.least_seconds(*counts.block_tail_work(m, c, True),
                                          counts.PEAK_BF16_FLOPS)
        total += depth * least
    return total * models


def dwconv_least_s(ctx: dict) -> float:
    """One step's or batch's 7x7 depthwise convs: forward, and in training
    dx and dw."""
    cfg = ctx["cfg"]
    depths, dims = arch(cfg)
    sizes = counts.convnext_stage_sizes(cfg["image_size"], len(dims))
    n = images_per_unit(ctx)
    models = ctx["traffic"].get("models", 1) if ctx["role"] == "predict" else 1
    parts = ("fwd", "dx", "dw") if ctx["role"] == "train" else ("fwd",)
    total = 0.0
    for (h, w), depth, c in zip(sizes, depths, dims):
        for which in parts:
            total += depth * counts.least_seconds(*counts.dwconv_work(n, h, w, c, which),
                                                  counts.PEAK_F32_FLOPS)
    return total * models


def roofline_pct(ctx: dict, role: str, kernels, least_per_unit_s: float) -> float | None:
    """The least time of the traced steps' op over the device time of the
    kernels named, as a percentage; None where nothing was traced or no
    such kernel ran."""
    if ctx["role"] != role:
        return None
    traces = [r["trace"] for r in ctx["ranks"] if r["trace"] is not None]
    seconds = sum(t.seconds_of(kernels) for t in traces)
    if seconds <= 0:
        return None
    return 100.0 * least_per_unit_s * sum(t.steps for t in traces) / seconds


def forward_flops(cfg: dict) -> int:
    """One image's forward operations of the configuration's model."""
    if "efficientnet" in cfg["model_name"]:
        return counts.efficientnet_forward_flops(efficientnet.blocks(cfg), efficientnet.STEM,
                                                 efficientnet.HEAD, cfg["image_size"],
                                                 cfg["num_classes"])
    depths, dims = arch(cfg)
    return counts.convnext_forward_flops(depths, dims, cfg["image_size"], cfg["num_classes"],
                                         cfg["use_deep_supervision"])


def mfu_pct(ctx: dict, role: str) -> float | None:
    """Model operations at the window's rate over the chips' bf16 peak."""
    if ctx["role"] != role:
        return None
    fwd = forward_flops(ctx["cfg"])
    if role == "train":
        per_image = 3 * fwd
    else:
        per_image = fwd * ctx["traffic"]["models"] * images_per_unit(ctx) // ctx["traffic"]["batch"]
    rate = sum(r["images"] / r["wall_s"] for r in ctx["ranks"])
    return 100.0 * per_image * rate / (counts.PEAK_BF16_FLOPS * ctx["chips"])
