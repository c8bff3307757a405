"""The predict-side steps of ``image_classification_tpu/train/step.py``:
``make_eval_views``, ``make_forward_views``, ``tta_num_views`` and
``make_predict_step``. The train and eval steps are not ported yet (ROADMAP
queue A, item 6).
"""

from __future__ import annotations

from typing import Callable

import torch

from image_classification_tpu_torch.aug.pipeline import eval_preprocess


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def make_eval_views(cfg, tta: Callable | None = None) -> Callable:
    """``views(images_u8) -> (V*B, H, W, C)``: eval preprocessing, then the
    TTA views stacked along the batch dim (V = 1 without TTA). Built once per
    batch and shared by every ensemble member."""
    dtype = compute_dtype(cfg)

    def views(images_u8: torch.Tensor) -> torch.Tensor:
        x = eval_preprocess(
            images_u8, tuple(cfg.image_size), tuple(cfg.mean), tuple(cfg.std),
            dtype=dtype, round_uint8=cfg.eval_resize_uint8,
        )
        if tta is None:
            return x
        return torch.cat(tta(x), dim=0)

    return views


def make_forward_views(model: torch.nn.Module, n_views: int = 1) -> Callable:
    """``forward(x_views) -> probs (B, classes)``: one forward over the
    stacked views, softmax in f32, mean over views."""

    @torch.no_grad()
    def forward(x_views: torch.Tensor) -> torch.Tensor:
        outputs = model(x_views)
        logits = outputs[0] if isinstance(outputs, (tuple, list)) else outputs
        probs = torch.softmax(logits.float(), dim=-1)
        if n_views == 1:
            return probs
        return probs.reshape(n_views, -1, probs.shape[-1]).mean(dim=0)

    return forward


def tta_num_views(cfg, tta: Callable | None) -> int:
    """Number of views a TTA callable produces (probed on a dummy batch)."""
    if tta is None:
        return 1
    return len(tta(torch.zeros((1, *cfg.image_size, 3))))


def make_predict_step(model: torch.nn.Module, cfg,
                      tta: Callable | None = None) -> Callable:
    """``predict_step(images_u8) -> probs`` for one model, softmax averaged
    over the TTA views."""
    views = make_eval_views(cfg, tta)
    forward = make_forward_views(model, tta_num_views(cfg, tta))
    return lambda images_u8: forward(views(images_u8))
