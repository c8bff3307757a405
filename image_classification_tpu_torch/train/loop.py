"""The parts of ``image_classification_tpu/train/loop.py`` the train and eval
steps need: ``build_lr_schedule`` and ``evaluate``. ``train_fold`` (early
stop, checkpoints, the epoch loop) comes with the augmentation slice
(ROADMAP queue A, item 10)."""

from __future__ import annotations

from image_classification_tpu_torch.train.schedule import warmup_cosine_schedule
from image_classification_tpu_torch.utils.metrics import macro_f1, per_class_f1


def build_lr_schedule(cfg, steps_per_epoch: int):
    """Cosine horizon sizing. The schedule count advances once per optimizer
    step; ``schedule_horizon='microbatches'`` (the parity default) sizes the
    horizon as ``steps_per_epoch * epochs * accum``, so training ends
    mid-cosine at progress ``1/accum`` (the reference's quirk);
    ``'steps'`` sizes it in optimizer steps. ``schedule='none'`` and
    ``'plateau'`` return the constant ``cfg.lr``."""
    if cfg.schedule in ("none", "plateau"):
        return cfg.lr
    if cfg.schedule_horizon == "microbatches":
        total = steps_per_epoch * cfg.epochs * cfg.gradient_accumulation_steps
    else:
        total = steps_per_epoch * cfg.epochs
    warmup = int(total * cfg.warmup_ratio)
    return warmup_cosine_schedule(cfg.lr, warmup, total, cfg.min_lr)


def evaluate(eval_step, state, loader) -> dict:
    """Run ``eval_step`` over ``loader``; the sums stay on the device and the
    host reads them once, at the end."""
    acc = None
    for batch in loader:
        m = eval_step(state, batch)
        acc = m if acc is None else {k: acc[k] + v for k, v in m.items()}
    if acc is None:
        return {"loss": 0.0, "accuracy": 0.0, "macro_f1": 0.0,
                "min_class_f1": 0.0, "confusion": None}
    cm = acc["confusion"].cpu().numpy()
    count = max(float(acc["count"]), 1.0)
    f1 = per_class_f1(cm).numpy()
    present = cm.sum(axis=1) > 0
    return {
        "loss": float(acc["loss_sum"]) / count,
        "accuracy": float(acc["correct"]) / count,
        "macro_f1": float(macro_f1(cm)),
        "min_class_f1": float(f1[present].min()) if present.any() else 0.0,
        "confusion": cm,
    }
