"""The reference's training steps: the recipe's first steps from the
benchmark's weights, on the same rows, with the draws made again from the
same seeds, all in f32 (TF32 off). Each step: the augmentation and the mix
(``aug/pipeline.py``), the drop masks, the forward and backward of the
configuration's model (``convnext.py``, in blocks of rows; or
``efficientnet.py``, whose BatchNorm takes the whole batch), the loss, the
global-norm clip, AdamW with the warmup-cosine rate, and the EMA after the
update; and the fold ensemble's probabilities for prediction."""

from __future__ import annotations

import contextlib
import math

import torch

from benchmark.reference import convnext, efficientnet
from benchmark.reference.aug import pipeline


def model_of(cfg: dict):
    """The reference module of the configuration's model family."""
    return efficientnet if "efficientnet" in cfg["model_name"] else convnext


def param_spec(cfg: dict) -> list:
    return model_of(cfg).param_spec(cfg)


def drop_sites(cfg: dict, rows: int) -> list:
    return efficientnet.drop_sites(cfg, rows) if model_of(cfg) is efficientnet else []


def per_row_loss(outs: list[torch.Tensor], targets: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Each row's training loss, as the recipe's criterion takes it:
    label-smoothed CE in f32; with deep supervision ``(1 - aux_weight) *
    CE(main) + aux_weight / n_aux * sum CE(aux)`` on the mixed targets
    argmaxed back to classes (the recipe's quirk); without it, mixed (soft)
    targets smoothed to ``t (1 - e) + e / K`` (class weights then apply to
    nothing)."""
    eps = cfg["label_smoothing"]
    if len(outs) > 1 and cfg["use_deep_supervision"] and targets.dim() == 2:
        targets = targets.argmax(dim=-1)

    def ce(logits):
        logp = torch.log_softmax(logits.float(), dim=-1)
        if targets.dim() == 2:
            return -((targets * (1.0 - eps) + eps / logits.shape[-1]) * logp).sum(dim=-1)
        if cfg["use_weighted_loss"]:
            raise ValueError("the reference has no weighted CE on integer targets")
        nll = -logp.gather(-1, targets[:, None].long())[:, 0]
        return (1.0 - eps) * nll - eps * logp.mean(dim=-1)

    if len(outs) == 1 or not cfg["use_deep_supervision"]:
        return ce(outs[0])
    aux_w = cfg["aux_weight"] / (len(outs) - 1)
    total = (1.0 - cfg["aux_weight"]) * ce(outs[0])
    for o in outs[1:]:
        total = total + aux_w * ce(o)
    return total


@contextlib.contextmanager
def no_tf32():
    """f32 matmuls and convs in f32 on the card, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def lr_at(cfg: dict, steps_per_epoch: int, count: int) -> float:
    """The warmup-cosine rate at Adam's ``count`` (before it advances); its
    floor ``min_lr`` is on the multiplier (the recipe's quirk)."""
    if cfg["schedule"] != "warmup_cosine":
        raise ValueError(f"the reference has no {cfg['schedule']!r} schedule")
    accum = cfg["gradient_accumulation_steps"] if cfg["schedule_horizon"] == "microbatches" else 1
    total = steps_per_epoch * cfg["epochs"] * accum
    warmup = int(total * cfg["warmup_ratio"])
    if count < warmup:
        return cfg["lr"] * count / max(1, warmup)
    progress = (count - warmup) / max(1, total - warmup)
    return cfg["lr"] * max(cfg["min_lr"], 0.5 * (1.0 + math.cos(math.pi * progress)))


def check_supported(cfg: dict) -> None:
    if cfg["gradient_accumulation_steps"] != 1:
        raise ValueError("the reference trains one microbatch a step")
    if cfg["use_focal_loss"] or cfg["freeze_stages"]:
        raise ValueError("the reference trains the recipe's CE, all parameters")
    if not cfg["aug_enabled"]:
        raise ValueError("the reference augments on the device")


def train_steps(w0: dict, batches, seeds, cfg: dict, steps_per_epoch: int,
                quant=None, block: int = 32) -> dict:
    """``len(batches)`` optimizer steps from ``w0`` (f32 tensors by name;
    BatchNorm's buffers among them are not trained). ``batches``: (uint8
    images, int labels) on the card; ``seeds``: each step's draw seed: the
    aug's, the mix's, then one keep-mask a drop site. Returns each step's
    loss, the first step's clipped gradient, and the change of the
    parameters and of the EMA. Rows go through the model in blocks of
    ``block``; a model with BatchNorm takes the whole batch at once."""
    check_supported(cfg)
    model = model_of(cfg)
    st = pipeline.stage_configs(cfg)
    w0 = {k: v for k, v in w0.items() if not k.endswith(("running_mean", "running_var"))}
    names = list(w0)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in w0.items()}
    mu = {k: torch.zeros_like(v) for k, v in w0.items()}
    nu = {k: torch.zeros_like(v) for k, v in w0.items()}
    ema = {k: v.detach().clone() for k, v in w0.items()}
    b1, b2, eps, wd = cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"], cfg["weight_decay"]
    clip, decay = cfg["gradient_clip_val"], cfg["ema_decay"]
    losses, grad1 = [], None
    with no_tf32():
        for t, ((images, labels), seed) in enumerate(zip(batches, seeds), start=1):
            gen = torch.Generator(device=images.device).manual_seed(seed)
            d = pipeline.draw(gen, tuple(images.shape), st)
            n = images.shape[0]
            masks = [torch.rand(shape, generator=gen, device=gen.device) < 1.0 - rate
                     for shape, rate in drop_sites(cfg, n)]
            x, targets = pipeline.augment(images, labels, d, st)
            grads = {k: torch.zeros_like(v) for k, v in w0.items()}
            loss = 0.0
            rows = n if model is efficientnet else block
            for r in range(0, n, rows):
                outs = model.forward(p, x[r:r + rows], cfg, [m[r:r + rows] for m in masks],
                                     quant)
                part = per_row_loss(outs, targets[r:r + rows], cfg).sum() / n
                for k, g in zip(names, torch.autograd.grad(part, [p[k] for k in names])):
                    grads[k] += g
                loss += float(part.detach())
            with torch.no_grad():
                gnorm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
                if clip > 0 and float(gnorm) >= clip:
                    for g in grads.values():
                        g.mul_(clip / float(gnorm))
                if t == 1:
                    grad1 = {k: g.clone() for k, g in grads.items()}
                lr = lr_at(cfg, steps_per_epoch, t - 1)
                bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
                for k in names:
                    mu[k].mul_(b1).add_(grads[k], alpha=1.0 - b1)
                    nu[k].mul_(b2).addcmul_(grads[k], grads[k], value=1.0 - b2)
                    u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps) + wd * p[k]
                    p[k].sub_(lr * u)
                    ema[k].mul_(decay).add_(p[k], alpha=1.0 - decay)
            losses.append(loss)
    return {"loss": losses, "grad1": grad1,
            "change": {k: (p[k].detach() - w0[k]) for k in names},
            "ema_change": {k: ema[k] - w0[k] for k in names}}


def ensemble_probs(weights: list[dict], images_u8: torch.Tensor, cfg: dict,
                   quant=None, block: int = 16) -> torch.Tensor:
    """The fold ensemble's probabilities of uint8 images: eval
    preprocessing, the TTA views, each model's softmax averaged over the
    views, then over the models; f32, TF32 off, in blocks of images."""
    out = []
    with no_tf32(), torch.no_grad():
        for r in range(0, images_u8.shape[0], block):
            x = pipeline.eval_preprocess(images_u8[r:r + block], cfg)
            views = pipeline.tta_views(x, cfg)
            total = 0.0
            for w in weights:
                probs = [torch.softmax(convnext.forward(w, v, cfg, quant=quant)[0], dim=-1)
                         for v in views]
                total = total + torch.stack(probs).mean(0)
            out.append(total / len(weights))
    return torch.cat(out)
