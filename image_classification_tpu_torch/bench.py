"""The port's headline benchmark, the counterpart of the repo's root
``bench.py``. Prints ONE JSON line:
``{"metric", "value", "unit", "vs_baseline", "extra_metrics": {...}}``.

    python -m image_classification_tpu_torch.cli bench [--device cuda]

Headline: ConvNeXt-Base train-step throughput (images/sec/chip) under the
reference V4 recipe (device-side augmentation, in-batch MixUp/CutMix, deep
supervision, AdamW + cosine, global-norm clip, EMA) at gradient
accumulation 1 (microbatch = the global batch of 32) on one card.
``extra_metrics`` holds the same step at accumulation 2 (the recipe's, as
``configs/v4.json`` trains), the aug pipeline's images/s and the
TTA-ensemble's inference images/s (2 fold models x 4 scale4 views, bf16).

``vs_baseline`` is against the reference's ~79 images/s (the V4 run's ~5 h
for 3 folds x 20 epochs x ~23,700 images on a consumer GPU, an upper bound).

Where it departs from the root ``bench.py``, on purpose:

- each train step and aug call draws from one seeded device generator
  (the JAX bench reuses one key every step): the same work, other draws;
- the rate is per the one card it ran on, not over ``device_count()``:
  the step runs on one device however many the host has;
- the aug is 50 calls dispatched from Python, not one compiled loop, so the
  host's dispatch is in its figure;
- ``vs_baseline`` is taken from the rounded ``value``, so the line agrees
  with itself.

The default device is the card: with no CUDA it raises before any work.
``device="cpu"`` runs the kernels' plain versions.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Sequence

import numpy as np
import torch

from image_classification_tpu_torch.aug.pipeline import aug_configs_from, train_augment
from image_classification_tpu_torch.core.config import Config
from image_classification_tpu_torch.infer.predict import _cast_inference_params
from image_classification_tpu_torch.infer.tta import get_tta
from image_classification_tpu_torch.models.factory import create_model
from image_classification_tpu_torch.train.loop import build_lr_schedule
from image_classification_tpu_torch.train.loss import build_criterion
from image_classification_tpu_torch.train.optim import build_optimizer
from image_classification_tpu_torch.train.step import (
    make_eval_views,
    make_forward_views,
    make_train_step,
    tta_num_views,
)
from image_classification_tpu_torch.train.train_state import create_train_state

REFERENCE_IMAGES_PER_SEC = 79.0  # see module docstring
METRIC = "convnext_base_v4_recipe_train_images_per_sec_per_chip"
STEPS_PER_EPOCH = 740            # the schedule's horizon, as the root bench.py
WARMUP_STEPS = 3
# The root bench.py's counts: train 30 steps, 20 at accumulation 2, 50 aug
# batches, 20 TTA batches of 2 models.
TRAIN_STEPS = 30
ACCUM2_STEPS = 20
AUG_ITERS = 50
INFER_BATCHES = 20
INFER_MODELS = 2


def bench_config() -> Config:
    """The reference V4 recipe's shapes at accumulation 1, as the root
    ``bench.py`` builds them."""
    return Config(
        model_name="convnext_base",
        num_classes=44,
        native_size=(60, 80),
        image_size=(260, 260),
        batch_size=32,
        gradient_accumulation_steps=1,
        use_deep_supervision=True,
        use_ema=True,
        compute_dtype="bfloat16",
    ).validate()


def _uint8_images(rng: np.random.Generator, n: int, cfg, device) -> torch.Tensor:
    return torch.from_numpy(
        rng.integers(0, 256, size=(n, *cfg.native_size, 3)).astype(np.uint8)).to(device)


def train_setup(cfg, device) -> tuple[Callable, object, dict]:
    """``(step, state, batch)``: the V4 train step of a ConvNeXt from seed 0
    on ``device``, its train state with EMA, and one uint8 batch from
    ``default_rng(0)``; ``step(state, batch)`` draws from one device
    generator seeded 1."""
    bundle = create_model(cfg, generator=torch.Generator().manual_seed(0))
    bundle.module.to(device)
    tx = build_optimizer(cfg, build_lr_schedule(cfg, STEPS_PER_EPOCH))
    state = create_train_state(bundle.module, use_ema=True)
    train_step = make_train_step(bundle, cfg, tx, build_criterion(cfg))
    rng = np.random.default_rng(0)
    batch = {"image": _uint8_images(rng, cfg.batch_size, cfg, device),
             "label": torch.from_numpy(rng.integers(0, cfg.num_classes,
                                                    size=cfg.batch_size)).to(device)}
    gen = torch.Generator(device=device).manual_seed(1)

    def step(state, batch):
        return train_step(state, batch, generator=gen)

    return step, state, batch


def bench_train(cfg, device, n_steps: int = TRAIN_STEPS) -> float:
    """Train images/s: ``n_steps`` steps on one batch after WARMUP_STEPS
    (which also build the kernels), host clock, each end read back."""
    step, state, batch = train_setup(cfg, device)
    for _ in range(WARMUP_STEPS):
        state, metrics = step(state, batch)
    metrics["loss"].item()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state, metrics = step(state, batch)
    # the last loss depends on every step before it on the same stream
    metrics["loss"].item()
    dt = time.perf_counter() - t0
    return n_steps * cfg.batch_size / dt


def aug_setup(cfg, device) -> Callable[[torch.Tensor], None]:
    """``call(acc)``: one ``train_augment`` of one uint8 batch from
    ``default_rng(0)``, drawn from a device generator seeded 2, its first
    pixel of each image summed into the device scalar ``acc``."""
    aug = aug_configs_from(cfg)
    images = _uint8_images(np.random.default_rng(0), cfg.batch_size, cfg, device)
    gen = torch.Generator(device=device).manual_seed(2)

    def call(acc: torch.Tensor) -> None:
        acc.add_(train_augment(images, gen, aug)[:, 0, 0, :].float().sum())

    return call


def bench_aug(cfg, device, n_iters: int = AUG_ITERS) -> float:
    """The aug pipeline's images/s: ``n_iters`` calls of :func:`aug_setup`'s
    call, once warm and once timed, each run ending in one readback."""
    call = aug_setup(cfg, device)

    def run() -> float:
        acc = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(n_iters):
            call(acc)
        return acc.item()

    run()
    t0 = time.perf_counter()
    run()
    dt = time.perf_counter() - t0
    return n_iters * cfg.batch_size / dt


def make_ensemble(cfg, models: Sequence[torch.nn.Module]) -> Callable:
    """``ensemble(images_u8) -> probs``: the eval views built once, one
    forward of each model over them, the mean of the models' probabilities.
    The models are cast for inference in place
    (``infer/predict.py:_cast_inference_params``)."""
    tta = get_tta(cfg)
    views_fn = make_eval_views(cfg, tta)
    n_views = tta_num_views(cfg, tta)
    forwards = [make_forward_views(_cast_inference_params(m.eval(), cfg), n_views)
                for m in models]

    @torch.no_grad()
    def ensemble(images_u8: torch.Tensor) -> torch.Tensor:
        xb = views_fn(images_u8)
        return torch.stack([f(xb) for f in forwards]).mean(0)

    return ensemble


def bench_infer(cfg, device, n_batches: int = INFER_BATCHES,
                n_models: int = INFER_MODELS) -> float:
    """TTA-ensemble images/s: ``n_models`` models from seeds 10, 11, ... over
    ``n_batches`` batches of ``batch_size * infer_batch_multiplier`` uint8
    images after one warm batch, host clock, ending in one readback."""
    models = [create_model(cfg, generator=torch.Generator().manual_seed(10 + i)
                           ).module.to(device) for i in range(n_models)]
    ensemble = make_ensemble(cfg, models)
    b = cfg.batch_size * cfg.infer_batch_multiplier
    images = _uint8_images(np.random.default_rng(3), b, cfg, device)
    ensemble(images).sum().item()
    t0 = time.perf_counter()
    for _ in range(n_batches):
        p = ensemble(images)
    total = p.sum().item()
    dt = time.perf_counter() - t0
    if not np.isfinite(total):
        raise RuntimeError(f"bench: the TTA ensemble's probabilities sum to {total}")
    return n_batches * b / dt


def main(device: str = "cuda") -> dict:
    """Runs the four rates in the root bench's order, prints its line and
    returns it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: torch.cuda.is_available() is False; it measures "
                           "a CUDA card (--device cpu runs the plain versions)")
    cfg = bench_config()
    train_ips = bench_train(cfg, device, TRAIN_STEPS)
    train_ips_accum2 = bench_train(cfg.replace(gradient_accumulation_steps=2), device,
                                   ACCUM2_STEPS)
    aug_ips = bench_aug(cfg, device, AUG_ITERS)
    infer_ips = bench_infer(cfg, device, INFER_BATCHES, INFER_MODELS)
    value = round(train_ips, 2)     # one card
    line = {
        "metric": METRIC,
        "value": value,
        "unit": "images/sec/chip",
        "vs_baseline": round(value / REFERENCE_IMAGES_PER_SEC, 3),
        "extra_metrics": {
            "train_accum2_images_per_sec_per_chip": round(train_ips_accum2, 2),
            "aug_pipeline_images_per_sec": round(aug_ips, 1),
            "tta_ensemble_infer_images_per_sec": round(infer_ips, 1),
        },
    }
    print(json.dumps(line), flush=True)
    return line
