"""The host-side epoch loop of one fold, port of
``image_classification_tpu/train/loop.py``: ``train_fold`` (the epoch loop
under a :class:`StepTimer`, validation on the EMA weights, ``metrics.jsonl``,
best-acc and best-loss checkpoints, patience early stop, the plateau
schedule, LR recording, full-state checkpoints and resume),
``build_lr_schedule``, ``progressive_size`` and ``evaluate``; and SWA
(a snapshot of the parameters after each validation from
``swa_start_epoch`` on; after the last epoch the average, its BatchNorm
statistics refreshed over the train set, validates and competes for the
best checkpoints). ``swa_lr`` is read nowhere, as in the JAX package.

Random numbers: JAX's threefry keys cannot be reproduced in torch. A fold's
initial weights come from a ``torch.Generator`` seeded from
``(cfg.seed, fold)``; a step's augmentation, mix and drop-mask draws from a
generator on the card seeded from ``(cfg.seed, fold, "steps", step)`` (the
JAX step folds the step into its key the same way), so a resumed fold draws
what the straight run drew. The epoch orders are the JAX package's (numpy
samplers).

``debug_nans`` (JAX's ``jax_debug_nans``) checks after each train step that
the loss and the global gradient norm are finite, and raises
``FloatingPointError`` naming the fold and step; the check reads the card,
so it runs only when the key is set.

Data parallelism (``mesh``, ``parallel/mesh.py``): every rank of the
fold's data axis runs this loop on its rows of each global batch; the steps
reduce over the ranks (``train/step.py``), so the metrics, and with them
every decision (best checkpoint, patience, plateau), are the same on every
rank. A model axis splits the MLP pairs (``parallel/shardings.py``); the
checkpoints hold whole tensors. Only the fold's primary rank (data and
model index 0) writes its files: ``metrics.jsonl``, the best checkpoints,
the train states and the LR plot. A :class:`FoldRun` says how the fold
shares its run with others: the sequential loop's defaults here, the
side-by-side folds of ``train/foldpar.py`` there.

Not ported: the compiled-step sharing across folds (``program_sig`` /
``shared``), which exists to reuse XLA compiles.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from image_classification_tpu_torch.models.factory import (
    ModelBundle,
    create_model,
    load_pretrained_into,
)
from image_classification_tpu_torch.train.loss import build_criterion
from image_classification_tpu_torch.train.optim import build_optimizer, set_learning_rate
from image_classification_tpu_torch.train.schedule import (
    PlateauScheduler,
    warmup_cosine_schedule,
)
from image_classification_tpu_torch.models.layers import drop_sites
from image_classification_tpu_torch.parallel.mesh import DATA_AXIS
from image_classification_tpu_torch.parallel.shardings import gather_tree, shard_model
from image_classification_tpu_torch.train.step import (
    make_bn_update_step,
    make_eval_step,
    make_train_step,
)
from image_classification_tpu_torch.train.train_state import create_train_state, swa_update
from image_classification_tpu_torch.utils import checkpoint as ckpt
from image_classification_tpu_torch.utils.lr_monitor import LRMonitor
from image_classification_tpu_torch.utils.metrics import macro_f1, per_class_f1
from image_classification_tpu_torch.utils.profiler import StepTimer, sync, trace

logger = logging.getLogger("ic_tpu_torch")


@dataclass
class FoldResult:
    fold: int
    best_val_acc: float
    best_variables: dict[str, torch.Tensor]   # the best weights, a state dict on the host
    bundle: ModelBundle                       # the fold's model, with its last weights
    history: list[dict] = field(default_factory=list)


def derived_seed(*words: int | str) -> int:
    """A 63-bit seed from integers and strings (a string counts as the
    integer of its UTF-8 bytes), through numpy's SeedSequence."""
    ints = [w if isinstance(w, int) else int.from_bytes(w.encode(), "little")
            for w in words]
    return int(np.random.SeedSequence(ints).generate_state(1, np.uint64)[0] >> 1)


def _append_metrics(output_dir: str, fold: int, record: dict) -> None:
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "metrics.jsonl"), "a") as f:
        f.write(json.dumps({"fold": fold, **record}) + "\n")


class FoldRun:
    """How :func:`train_fold` runs beside other folds; these are the
    sequential loop's ways, and ``train/foldpar.py`` overrides them."""

    steps_per_epoch: int | None = None   # None: the whole train loader

    def joint_stop(self, stopping: bool) -> bool:
        """Whether the fold stops, given whether it is past its patience."""
        return stopping

    def append_metrics(self, cfg, fold: int, record: dict, primary: bool) -> None:
        if primary:
            _append_metrics(cfg.output_dir, fold, record)

    def save_state(self, writer, cfg, fold: int, state, epoch: int,
                   host_state: dict, primary: bool) -> None:
        tree = ckpt.state_tree(state)   # every rank: a collective under TP
        if not primary:
            return
        if cfg.async_checkpoint:
            writer.submit(ckpt.save_train_state, cfg.output_dir, fold,
                          ckpt.snapshot(tree), epoch, cfg, host_state=host_state)
        else:
            ckpt.save_train_state(cfg.output_dir, fold, tree, epoch, cfg,
                                  host_state=host_state)

    def load_state(self, cfg, fold: int, state):
        return ckpt.load_train_state(cfg.output_dir, fold, state)


def check_finite(metrics: dict, fold: int, epoch: int, step: int) -> None:
    """Raise ``FloatingPointError`` if the step's loss or gradient norm (where
    the step computed one) is not finite."""
    bad = {k: float(metrics[k]) for k in ("loss", "grad_norm")
           if k in metrics and not np.isfinite(float(metrics[k]))}
    if bad:
        raise FloatingPointError(f"debug_nans: fold {fold} epoch {epoch + 1} "
                                 f"step {step}: non-finite {bad}")


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


def progressive_size(cfg, epoch: int) -> tuple[int, int]:
    """Training input size for ``epoch`` under progressive resizing: earlier
    epochs train at smaller (even-rounded) fractions of ``image_size``; the
    final stage is always the full size."""
    if not cfg.progressive_resizing:
        return tuple(cfg.image_size)
    scales = cfg.progressive_scales
    idx = min(len(scales) - 1, epoch * len(scales) // max(1, cfg.epochs))
    h = int(round(cfg.image_size[0] * scales[idx] / 2)) * 2
    w = int(round(cfg.image_size[1] * scales[idx] / 2)) * 2
    return (h, w)


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


def finalize_swa(bundle: ModelBundle, cfg, state, train_loader, val_loader,
                 eval_step, mesh=None, steps: int | None = None):
    """SWA's average as the fold's model: its weights go into the model
    (the last weights are not needed after the last epoch) with EMA off;
    a model with BatchNorm refreshes its running statistics with one
    train-mode forward per train batch (epoch 0's order, its first
    ``steps`` batches when given), on from the live ones; then it
    validates. Returns (the SWA state, its validation)."""
    swa_state = dataclasses.replace(state, ema=None)
    with torch.no_grad():
        torch._foreach_copy_(swa_state.params(), state.swa)
    if bundle.has_batch_stats:
        bn_step = make_bn_update_step(bundle, cfg, mesh=mesh)
        params = swa_state.eval_params(use_ema=False)
        train_loader.set_epoch(0)
        for i, batch in enumerate(train_loader):
            if steps is not None and i == steps:
                break
            bn_step(params, batch)
    return swa_state, evaluate(eval_step, swa_state, val_loader)


def train_fold(cfg, train_loader, val_loader, fold: int = 1,
               class_counts: np.ndarray | None = None, resume: bool = False,
               model_name: str | None = None, mesh=None,
               run: FoldRun | None = None) -> FoldResult:
    """Train one fold on ``train_loader``'s device, validating on
    ``val_loader`` after every epoch; returns the best weights (by val
    accuracy, SWA's average included) and the per-epoch history. With a
    ``mesh`` the loaders yield this rank's rows of the data axis; only the
    primary rank's result is sure to carry the best weights."""
    run = run or FoldRun()
    device = train_loader.device
    group = None if mesh is None else mesh.group(DATA_AXIS)
    n_data = 1 if mesh is None else mesh.size(DATA_AXIS)
    primary = mesh is None or mesh.is_primary
    steps_per_epoch = run.steps_per_epoch or len(train_loader)
    bundle = create_model(cfg, model_name, generator=torch.Generator().manual_seed(
        derived_seed(cfg.seed, fold)))
    load_pretrained_into(bundle.module, cfg)
    bundle.module.to(device)
    shard_model(bundle.module, mesh)
    n_params = sum(p.numel() for p in bundle.module.parameters())
    logger.info("fold %d: %s with %.2fM parameters", fold, bundle.name, n_params / 1e6)

    criterion = build_criterion(
        cfg, class_counts=None if class_counts is None
        else torch.as_tensor(class_counts, device=device), group=group)
    lr_schedule = build_lr_schedule(cfg, steps_per_epoch)
    tx = build_optimizer(cfg, lr_schedule)
    plateau = (PlateauScheduler(cfg.lr, cfg.plateau_factor, cfg.plateau_patience)
               if cfg.schedule == "plateau" else None)
    state = create_train_state(bundle.module, use_ema=cfg.use_ema, use_swa=cfg.use_swa)

    start_epoch = 0
    resumed_host: dict = {}
    if resume:
        restored = run.load_state(cfg, fold, state)
        if restored is not None:
            state, start_epoch, resumed_host = restored
            logger.info("fold %d: resumed at epoch %d", fold, start_epoch)

    # one train step per input size (progressive resizing); rebuilt when the
    # plateau schedule sets a new LR
    step_cache: dict[tuple[int, int], object] = {}

    def train_step_for(epoch: int):
        size = progressive_size(cfg, epoch)
        if size not in step_cache:
            step_cache[size] = make_train_step(bundle, cfg.replace(image_size=size),
                                               tx, criterion, mesh=mesh)
        return step_cache[size]

    eval_step = make_eval_step(bundle, cfg, use_ema=cfg.ema_eval, mesh=mesh)
    draws = cfg.aug_enabled or bool(drop_sites(bundle.module))
    generator = torch.Generator(device=device) if draws else None
    use_ema_eval = cfg.use_ema and cfg.ema_eval

    # Host bookkeeping, restored on resume so a resumed fold is the exact
    # continuation (no re-saving a worse "best", no patience reset).
    best_val_acc = float(resumed_host.get("best_val_acc", -1.0))
    best_val_loss = float(resumed_host.get("best_val_loss", float("inf")))
    best_variables: dict = {}
    patience_counter = int(resumed_host.get("patience_counter", 0))
    if plateau is not None and resumed_host.get("plateau"):
        plateau.load_state_dict(resumed_host["plateau"])
        tx = set_learning_rate(tx, plateau.lr)
    if best_val_acc > -1.0:
        # the on-disk best, so the result carries it even if no epoch after
        # the resume improves on it (every rank reads it, so that all agree
        # on whether the final weights stand in below)
        try:
            best_variables, _ = ckpt.load_best(cfg.model_save_path, fold)
        except FileNotFoundError:
            logger.warning("fold %d: could not reload best checkpoint", fold)
    have_best = bool(best_variables)   # the same on every rank
    history: list[dict] = []
    lr_monitor = LRMonitor()
    # Background writer: device snapshots go to a thread that copies them to
    # the host and writes while the next epoch trains.
    writer = ckpt.AsyncCheckpointWriter()
    best_box: dict = {}

    def current_lr() -> float:
        return plateau.lr if plateau is not None else tx.schedule(state.step)

    for epoch in range(start_epoch, cfg.epochs):
        train_loader.set_epoch(epoch)
        train_step = train_step_for(epoch)
        timer = StepTimer()
        losses, accs = [], []
        it = iter(train_loader)
        profiled = bool(cfg.profile_dir) and epoch == start_epoch + 1 and primary
        region = (trace(cfg.profile_dir, f"fold{fold}_epoch{epoch + 1}")
                  if profiled else contextlib.nullcontext())
        with region:
            step_i = 0
            while step_i < steps_per_epoch:
                with timer.data_wait():
                    batch = next(it, None)
                if batch is None:
                    break
                if generator is not None:
                    generator.manual_seed(derived_seed(cfg.seed, fold, "steps",
                                                       state.step))
                state, metrics = train_step(state, batch, generator=generator)
                timer.step(n_images=batch["image"].shape[0] * n_data)
                if cfg.debug_nans:
                    check_finite(metrics, fold, epoch, state.step)
                losses.append(metrics["loss"])
                accs.append(metrics["accuracy"])
                step_i += 1
                # the device read happens only at log points
                if cfg.log_interval > 0 and step_i % cfg.log_interval == 0:
                    logger.info(
                        "fold %d epoch %d step %d/%d: loss %.4f acc %.4f "
                        "lr %.2e (%.1f img/s)", fold, epoch + 1, step_i,
                        steps_per_epoch, float(metrics["loss"]),
                        float(metrics["accuracy"]), current_lr(),
                        timer.images_per_sec)
            sync(device)   # the last step, before the clock is read
        perf = timer.summary()  # the train window only, before validation
        train_loss = float(np.mean(torch.stack(losses).tolist())) if losses else 0.0
        train_acc = float(np.mean(torch.stack(accs).tolist())) if accs else 0.0

        val = evaluate(eval_step, state, val_loader)
        record = {
            "epoch": epoch,
            "train_loss": train_loss,
            "train_acc": train_acc,
            "val_loss": val["loss"],
            "val_acc": val["accuracy"],
            "val_macro_f1": val["macro_f1"],
            "val_min_class_f1": val["min_class_f1"],
            **perf,
        }
        history.append(record)
        run.append_metrics(cfg, fold, record, primary)
        logger.info(
            "fold %d epoch %d/%d: train %.4f/%.4f val %.4f/%.4f f1 %.4f "
            "(%.1f img/s, duty %.1f%%)", fold, epoch + 1, cfg.epochs, train_loss,
            train_acc, val["loss"], val["accuracy"], val["macro_f1"],
            perf["images_per_sec"], 100 * perf["duty_cycle"])

        if cfg.use_swa and epoch + 1 >= cfg.swa_start_epoch:
            swa_update(state)

        improved_acc = val["accuracy"] > best_val_acc
        improved_loss = cfg.save_best_loss and val["loss"] < best_val_loss
        if improved_acc:
            best_val_acc = val["accuracy"]
            patience_counter = 0
            have_best = True
        else:
            patience_counter += 1
        if improved_loss:
            best_val_loss = val["loss"]
        if improved_acc or improved_loss:
            # one snapshot serves both tiers (the same weights this epoch);
            # whole tensors under tensor parallelism, gathered by every rank
            weights = gather_tree(state.eval_state_dict(use_ema=use_ema_eval),
                                  bundle.module)
        if (improved_acc or improved_loss) and primary:

            def best_job(w, acc=val["accuracy"], loss=val["loss"],
                         ia=improved_acc, il=improved_loss) -> dict:
                host = ckpt.to_host(w)
                if ia:
                    ckpt.save_best(cfg.model_save_path, fold, host, acc, val_loss=loss)
                if il:
                    ckpt.save_best(cfg.model_save_path, fold, host, acc,
                                   val_loss=loss, metric="loss")
                return host

            if cfg.async_checkpoint:
                def run_async(w=ckpt.snapshot(weights), job=best_job,
                              ia=improved_acc) -> None:
                    host = job(w)
                    if ia:
                        best_box["variables"] = host
                writer.submit(run_async)
            else:
                host = best_job(weights)
                if improved_acc:
                    best_variables = host

        # the plateau step before the epoch checkpoint, so the new LR and the
        # scheduler's internals are part of the resumable state
        if plateau is not None:
            metric = train_acc if cfg.plateau_metric == "train_acc" else val["accuracy"]
            tx = set_learning_rate(tx, plateau.step(metric))
            step_cache.clear()

        lr_monitor.record(state.step, current_lr())

        stopping = run.joint_stop(patience_counter >= cfg.patience)
        if cfg.save_state_every > 0 and (
                (epoch + 1 - start_epoch) % cfg.save_state_every == 0
                or epoch == cfg.epochs - 1 or stopping):
            host_state = {
                "best_val_acc": best_val_acc,
                "best_val_loss": best_val_loss,
                "patience_counter": patience_counter,
                "plateau": plateau.state_dict() if plateau is not None else None,
            }
            run.save_state(writer, cfg, fold, state, epoch, host_state, primary)

        if stopping:
            logger.info("fold %d: early stopping after epoch %d", fold, epoch + 1)
            break

    # every pending write lands before the result is assembled (and before
    # SWA may replace the best checkpoint)
    writer.join()
    if "variables" in best_box:
        best_variables = best_box["variables"]

    if cfg.use_swa and state.swa_count > 0:
        swa_state, swa_val = finalize_swa(bundle, cfg, state, train_loader,
                                          val_loader, eval_step, mesh=mesh,
                                          steps=run.steps_per_epoch)
        logger.info("fold %d SWA (%d snapshots): val %.4f/%.4f", fold,
                    state.swa_count, swa_val["loss"], swa_val["accuracy"])
        wins_acc = swa_val["accuracy"] > best_val_acc
        wins_loss = cfg.save_best_loss and swa_val["loss"] < best_val_loss
        if wins_acc or wins_loss:
            host = ckpt.to_host(gather_tree(swa_state.eval_state_dict(use_ema=False),
                                            bundle.module))
        if wins_acc:
            best_val_acc = swa_val["accuracy"]
            have_best = True
            if primary:
                best_variables = host
                ckpt.save_best(cfg.model_save_path, fold, host, best_val_acc,
                               val_loss=swa_val["loss"])
        if wins_loss:
            # SWA competes in the loss tier too
            best_val_loss = swa_val["loss"]
            if primary:
                ckpt.save_best(cfg.model_save_path, fold, host, swa_val["accuracy"],
                               val_loss=swa_val["loss"], metric="loss")

    if lr_monitor.lrs and primary:
        try:
            lr_monitor.plot(os.path.join(cfg.output_dir, f"lr_curve_fold{fold}.png"))
        except Exception as e:  # plotting must never kill a training run
            logger.debug("fold %d: LR plot skipped (%s)", fold, e)

    if not have_best:  # zero epochs or all NaN: the final weights
        best_variables = ckpt.to_host(gather_tree(state.eval_state_dict(use_ema=False),
                                                  bundle.module))
    return FoldResult(fold=fold, best_val_acc=best_val_acc,
                      best_variables=best_variables, bundle=bundle, history=history)
