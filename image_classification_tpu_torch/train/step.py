"""The train and eval steps and the predict-side steps of
``image_classification_tpu/train/step.py``: ``make_train_step``,
``make_eval_step``, ``make_bn_update_step``, ``make_eval_views``,
``make_forward_views``, ``tta_num_views`` and ``make_predict_step``.

The model's mode is set by the step that runs it: the train step and the
BN update run it in train mode (batch statistics, dropout and drop-path
active, running statistics updated), the eval step and the predict steps in
eval mode (running statistics, no masks).

With ``aug_enabled=true`` the train step takes uint8 images from the loader
and runs the device-side augmentation, then in-batch MixUp/CutMix when
``mixup_alpha > 0 or cutmix_alpha > 0``; with ``aug_enabled=false`` it takes
pre-augmented float images. Its random draws (the aug's, the mix's, then
per microbatch one keep-mask for each dropout and drop-path site of the
model) come from a ``torch.Generator`` on the model's device, or
ready-made (:func:`draw_train_step`; the tests feed the JAX package's).
Parity notes, as in the JAX module: microbatch ``k`` holds rows ``k,
k+accum, ...`` of the batch; the microbatch gradients are summed
(``grad_accum_reduction='sum'``, the reference's AMP path) or averaged;
the loss is the mean of the microbatch losses and the accuracy is taken
on the main head against the integer labels from before the mix; EMA
updates once per optimizer step. Metrics come back as device tensors:
nothing in a step waits for the card. While a profiler records, each step
records the span ``train_step`` and inside it ``train_step.augment``,
``train_step.forward`` and ``train_step.backward`` (one of each a
microbatch) and ``train_step.update`` (``utils/profiler.py:span``).

Data parallelism (``mesh`` with a data axis of D > 1 ranks,
``parallel/mesh.py``): each rank holds rows ``[d*B/D, (d+1)*B/D)`` of the
global batch of B, and the step computes the JAX step's function on the
global batch, as the SPMD program over a sharded batch does. Every draw is
made once for the global batch, from the same seeded generator on every
rank (or handed in whole), and each rank takes its rows
(:func:`local_draws`); the mix gathers its partners across ranks
(``aug/mix.py``); BatchNorm reduces its statistics over the ranks
(``models/layers.py:batchnorm_group``); microbatch ``k`` is global rows
``k::accum``, of which this rank holds a contiguous run; each loss is this
rank's sum over the global row count (``train/loss.py``); the gradients
are summed over the ranks before the fused update, so every rank applies
the global gradient and the ranks' states stay bit-identical; the
metrics are sums over the ranks. Every kernel runs on the rank's own
rows.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from image_classification_tpu_torch.aug.mix import (
    MixCfg,
    MixDraws,
    draw_mix,
    mixup_cutmix_batch,
)
from image_classification_tpu_torch.aug.pipeline import (
    AugDraws,
    apply_train_augment,
    aug_configs_from,
    draw_train_augment,
    eval_preprocess,
)
from image_classification_tpu_torch.models.layers import (
    batchnorm_group,
    draw_drop_masks,
    drop_masks,
    drop_sites,
)
from image_classification_tpu_torch.parallel.distributed import all_reduce_sum_
from image_classification_tpu_torch.parallel.mesh import DATA_AXIS
from image_classification_tpu_torch.parallel.shardings import sharded_mask, tensor_parallel
from image_classification_tpu_torch.train.fused import fused_adamw_ema
from image_classification_tpu_torch.train.loss import smoothed_cross_entropy
from image_classification_tpu_torch.train.optim import trainable_indices
from image_classification_tpu_torch.train.train_state import TrainState
from image_classification_tpu_torch.utils.profiler import span


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _main_head(outputs) -> torch.Tensor:
    return outputs[0] if isinstance(outputs, (tuple, list)) else outputs


def set_mode(model: torch.nn.Module, training: bool) -> None:
    """Train or eval mode for the whole module tree, set only when it
    differs (``nn.Module.train`` walks every submodule)."""
    if model.training != training:
        model.train(training)


class StepDraws(NamedTuple):
    aug: AugDraws | None   # None with aug_enabled=false
    mix: MixDraws | None   # None when the config mixes nothing
    # per microbatch, one keep-mask per drop site (layers.drop_sites)
    drop: tuple[tuple[torch.Tensor, ...], ...] = ()


def mix_config(cfg) -> MixCfg | None:
    """The MixUp/CutMix config, or None when neither alpha is positive."""
    if not (cfg.mixup_alpha > 0 or cfg.cutmix_alpha > 0):
        return None
    return MixCfg(mixup_alpha=cfg.mixup_alpha, cutmix_alpha=cfg.cutmix_alpha,
                  prob=cfg.mix_prob, num_classes=cfg.num_classes)


def draw_train_step(generator: torch.Generator, shape, cfg, sites=()) -> StepDraws:
    """Every random draw of one train step for a batch of ``shape`` (B, H,
    W, C), on ``generator``'s device: with ``aug_enabled=true`` the
    augmentation's, then the mix's; then for each of the
    ``gradient_accumulation_steps`` microbatches one keep-mask per drop site
    (``sites``: ``layers.drop_sites(model)``, in JAX's draw order; none
    for a ConvNeXt or ViT without drop rates)."""
    aug_d = mix_d = None
    if cfg.aug_enabled:
        aug = aug_configs_from(cfg)
        out_shape = (shape[0], *aug["image_size"], shape[-1])
        mix = mix_config(cfg)
        aug_d = draw_train_augment(generator, shape, aug)
        mix_d = None if mix is None else draw_mix(generator, out_shape, mix)
    accum = cfg.gradient_accumulation_steps
    drop = tuple(draw_drop_masks(generator, sites, shape[0] // accum)
                 for _ in range(accum)) if sites else ()
    return StepDraws(aug_d, mix_d, drop)


def data_shard(mesh) -> tuple[int, int, object]:
    """(this rank's index on the data axis, the axis' size, its group);
    (0, 1, None) without a mesh."""
    if mesh is None:
        return 0, 1, None
    return mesh.index(DATA_AXIS), mesh.size(DATA_AXIS), mesh.group(DATA_AXIS)


def _shard(tree, index: int, count: int):
    """Part ``index`` of ``count`` equal runs along dim 0 of every tensor."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        n = tree.shape[0] // count
        return tree[index * n:(index + 1) * n]
    parts = (_shard(x, index, count) for x in tree)
    return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)


def local_draws(draws: StepDraws, index: int, count: int, sites=()) -> StepDraws:
    """The rows of ``draws`` (a global batch's) that data rank ``index`` of
    ``count`` holds: its contiguous run of the aug's and the mix's per-row
    draws (the mix partners stay global row numbers), and of each
    microbatch's per-row drop masks (microbatch ``k``, global rows
    ``k::accum``, holds this rank's local microbatch ``k`` as the same
    run of its rows); a mask shared by every row (ViT's attention dropout)
    stays whole. ``sites``: the drop sites the masks belong to."""
    if count == 1:
        return draws
    drop = tuple(tuple(_shard(mask, index, count) if s.per_row else mask
                       for s, mask in zip(sites, masks)) for masks in draws.drop)
    return StepDraws(_shard(draws.aug, index, count), _shard(draws.mix, index, count),
                     drop)


def make_batch_augment(cfg, mesh=None) -> Callable:
    """``augment(batch, generator=None, draws=None) -> (images, targets)``:
    the train step's input stage. With ``aug_enabled=true``: the
    augmentation of the uint8 'image' batch, then MixUp/CutMix (soft f32
    targets) when the config mixes, from ``draws`` or else fresh draws on
    ``generator``. With ``aug_enabled=false``: the batch as it is. Under
    data parallelism (``mesh``) ``batch`` holds this rank's rows, and
    ``draws`` (or the fresh ones) are the global batch's."""
    if not cfg.aug_enabled:
        return lambda batch, *_, **__: (batch["image"], batch["label"])
    aug = aug_configs_from(cfg)
    mix = mix_config(cfg)
    index, count, group = data_shard(mesh)

    def augment(batch: dict, generator: torch.Generator | None = None,
                draws: StepDraws | None = None):
        images_u8, labels = batch["image"], batch["label"]
        if draws is None:
            if generator is None:
                raise ValueError("aug_enabled=true: pass a torch.Generator on "
                                 "the model's device, or ready-made draws")
            shape = (images_u8.shape[0] * count, *images_u8.shape[1:])
            draws = draw_train_step(generator, shape, cfg)
        draws = local_draws(draws, index, count)
        images = apply_train_augment(images_u8, draws.aug, aug)
        if mix is None:
            return images, labels
        return mixup_cutmix_batch(images, labels, draws.mix, mix, group)

    return augment


def make_train_step(bundle, cfg, tx, criterion: Callable, mesh=None) -> Callable:
    """Build ``train_step(state, batch, generator=None, draws=None) ->
    (state, metrics)``: the input stage of :func:`make_batch_augment`, one
    optimizer step over ``cfg.gradient_accumulation_steps`` microbatches,
    then the fused clip + AdamW + EMA update in place; ``metrics`` holds
    the global gradient norm as ``grad_norm`` where the clip or
    ``debug_nans`` computes it. ``batch`` holds
    'image' and 'label' int (B,) on the model's device: uint8 (B, h, w, 3)
    with ``aug_enabled=true``, float (B, H, W, 3) already preprocessed with
    ``aug_enabled=false``; ``tx`` is ``train/optim.py:build_optimizer``'s
    result. With ``freeze_stages > 0`` only the trainable parameters are
    differentiated and updated. A generator (or draws) is needed whenever
    the step draws anything: with the aug on, or a model with drop
    sites. With a ``mesh`` of data size D the batch is this rank's B/D
    rows, ``draws`` are the global batch's, and ``criterion`` must be built
    with the mesh's data group (``build_criterion(..., group=...)``). A
    model split over the model axis (``parallel/shardings.py:shard_model``,
    before this call) updates its shards."""
    index, count, group = data_shard(mesh)
    if getattr(criterion, "group", None) is not group:
        raise ValueError("the criterion's process group is not the mesh's data "
                         "group: build it with build_criterion(..., group=...)")
    augment = make_batch_augment(cfg, mesh)
    sites = drop_sites(bundle.module)
    params = list(bundle.module.parameters())
    names = [n for n, _ in bundle.module.named_parameters()]
    trainable = trainable_indices(names, tx.freeze_stages)
    # tensor parallelism: the split parameters' gradients are shards
    sharded = sharded_mask(bundle.module, names)
    tp = tensor_parallel(bundle.module)
    if trainable is not None:
        params = [params[i] for i in trainable]
        sharded = None if sharded is None else [sharded[i] for i in trainable]

    def train_step(state: TrainState, batch: dict,
                   generator: torch.Generator | None = None,
                   draws: StepDraws | None = None):
        with span("train_step", step=state.step, rows=batch["image"].shape[0]):
            with span("train_step.augment"):
                if draws is None and (cfg.aug_enabled or sites):
                    if generator is None:
                        raise ValueError("this train step draws (aug or drop masks): pass a "
                                         "torch.Generator on the model's device, or draws")
                    shape = (batch["image"].shape[0] * count, *batch["image"].shape[1:])
                    draws = draw_train_step(generator, shape, cfg, sites)
                images, targets = augment(batch, draws=draws)
            drop = None if draws is None else local_draws(draws, index, count, sites).drop
            grads, metrics = accumulate_grads(bundle.module, cfg, criterion,
                                              images, targets, batch["label"], params,
                                              drop=drop, group=group)
            with span("train_step.update"):
                all_reduce_sum_(grads, group)
                gnorm = fused_adamw_ema(grads, state, tx=tx, cfg=cfg, trainable=trainable,
                                        sharded=sharded,
                                        model_group=None if tp is None else tp.group)
            if gnorm is not None:
                metrics["grad_norm"] = gnorm
            state.step += 1
        return state, metrics

    return train_step


def accumulate_grads(model: torch.nn.Module, cfg, criterion: Callable,
                     images: torch.Tensor, targets: torch.Tensor,
                     labels: torch.Tensor | None = None,
                     params: list[torch.Tensor] | None = None, drop=None,
                     group=None):
    """The gradient half of the train step, with the model in train mode:
    ``(grads, metrics)``, the gradients aligned with ``params`` (default
    ``model.parameters()``; autograd runs no part of the backward that only
    other parameters need) and reduced over the
    ``cfg.gradient_accumulation_steps`` strided microbatches. ``drop``
    holds one tuple of keep-masks per microbatch for the model's drop sites
    (``StepDraws.drop``). ``targets`` are what the loss takes (integer
    labels, or soft (B, classes) ones after a mix); the accuracy counts
    argmax hits against the integer ``labels`` (default: ``targets``),
    which after a mix are the labels from before it. With a data-parallel
    ``group`` the rows are this rank's of the global batch: BatchNorm
    reduces over the group, the gradients are this rank's share (the
    caller sums them over the group) and the metrics the global batch's."""
    if labels is None:
        labels = targets
    accum = cfg.gradient_accumulation_steps
    if images.shape[0] % accum:
        raise ValueError(f"batch {images.shape[0]} is not divisible by "
                         f"gradient_accumulation_steps={accum}")
    if params is None:
        params = list(model.parameters())
    sites = drop_sites(model) if drop else []
    set_mode(model, True)
    grads = None
    losses, correct = [], []
    for k in range(accum):
        # the masks are cleared when the block exits, before the backward: a
        # ConvNeXt block under block_remat hands its recompute the mask its
        # forward read (models/convnext.py)
        with span("train_step.forward", rows=images.shape[0] // accum):
            with drop_masks(sites, drop[k] if sites else ()), batchnorm_group(model, group):
                outputs = model(images[k::accum])
            loss = criterion(outputs, targets[k::accum])
        with span("train_step.backward"):
            g = torch.autograd.grad(loss, params)
            grads = list(g) if grads is None else torch._foreach_add(grads, g)
        losses.append(loss.detach())
        correct.append(_main_head(outputs).detach().argmax(dim=-1)
                       == labels[k::accum].reshape(-1))
    if cfg.grad_accum_reduction == "mean":
        torch._foreach_div_(grads, float(accum))
    if group is None:
        return grads, {"loss": torch.stack(losses).mean(),
                       "accuracy": torch.cat(correct).float().mean()}
    sums = torch.cat([torch.stack(losses), torch.cat(correct).float().sum()[None]])
    dist.all_reduce(sums, group=group)
    rows = images.shape[0] * dist.get_world_size(group)
    return grads, {"loss": sums[:accum].mean(), "accuracy": sums[accum] / rows}


def make_eval_step(bundle, cfg, use_ema: bool = True, mesh=None) -> Callable:
    """Build ``eval_step(state, batch) -> metrics`` with masked sums, so the
    padding rows of a last batch count for nothing. The deep-supervised
    model is scored on its main head with label-smoothed CE, on the EMA
    weights when ``use_ema`` and ``cfg.use_ema``, in eval mode with the
    module's live running statistics (as the JAX step pairs the EMA
    parameters with the live ``batch_stats``). ``batch``: 'image' uint8
    (B, h, w, 3), 'label' (B,) and 'mask' (B,) bool on the device (a host
    mask is copied, and the copy waits for the card). With a ``mesh`` the
    batch is this rank's rows and the sums are those over the data axis."""
    dtype = compute_dtype(cfg)
    k = cfg.num_classes
    group = data_shard(mesh)[2]

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict:
        set_mode(bundle.module, False)
        params = state.eval_params(use_ema=use_ema and cfg.use_ema)
        images = eval_preprocess(
            batch["image"], tuple(cfg.image_size), tuple(cfg.mean),
            tuple(cfg.std), dtype=dtype, round_uint8=cfg.eval_resize_uint8,
        )
        outputs = torch.func.functional_call(bundle.module, params, (images,))
        logits = _main_head(outputs)
        labels = batch["label"].long()
        mask = torch.as_tensor(batch["mask"]).to(logits.device, torch.float32)
        per = smoothed_cross_entropy(logits, labels, cfg.label_smoothing,
                                     reduction="none")
        preds = logits.argmax(dim=-1)
        cm = torch.zeros(k * k, dtype=torch.float32, device=logits.device)
        cm.index_add_(0, labels * k + preds, mask)
        sums = [(per * mask).sum(), ((preds == labels) * mask).sum(), mask.sum(), cm]
        all_reduce_sum_(sums, group)
        return {
            "loss_sum": sums[0],
            "correct": sums[1],
            "count": sums[2],
            "confusion": sums[3].reshape(k, k),
        }

    return eval_step


def make_bn_update_step(bundle, cfg, mesh=None) -> Callable:
    """``bn_step(params, batch)``: one forward in train mode with the
    parameters ``params`` (a dict by name, e.g. SWA's average) on the
    ``eval_preprocess``-ed uint8 'image' batch, which updates the module's
    running statistics in place with the BN momentum; they are not reset
    first. Drop-path and dropout stay active with the same masks for every
    batch of a size: a generator seeded 0 afresh per batch, as the JAX step
    passes ``jax.random.key(0)``. This is the JAX package's step, not
    torch's ``update_bn`` (which resets the statistics and averages them
    equally). With a ``mesh`` the batch is this rank's rows: the statistics
    are the global batch's and the masks this rank's rows of the global
    batch's."""
    dtype = compute_dtype(cfg)
    model = bundle.module
    sites = drop_sites(model)
    index, count, group = data_shard(mesh)

    @torch.no_grad()
    def bn_step(params: dict[str, torch.Tensor], batch: dict) -> None:
        images = eval_preprocess(
            batch["image"], tuple(cfg.image_size), tuple(cfg.mean),
            tuple(cfg.std), dtype=dtype, round_uint8=cfg.eval_resize_uint8,
        )
        gen = torch.Generator(device=images.device).manual_seed(0)
        masks = draw_drop_masks(gen, sites, images.shape[0] * count)
        masks = local_draws(StepDraws(None, None, (masks,)), index, count, sites).drop[0]
        set_mode(model, True)
        with drop_masks(sites, masks), batchnorm_group(model, group):
            torch.func.functional_call(model, params, (images,))

    return bn_step


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
    """``forward(x_views) -> probs (B, classes)``: one forward in eval mode
    over the stacked views, softmax in f32, mean over views."""

    @torch.no_grad()
    def forward(x_views: torch.Tensor) -> torch.Tensor:
        set_mode(model, False)
        logits = _main_head(model(x_views))
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
