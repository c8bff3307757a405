"""Fold-parallel training, port of ``image_classification_tpu/train/
foldpar.py``: every fold of the split at once, one rank group each.

JAX stacks the K folds' train states along a leading axis sharded over a
``fold`` mesh axis and ``vmap``s the steps. The port maps the fold axis to
rank groups (``parallel/mesh.py``): rank ``r`` trains fold ``r // (data *
model) + 1`` through :func:`train_fold`, data-parallel inside its group,
with the hooks of :class:`FoldParallelRun`. Each fold keeps the sequential
path's per-fold init, step draws, loader order, exact class weights,
plateau LR, progressive resizing and SWA; JAX's stacked loop differs from
the sequential one in three ways, and so does this one:

- every fold runs ``min`` over the folds' train loaders steps an epoch, and
  the LR schedule is sized on that count;
- the stop is joint: a fold past its patience keeps training until every
  fold is past it, decided by an all-reduce over the fold axis;
- SWA's BatchNorm refresh runs that many batches of epoch 0's order.

Files: each fold's primary rank writes its fold's best checkpoints; rank 0
writes ``metrics.jsonl`` for every fold (the records gathered over the fold
axis each epoch, in fold order). The resume state is one directory,
``train_state_foldpar/``: each fold's state, written by its primary, and
the sidecar ``host_state.json`` with every fold's bookkeeping at the same
epoch, written by rank 0 once the folds' gather shows their states are
down. A failing fold fails the run, as in JAX. Rank 0's result holds every
fold (the other folds' best weights read from their checkpoints, for the
submission); another rank's holds its own fold.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from image_classification_tpu_torch.models.factory import create_model
from image_classification_tpu_torch.parallel.distributed import (
    all_gather_json,
    barrier,
    is_primary,
)
from image_classification_tpu_torch.parallel.mesh import FOLD_AXIS
from image_classification_tpu_torch.train.loop import (
    FoldResult,
    FoldRun,
    _append_metrics,
    train_fold,
)
from image_classification_tpu_torch.utils import checkpoint as ckpt

logger = logging.getLogger("ic_tpu_torch")

FOLDPAR_DIR = "train_state_foldpar"
SIDECAR = "host_state.json"


class FoldParallelRun(FoldRun):
    """:class:`FoldRun` for one fold among ``n_folds`` trained side by side
    over ``mesh``'s fold axis. The fold primaries (data and model index 0)
    form one group of the fold axis, the one that holds rank 0: they gather
    the records and the bookkeeping there."""

    def __init__(self, mesh, n_folds: int, steps_per_epoch: int,
                 device: torch.device):
        self.mesh = mesh
        self.group = mesh.group(FOLD_AXIS)
        self.steps_per_epoch = steps_per_epoch
        self.device = device
        self.histories: list[list[dict]] = [[] for _ in range(n_folds)]

    def joint_stop(self, stopping: bool) -> bool:
        going = torch.tensor([0.0 if stopping else 1.0], device=self.device)
        dist.all_reduce(going, group=self.group)
        return float(going) == 0.0

    def append_metrics(self, cfg, fold: int, record: dict, primary: bool) -> None:
        if not primary:
            return
        records = all_gather_json(record, self.group, self.device)
        for k, r in enumerate(records):
            self.histories[k].append(r)
            if is_primary():
                _append_metrics(cfg.output_dir, k + 1, r)
                if k + 1 != fold:
                    logger.info("fold %d epoch %d/%d: train %.4f/%.4f val %.4f/%.4f "
                                "f1 %.4f", k + 1, r["epoch"] + 1, cfg.epochs,
                                r["train_loss"], r["train_acc"], r["val_loss"],
                                r["val_acc"], r["val_macro_f1"])

    def save_state(self, writer, cfg, fold: int, state, epoch: int,
                   host_state: dict, primary: bool) -> None:
        tree = ckpt.state_tree(state)   # every rank: a collective under TP
        if not primary:
            return
        out = os.path.join(cfg.output_dir, FOLDPAR_DIR)
        ckpt.save_train_state(out, fold, tree, epoch, cfg, host_state=host_state)
        # every fold's state is down once every primary has sent its part
        folds = all_gather_json(host_state, self.group, self.device)
        if is_primary():
            def write(tmp: str) -> None:
                with open(tmp, "w") as f:
                    json.dump({"epoch": epoch, "folds": folds}, f, indent=2)
            ckpt._replace(os.path.join(out, SIDECAR), write)

    def load_state(self, cfg, fold: int, state):
        out = os.path.join(cfg.output_dir, FOLDPAR_DIR)
        sidecar = os.path.join(out, SIDECAR)
        if not os.path.exists(sidecar):
            return None
        with open(sidecar) as f:
            side = json.load(f)
        restored = ckpt.load_train_state(out, fold, state)
        if restored is None or restored[1] != side["epoch"] + 1:
            raise ValueError(f"{out}: fold {fold}'s state is not at the sidecar's "
                             f"epoch {side['epoch']}")
        return restored[0], restored[1], side["folds"][fold - 1]


def train_k_fold_parallel(cfg, splits, source, manifest, mesh,
                          device: str | torch.device = "cuda",
                          model_name: str | None = None,
                          resume: bool = False) -> list[FoldResult]:
    """Train every fold of ``splits`` at once over ``mesh``'s fold axis,
    whose size must be the number of folds."""
    from image_classification_tpu_torch.train.kfold import make_fold_loaders

    n_folds = len(splits)
    if mesh is None or mesh.size(FOLD_AXIS) != n_folds:
        have = 1 if mesh is None else mesh.size(FOLD_AXIS)
        raise ValueError(f"mesh fold axis ({have}) != number of folds ({n_folds})")
    device = torch.device(device)
    loaders = [make_fold_loaders(cfg, source, manifest, tr, va, device=device, mesh=mesh)
               for tr, va in splits]
    steps_per_epoch = min(len(t) for t, _, _ in loaders)
    k = mesh.index(FOLD_AXIS)
    fold = k + 1
    train_loader, val_loader, train_labels = loaders[k]
    logger.info("fold-parallel: fold %d/%d on rank %d (%d steps an epoch, the "
                "folds' least)", fold, n_folds, mesh.rank, steps_per_epoch)
    run = FoldParallelRun(mesh, n_folds, steps_per_epoch, device)
    result = train_fold(cfg, train_loader, val_loader, fold=fold,
                        class_counts=np.bincount(train_labels, minlength=cfg.num_classes),
                        resume=resume, model_name=model_name, mesh=mesh, run=run)
    barrier()   # every fold's best checkpoints are down
    if not is_primary():
        return [result]
    results = []
    for j in range(1, n_folds + 1):
        if j == fold:
            results.append(result)
            continue
        weights, meta = ckpt.load_best(cfg.model_save_path, j)
        bundle = create_model(cfg, model_name)
        bundle.module.to(device)
        results.append(FoldResult(fold=j, best_val_acc=float(meta["val_acc"]),
                                  best_variables=weights, bundle=bundle,
                                  history=run.histories[j - 1]))
    return results
