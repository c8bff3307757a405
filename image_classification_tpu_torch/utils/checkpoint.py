"""Checkpoints, port of ``image_classification_tpu/utils/checkpoint.py``
(orbax becomes ``torch.save``).

Two tiers, as in the JAX package:

- ``save_best`` / ``load_best``: the best weights of a fold, as a plain
  state dict of the model (the keys ``model.state_dict()`` has, timm's for
  the backbone, BatchNorm's running statistics included) in
  ``best_model_fold{k}.pt``, or ``best_loss_model_fold{k}.pt`` for the
  lowest-val-loss tier; ``cli predict`` loads them with
  ``strict=True, weights_only=True``. Their metadata
  ``{val_acc, val_loss, fold, metric}`` sits beside each, in
  ``best_model_fold{k}.json``.
- ``save_train_state`` / ``load_train_state``: the whole train state
  (parameters, EMA, Adam's ``mu`` and ``nu`` and SWA's average keyed by
  parameter name, the module's buffers, the Adam count, the step and the
  SWA count) with the epoch, the config and the trainer's host
  bookkeeping, in ``train_state_fold{k}.pt``, for an exact resume.

Under tensor parallelism (``parallel/shardings.py``) both hold whole
tensors: :func:`state_tree` gathers the split ones over the model group
(each of its ranks calls it), and :func:`load_train_state` takes this
rank's shard of each.

Every file is written to a temporary sibling and swapped into place; the
previous file survives as ``<path>.prev`` until the new one is complete, and
``load_train_state`` falls back to it after a crash in between.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any

import torch

from image_classification_tpu_torch.parallel.shardings import gather_tree, shard_tree


class AsyncCheckpointWriter:
    """Runs checkpoint jobs on a background thread, one at a time.

    ``submit`` joins any pending job first, so at most one save is in flight
    and writes land in submission order. An exception from a job re-raises
    on the next ``join``/``submit``. The jobs take snapshots (device-side
    copies, :func:`snapshot`): the train step updates the state in place
    while the job copies to the host and writes.
    """

    def __init__(self) -> None:
        self._thread: threading.Thread | None = None
        self._err: BaseException | None = None

    def submit(self, fn, *args, **kwargs) -> None:
        self.join()

        def run() -> None:
            try:
                fn(*args, **kwargs)
            except BaseException as e:  # surfaced on join
                self._err = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err


def snapshot(tree: Any) -> Any:
    """A copy of every tensor in a tree of dicts, on its own device (other
    leaves pass through)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: snapshot(v) for k, v in tree.items()}
    return tree


def to_host(tree: Any) -> Any:
    """Every tensor of a tree of dicts on the CPU, contiguous."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().contiguous()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree


def _replace(path: str, write) -> None:
    """Crash-safe write: ``write(tmp)``, then swap ``tmp`` into ``path``,
    keeping the old file at ``path.prev`` until the swap is done."""
    tmp, prev = path + ".tmp", path + ".prev"
    for stale in (tmp, prev):
        if os.path.exists(stale):
            os.remove(stale)
    write(tmp)
    if os.path.exists(path):
        os.replace(path, prev)
    os.replace(tmp, path)
    if os.path.exists(prev):
        os.remove(prev)


def save_file(path: str, obj: Any, metadata: dict | None = None) -> None:
    """``obj`` (tensors moved to the host) to ``path`` with ``torch.save``;
    ``metadata`` as JSON beside it (:func:`metadata_path`)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    host = to_host(obj)
    _replace(path, lambda tmp: torch.save(host, tmp))
    if metadata is not None:
        def write_json(tmp: str) -> None:
            with open(tmp, "w") as f:
                json.dump(metadata, f, indent=2, default=str)
        _replace(metadata_path(path), write_json)


def metadata_path(path: str) -> str:
    return os.path.splitext(path)[0] + ".json"


def load_metadata(path: str) -> dict:
    meta = metadata_path(os.path.abspath(path))
    if not os.path.exists(meta):
        return {}
    with open(meta) as f:
        return json.load(f)


# --------------------------------------------------------------- best model

def best_path(save_dir: str, fold: int, metric: str = "acc") -> str:
    """``metric='acc'``: the best-val-acc tier (``best_model_fold{k}.pt``);
    ``'loss'``: the lowest-val-loss tier (``best_loss_model_fold{k}.pt``)."""
    prefix = "best_model" if metric == "acc" else "best_loss_model"
    return os.path.join(save_dir, f"{prefix}_fold{fold}.pt")


def save_best(save_dir: str, fold: int, weights: dict[str, torch.Tensor],
              val_acc: float, val_loss: float | None = None,
              metric: str = "acc") -> str:
    """The fold's best weights (a state dict) and their metadata."""
    path = best_path(save_dir, fold, metric)
    meta = {"val_acc": float(val_acc), "fold": fold, "metric": metric}
    if val_loss is not None:
        meta["val_loss"] = float(val_loss)
    save_file(path, weights, meta)
    return path


def load_best(save_dir: str, fold: int,
              metric: str = "acc") -> tuple[dict[str, torch.Tensor], dict]:
    path = best_path(save_dir, fold, metric)
    return torch.load(path, map_location="cpu", weights_only=True), load_metadata(path)


def select_best_fold(save_dir: str, folds: list[int],
                     metric: str = "acc") -> tuple[int, float]:
    """The fold whose stored metric is best: highest val_acc with
    ``metric='acc'``, lowest val_loss (of the loss tier) with ``'loss'``."""
    sign = 1.0 if metric == "acc" else -1.0
    key = "val_acc" if metric == "acc" else "val_loss"
    best_fold, best_score = None, -float("inf")
    for fold in folds:
        meta = load_metadata(best_path(save_dir, fold, metric))
        if key not in meta:
            continue
        score = sign * float(meta[key])
        if score > best_score:
            best_fold, best_score = fold, score
    if best_fold is None:
        raise FileNotFoundError(
            f"no fold checkpoint under {save_dir!r} carries {key!r} "
            f"(folds {folds}, tier {metric!r}) — was the run saved with "
            f"save_best_loss enabled?" if metric == "loss" else
            f"no fold checkpoint under {save_dir!r} carries {key!r} "
            f"(folds {folds})"
        )
    return best_fold, sign * best_score


# --------------------------------------------------------------- full state

def resume_path(output_dir: str, fold: int) -> str:
    return os.path.join(output_dir, f"train_state_fold{fold}.pt")


def state_tree(state) -> dict:
    """A ``TrainState``'s tensors keyed by parameter (or buffer) name, and
    its counters; whole tensors under tensor parallelism (a collective of
    the model group)."""
    names = state.names()
    return gather_tree({
        "model": dict(zip(names, state.params())),
        "buffers": state.buffers(),
        "ema": None if state.ema is None else dict(zip(names, state.ema)),
        "swa": None if state.swa is None else dict(zip(names, state.swa)),
        "mu": dict(zip(names, state.mu)),
        "nu": dict(zip(names, state.nu)),
        "count": int(state.count),
        "step": int(state.step),
        "swa_count": int(state.swa_count),
    }, state.model)


def save_train_state(output_dir: str, fold: int, state: Any, epoch: int,
                     cfg: Any, host_state: dict | None = None) -> str:
    """The whole train state after ``epoch``; ``state`` is a ``TrainState``
    or its :func:`state_tree` (a :func:`snapshot` of one, for a background
    write). ``host_state`` carries the trainer's bookkeeping (best val acc
    and loss, patience, the plateau scheduler) so a resumed fold continues
    exactly."""
    tree = state if isinstance(state, dict) else state_tree(state)
    path = resume_path(output_dir, fold)
    save_file(path, {**tree, "epoch": int(epoch), "fold": int(fold),
                     "config": cfg.to_dict(), "host_state": host_state or {}})
    return path


def load_train_state(output_dir: str, fold: int, state) -> tuple[Any, int, dict] | None:
    """Restores the checkpoint into ``state`` (a ``TrainState`` of the same
    model) in place; returns (state, next_epoch, host_state), or None when
    there is no checkpoint. Falls back to the ``.prev`` sibling if a crash
    interrupted the last save after the old file was moved aside."""
    path = resume_path(output_dir, fold)
    if not os.path.exists(path) and os.path.exists(path + ".prev"):
        os.replace(path + ".prev", path)
    if not os.path.exists(path):
        return None
    tree = shard_tree(torch.load(path, map_location="cpu", weights_only=True), state.model)
    names = state.names()
    buffers = state.buffers()
    # files written before buffers and SWA were carried have neither
    tree.setdefault("buffers", {})
    tree.setdefault("swa", None)
    if (set(tree["model"]) != set(names) or set(tree["buffers"]) != set(buffers)
            or (tree["ema"] is None) != (state.ema is None)
            or (tree["swa"] is None) != (state.swa is None)):
        raise ValueError(f"{path} does not match the model's parameters")
    with torch.no_grad():
        for name, p, m, v in zip(names, state.params(), state.mu, state.nu):
            p.copy_(tree["model"][name])
            m.copy_(tree["mu"][name])
            v.copy_(tree["nu"][name])
        for name, b in buffers.items():
            b.copy_(tree["buffers"][name])
        for part, values in (("ema", state.ema), ("swa", state.swa)):
            for name, t in zip(names, values or []):
                t.copy_(tree[part][name])
    state.count = int(tree["count"])
    state.step = int(tree["step"])
    state.swa_count = int(tree.get("swa_count", 0))
    return state, int(tree["epoch"]) + 1, tree.get("host_state") or {}
