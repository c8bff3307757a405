"""Tensor parallelism over the mesh's ``model`` axis, port of
``image_classification_tpu/parallel/shardings.py``.

JAX shards only the MLP pairs, Megatron-style: ``mlp_fc1`` column-parallel
(its kernel's output dim and its bias) and ``mlp_fc2`` row-parallel (its
kernel's input dim), wherever the dim divides by the model axis' size;
everything else is replicated, and GSPMD inserts one all-reduce per pair.
In timm's names those are ``mlp.fc1`` and ``mlp.fc2`` of every ConvNeXt and
ViT block. The port holds the same shards: rank ``m`` of the model group
keeps rows ``[m*n, (m+1)*n)`` of ``fc1``'s weight and bias and columns
``[m*n, (m+1)*n)`` of ``fc2``'s weight, and the MLP's forward
(``models/layers.py:copy_to_model``, ``dense_row_parallel``) is the identity
at ``fc1``'s input with an all-reduced gradient, and an all-reduce after
``fc2``'s product, whose bias is added once, after it.

The train state is co-sharded as JAX's ``state_shardings`` makes it: Adam's
moments, the EMA and SWA's average hold the same shards as their
parameters. Checkpoints hold whole tensors (:func:`gather_tree`), so a file
is the one a ``mesh_model=1`` run writes, and a resume takes its shard of
each (:func:`shard_tree`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from image_classification_tpu_torch.parallel.mesh import MODEL_AXIS

_COL_PARALLEL = ("mlp.fc1",)   # shard the output dim: torch's weight dim 0, the bias
_ROW_PARALLEL = ("mlp.fc2",)   # shard the input dim: torch's weight dim 1


def param_spec(name: str, shape: tuple[int, ...], model_size: int) -> int | None:
    """The dim of parameter ``name`` (a torch state-dict key) of ``shape``
    that is split over ``model_size`` ranks, or None (replicated)."""
    if model_size <= 1 or "." not in name:
        return None
    parent, leaf = name.rsplit(".", 1)
    col = parent.endswith(_COL_PARALLEL)
    row = parent.endswith(_ROW_PARALLEL)
    if leaf == "weight" and len(shape) == 2:
        if col and shape[0] % model_size == 0:
            return 0
        if row and shape[1] % model_size == 0:
            return 1
    if leaf == "bias" and len(shape) == 1 and col and shape[0] % model_size == 0:
        return 0
    return None


class TensorParallel:
    """A model's split over a model group: ``specs`` maps each split
    parameter to its dim; this rank holds part ``index`` of ``count``."""

    def __init__(self, specs: dict[str, int], group, index: int, count: int):
        self.specs, self.group, self.index, self.count = specs, group, index, count

    def shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        dim = self.specs.get(name)
        if dim is None:
            return t
        n = t.shape[dim] // self.count
        return t.narrow(dim, self.index * n, n).clone()

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        dim = self.specs.get(name)
        if dim is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.count)]
        dist.all_gather(parts, t.detach().contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)


def tensor_parallel(model: nn.Module) -> TensorParallel | None:
    return getattr(model, "tensor_parallel", None)


def shard_model(model: nn.Module, mesh) -> TensorParallel | None:
    """Split ``model``'s MLP pairs over ``mesh``'s model axis in place (each
    parameter replaced by this rank's shard) and route their forwards
    through the model group; None, and nothing changed, for a model axis of
    size 1 or a model without such pairs."""
    count = 1 if mesh is None else mesh.size(MODEL_AXIS)
    if count == 1:
        return None
    specs = {n: d for n, p in model.named_parameters()
             if (d := param_spec(n, tuple(p.shape), count)) is not None}
    if not specs:   # nothing to split (an EfficientNet): every rank replicates
        return None
    tp = TensorParallel(specs, mesh.group(MODEL_AXIS), mesh.index(MODEL_AXIS), count)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in specs:
                p.data = tp.shard(name, p.data)
    for name, mod in model.named_modules():
        if f"{name}.fc1.weight" in specs and f"{name}.fc2.weight" in specs:
            mod.group = tp.group
    model.tensor_parallel = tp
    return tp


def unshard_model(model: nn.Module) -> nn.Module:
    """Undo :func:`shard_model`'s shapes and routing: every split parameter
    back at its whole shape (its values undefined: load a whole state dict
    into it), no collective in the forward."""
    tp = tensor_parallel(model)
    if tp is None:
        return model
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in tp.specs:
                shape = list(p.shape)
                shape[tp.specs[name]] *= tp.count
                p.data = p.data.new_empty(shape)
    for mod in model.modules():
        if getattr(mod, "group", None) is tp.group:
            mod.group = None
    del model.tensor_parallel
    return model


def shard_train_state(state, mesh):
    """:func:`shard_model` on ``state``'s model, with Adam's moments, the EMA
    and SWA's average split as their parameters are."""
    tp = shard_model(state.model, mesh)
    if tp is None:
        return state
    names = state.names()
    for part in ("mu", "nu", "ema", "swa"):
        values = getattr(state, part)
        if values is not None:
            setattr(state, part, [tp.shard(n, v) for n, v in zip(names, values)])
    return state


def gather_tree(tree, model: nn.Module):
    """``tree`` (dicts of tensors keyed by parameter name) with every split
    tensor whole; a collective of the model group, which each of its ranks
    must call. ``tree`` itself without tensor parallelism."""
    tp = tensor_parallel(model)
    if tp is None:
        return tree
    return _map(tree, tp.gather)


def shard_tree(tree, model: nn.Module):
    """Each whole tensor of ``tree`` cut to this rank's shard."""
    tp = tensor_parallel(model)
    if tp is None:
        return tree
    return _map(tree, tp.shard)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: fn(k, v) if isinstance(v, torch.Tensor) else _map(v, fn)
                for k, v in tree.items()}
    return tree


def sharded_mask(model: nn.Module, names: list[str]) -> list[bool] | None:
    """Which of ``names`` are split (for the clip norm), or None."""
    tp = tensor_parallel(model)
    return None if tp is None else [n in tp.specs for n in names]
