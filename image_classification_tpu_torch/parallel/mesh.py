"""The process mesh, port of ``image_classification_tpu/parallel/mesh.py``.

JAX lays devices out on a ``(fold, data, model)`` mesh and runs one SPMD
program over it; XLA inserts the collectives. The port runs one process per
GPU (``torchrun``) and lays the ranks out on the same axes, row-major as
JAX's ``reshape(fold, data, model)``: rank ``r`` sits at ``fold = r //
(data * model)``, ``data = r // model % data``, ``model = r % model``. Each
axis gets its process groups: the ranks that differ only in that axis'
coordinate. The step code reduces over them explicitly
(``train/step.py``): the batch is split over ``data``, the folds over
``fold``, and the MLP weights over ``model`` (``parallel/shardings.py``).

One process is the mesh (1, 1, 1), with no groups: every collective is then
skipped, and the single-GPU path is the one it was.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
FOLD_AXIS = "fold"
AXES = (FOLD_AXIS, DATA_AXIS, MODEL_AXIS)


@dataclass(frozen=True)
class MeshSpec:
    """How to lay ranks out. ``data=-1`` means "all ranks not used by other
    axes". ``fold > 1`` adds a leading fold-parallel axis (train K folds at
    once, one rank group each: ``train/foldpar.py``)."""

    data: int = -1
    model: int = 1
    fold: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int]:
        model = max(1, self.model)
        fold = max(1, self.fold)
        data = self.data
        if data == -1:
            if n_devices % (model * fold) != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by "
                    f"model={model} x fold={fold}"
                )
            data = n_devices // (model * fold)
        if fold * data * model != n_devices:
            raise ValueError(
                f"mesh {fold}x{data}x{model} != device count {n_devices}"
            )
        return fold, data, model


def rank_coords(rank: int, shape: tuple[int, int, int]) -> tuple[int, int, int]:
    """``rank``'s (fold, data, model) coordinates on a mesh of ``shape``."""
    _, data, model = shape
    return rank // (data * model), rank // model % data, rank % model


def coords_rank(coords: tuple[int, int, int], shape: tuple[int, int, int]) -> int:
    f, d, m = coords
    return (f * shape[1] + d) * shape[2] + m


def axis_ranks(shape: tuple[int, int, int], axis: str) -> list[list[int]]:
    """Every group of ``axis``: the ranks that differ only in its
    coordinate, each in coordinate order; the groups in rank order of their
    first member."""
    a = AXES.index(axis)
    groups = []
    for rank in range(shape[0] * shape[1] * shape[2]):
        c = rank_coords(rank, shape)
        if c[a] != 0:
            continue
        groups.append([coords_rank(tuple(j if i == a else c[i] for i in range(3)), shape)
                       for j in range(shape[a])])
    return groups


@dataclass
class Mesh:
    """This rank's place on the mesh: the axis sizes ``shape`` (fold, data,
    model), its coordinates, and per axis its process group (None where the
    axis has size 1: nothing to reduce)."""

    shape: tuple[int, int, int]
    rank: int = 0
    groups: dict[str, Any] = field(default_factory=dict)

    @property
    def coords(self) -> tuple[int, int, int]:
        return rank_coords(self.rank, self.shape)

    def size(self, axis: str) -> int:
        return self.shape[AXES.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[AXES.index(axis)]

    def group(self, axis: str):
        return self.groups.get(axis)

    @property
    def is_primary(self) -> bool:
        """The rank that writes its fold's files: data and model index 0."""
        return self.index(DATA_AXIS) == 0 and self.index(MODEL_AXIS) == 0


def build_mesh(spec: MeshSpec | None = None, world: int | None = None,
               rank: int | None = None) -> Mesh:
    """The mesh over the process group's ranks (one rank when
    ``torch.distributed`` is not initialised). Every rank creates every
    group of every axis of size > 1, in the same order, as
    ``dist.new_group`` requires; each keeps its own."""
    spec = spec or MeshSpec()
    live = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if live else 1
    if rank is None:
        rank = dist.get_rank() if live else 0
    shape = spec.resolve(world)
    mesh = Mesh(shape, rank)
    for axis in AXES:
        if mesh.size(axis) == 1:
            continue
        for ranks in axis_ranks(shape, axis):
            group = dist.new_group(ranks)
            if rank in ranks:
                mesh.groups[axis] = group
    return mesh


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def check_batch_divisible(batch_size: int, mesh: Mesh) -> None:
    n_data = mesh.size(DATA_AXIS)
    if batch_size % n_data != 0:
        raise ValueError(
            f"global batch {batch_size} not divisible by data-parallel "
            f"size {n_data}"
        )
