"""Multi-process start-up and the few collectives the loops use, port of
``image_classification_tpu/parallel/distributed.py``.

JAX runs one process per host and reads ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID`` and ``COORDINATOR_ADDRESS``; the port runs one process
per GPU and reads torchrun's contract (``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``):

    torchrun --nproc_per_node=N -m image_classification_tpu_torch.cli train ...

:func:`initialize` is a no-op for one process, and when the caller has
initialised the process group already (two ranks on one card must use
gloo: NCCL refuses two ranks on one device). The loops use only
``all_reduce``, ``all_gather``, ``broadcast`` and ``barrier``, which gloo
supports on CUDA tensors too.
"""

from __future__ import annotations

import datetime
import json
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("ic_tpu_torch")


def initialize(device: str | torch.device | None = None,
               timeout: datetime.timedelta | None = None) -> None:
    """Join the process group that torchrun's variables describe: NCCL for a
    CUDA device (``cuda:LOCAL_RANK``), gloo for the CPU, with the
    collectives' ``timeout`` (torch's default where None); the rank keeps at
    most its share of the host's cores for torch's threads
    (:func:`rank_threads`). A no-op when ``WORLD_SIZE`` is unset or 1, or
    when the group exists already."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return
    device = torch.device(device if device is not None else "cuda")
    kw = {} if timeout is None else {"timeout": timeout}
    if device.type == "cuda":
        local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=local, **kw)
    else:
        dist.init_process_group("gloo", **kw)
    torch.set_num_threads(min(torch.get_num_threads(), rank_threads()))
    logger.info("torch.distributed initialized: rank %d/%d (%s), %d torch threads",
                dist.get_rank(), dist.get_world_size(), dist.get_backend(),
                torch.get_num_threads())


def host_share(budget: int) -> int:
    """This process' share of a host-wide thread ``budget``: JAX runs one
    process a host and sizes its pools for the host, the port one process a
    GPU, so each of a host's ranks (torchrun's ``LOCAL_WORLD_SIZE``, else 1)
    takes ``budget // LOCAL_WORLD_SIZE`` (at least 1) and together they keep
    to the budget."""
    return max(1, budget // max(1, int(os.environ.get("LOCAL_WORLD_SIZE", "1"))))


def rank_threads() -> int:
    """The most intra-op threads a rank takes: its share of the cores this
    process may run on. torch's default is every core a process, four times
    the host's cores at four ranks. It is a cap, not a target: torchrun's
    ``OMP_NUM_THREADS=1`` stays, since four V4 ranks on four H100s trained
    fewer images a second at 8 threads a rank than at 1 (``PERF.md``, the
    four-card runs): the loop's host work is Python's dispatch, and the
    pool's threads only compete with it."""
    return host_share(len(os.sched_getaffinity(0)))


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_device(device: str | torch.device) -> torch.device:
    """``device``, or for a bare ``cuda`` under torchrun ``cuda:LOCAL_RANK``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def num_hosts() -> int:
    """The number of processes (JAX's ``process_count``)."""
    return dist.get_world_size() if initialized() else 1


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def is_primary() -> bool:
    """Rank 0, or the only process: the one that writes the run's shared
    files (``train.log``, the submission)."""
    return process_index() == 0


def barrier() -> None:
    if initialized():
        dist.barrier()


def host_shard_indices(n: int, rank: int | None = None,
                       world: int | None = None) -> np.ndarray:
    """The slice of dataset indices this process is responsible for."""
    k = process_index() if rank is None else rank
    h = num_hosts() if world is None else world
    per = -(-n // h)
    return np.arange(k * per, min((k + 1) * per, n))


def primary_first(fn):
    """``fn()`` on rank 0, then, after a barrier, on every other rank: a
    cache that rank 0 writes is complete before the others read it."""
    if not initialized():
        return fn()
    if is_primary():
        out = fn()
        dist.barrier()
        return out
    dist.barrier()
    return fn()


def all_reduce_sum_(tensors: list[torch.Tensor], group) -> None:
    """Sum each tensor over ``group`` in place, through one flat buffer per
    dtype. A no-op where ``group`` is None (an axis of size 1)."""
    if group is None or not tensors:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        torch._foreach_copy_(same, [v.view_as(t) for v, t in
                                    zip(flat.split([t.numel() for t in same]), same)])


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of every rank of ``group``, concatenated along dim 0 in rank
    order (no autograd); ``x`` itself where ``group`` is None."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def all_gather_json(obj, group, device: str | torch.device = "cpu") -> list:
    """``obj`` (JSON-serialisable) of every rank of ``group``, in rank
    order, through two ``all_gather``s of byte tensors on ``device`` (a
    CUDA device for NCCL); ``[obj]`` where ``group`` is None. JSON gives
    floats back exactly."""
    if group is None:
        return [obj]
    data = torch.tensor(list(json.dumps(obj).encode()), dtype=torch.uint8, device=device)
    n = dist.get_world_size(group)
    sizes = [torch.zeros(1, dtype=torch.int64, device=device) for _ in range(n)]
    dist.all_gather(sizes, torch.tensor([data.numel()], device=device), group=group)
    width = max(int(s) for s in sizes)
    parts = [torch.empty(width, dtype=torch.uint8, device=device) for _ in range(n)]
    dist.all_gather(parts, torch.cat([data, data.new_zeros(width - data.numel())]),
                    group=group)
    return [json.loads(bytes(p[:int(s)].tolist()).decode()) for p, s in zip(parts, sizes)]
