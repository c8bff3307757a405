"""Runs a function on W ranks of CPU processes joined by gloo, for the
port's multi-process tests. The workers import torch and the port only,
never JAX: the JAX side of a comparison runs in the test's own process.

``run_ranks(fn, world, tmp, *args)`` starts ``world`` processes (one torch
thread each), each calling ``fn(rank, world, *args)`` inside a process group
whose rendezvous is a file under ``tmp`` (several test workers run at once,
so no TCP port), with a timeout so that a rank that never reaches a
collective fails the test instead of hanging it. A rank that raises fails
the test with its traceback. The functions below are the tests' workers;
each writes what it computed to ``{out}/rank{r}.pt``.
"""

from __future__ import annotations

import copy
import datetime
import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = int(os.environ.get("TEST_RDZV_TIMEOUT_S", "180"))


def _entry(rank: int, fn, world: int, rdzv: str, args: tuple) -> None:
    # torch.multiprocessing hands tensors over in shared memory: each rank
    # takes its own copy before it updates any in place
    args = copy.deepcopy(args)
    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp: str, *args) -> None:
    """``world`` = 1 runs ``fn`` here, on a copy of ``args``, with no
    process group: the single-process path."""
    os.makedirs(tmp, exist_ok=True)
    if world == 1:
        fn(0, 1, *copy.deepcopy(args))
        return
    rdzv = os.path.join(tmp, f"rdzv_{fn.__name__}_{world}")
    mp.spawn(_entry, args=(fn, world, rdzv, args), nprocs=world, join=True)


def load_ranks(out: str, world: int) -> list[dict]:
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ----------------------------------------------------------------- workers
def steps_worker(rank: int, world: int, out: str, bundle, state, cfg,
                 steps_per_epoch: int, class_counts, batches, draws, eval_batches,
                 bn_batches, spec: tuple = (-1, 1)) -> None:
    """Train steps on this rank's rows of each global batch with the global
    draws, then the eval step and the BN update step on its rows, on the
    mesh ``MeshSpec(*spec)`` (data, model: the model's MLPs split over the
    model axis); saves the metrics, the eval sums and the whole train state
    (split tensors gathered)."""
    from image_classification_tpu_torch.parallel.mesh import DATA_AXIS, MeshSpec, build_mesh
    from image_classification_tpu_torch.parallel.shardings import shard_train_state
    from image_classification_tpu_torch.train.loop import build_lr_schedule
    from image_classification_tpu_torch.train.loss import build_criterion
    from image_classification_tpu_torch.train.optim import build_optimizer
    from image_classification_tpu_torch.train.step import (
        make_bn_update_step,
        make_eval_step,
        make_train_step,
    )
    from image_classification_tpu_torch.utils import checkpoint as ckpt

    mesh = build_mesh(MeshSpec(*spec))
    index, count = mesh.index(DATA_AXIS), mesh.size(DATA_AXIS)
    state = shard_train_state(state, mesh)

    def rows(batch: dict) -> dict:
        per = batch["label"].shape[0] // count
        return {k: v[index * per:(index + 1) * per] for k, v in batch.items()}

    tx = build_optimizer(cfg, build_lr_schedule(cfg, steps_per_epoch))
    criterion = build_criterion(cfg, class_counts=class_counts,
                                group=mesh.group(DATA_AXIS))
    step = make_train_step(bundle, cfg, tx, criterion, mesh=mesh)
    metrics = []
    for batch, d in zip(batches, draws):
        state, m = step(state, rows(batch), draws=d)
        metrics.append({k: float(v) for k, v in m.items()})
    eval_step = make_eval_step(bundle, cfg, mesh=mesh)
    evals = [{k: v.clone() for k, v in eval_step(state, rows(b)).items()}
             for b in eval_batches]
    bn_step = make_bn_update_step(bundle, cfg, mesh=mesh)
    for b in bn_batches:
        bn_step(state.eval_params(use_ema=False), rows(b))
    torch.save({"metrics": metrics, "eval": evals,
                "state": ckpt.to_host(ckpt.state_tree(state))},
               os.path.join(out, f"rank{rank}.pt"))


class KernelCalls:
    """Counts the calls of each kernel wrapper's entry on the CPU, where the
    wrappers run their plain versions and count no launches: the points
    where, on the card, each kernel launches (the depthwise backward's dx
    is the forward's entry on g, as on the card). ``patch`` is pytest's
    ``monkeypatch``, or :class:`Patch` in a rank's process."""

    ENTRIES = {"dwconv": ("dwconv", "_dwconv_forward"),
               "dwconv_bwd": ("dwconv", "depthwise_conv7x7_bwd"),
               "dwconv_wgrad": ("dwconv", "depthwise_conv7x7_wgrad"),
               "block_mlp": ("block_mlp", "block_mlp_fwd"),
               "block_mlp_bwd": ("block_mlp", "block_mlp_bwd"),
               "gelu": ("gelu", "_gelu_forward"),
               "gelu_bwd": ("gelu", "gelu_bwd")}

    def __init__(self, patch):
        import importlib

        self.counts = dict.fromkeys(self.ENTRIES, 0)
        for name, (module, attr) in self.ENTRIES.items():
            mod = importlib.import_module(f"image_classification_tpu_torch.ops.{module}")
            real = getattr(mod, attr)

            def counted(*args, _real=real, _name=name, **kwargs):
                self.counts[_name] += 1
                return _real(*args, **kwargs)

            patch.setattr(mod, attr, counted)


class Patch:
    """``monkeypatch.setattr`` for a rank's process, which ends with its
    worker: nothing is undone."""

    @staticmethod
    def setattr(obj, name: str, value) -> None:
        setattr(obj, name, value)


class ModelSums(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the model group's sums that run (``models/layers.py:
    model_sum``'s ``_c10d_functional.all_reduce``); one that a
    selective-checkpoint policy kept and hands back from its cache in a
    recompute does not reach this mode, so it is not counted."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops._c10d_functional.all_reduce.default:
            self.count += 1
        return func(*args, **(kwargs or {}))


def remat_worker(rank: int, world: int, out: str, modes: tuple, bundle, *args) -> None:
    """:func:`steps_worker` once for each ``block_remat`` mode in ``modes``,
    each on a fresh copy of ``bundle`` and the rest of its arguments (the
    model's every ConvNeXt block set to the mode), saved under
    ``{out}/{mode}``, with the kernel entries it called and the model
    group's sums it ran, saved to ``{out}/{mode}/calls{r}.pt``."""
    from image_classification_tpu_torch.models.convnext import ConvNeXtBlock

    calls = KernelCalls(Patch())
    for mode in modes:
        b, rest = copy.deepcopy((bundle, args))
        for m in b.module.modules():
            if isinstance(m, ConvNeXtBlock):
                m.block_remat = mode
        calls.counts = dict.fromkeys(calls.ENTRIES, 0)
        sums = ModelSums()
        os.makedirs(os.path.join(out, mode), exist_ok=True)
        with sums:
            steps_worker(rank, world, os.path.join(out, mode), b, *rest)
        torch.save({"calls": calls.counts, "model_sums": sums.count},
                   os.path.join(out, mode, f"calls{rank}.pt"))


def cli_worker(rank: int, world: int, *argvs: list[str]) -> None:
    """``cli.main(argv)`` for each of ``argvs`` in turn on this rank (the
    process group is live, so ``initialize`` keeps it)."""
    from image_classification_tpu_torch import cli

    for argv in argvs:
        cli.main(argv)


def kfold_worker(rank: int, world: int, out: str, cfg) -> None:
    """``train_k_fold`` over the mesh of ``cfg``'s fold-parallel run; saves
    each result's fold, history length and best-weight names."""
    from image_classification_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from image_classification_tpu_torch.train import kfold

    mesh = build_mesh(MeshSpec(cfg.mesh_data, cfg.mesh_model, fold=cfg.num_folds))
    results = kfold.train_k_fold(cfg, device="cpu", mesh=mesh)
    torch.save([(r.fold, len(r.history), sorted(r.best_variables)) for r in results],
               os.path.join(out, f"rank{rank}.pt"))
