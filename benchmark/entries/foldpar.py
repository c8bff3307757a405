"""The fold-parallel cell's entry: one process a card, each training one
fold as ``train/foldpar.py``'s ranks do it: the fold mesh ``(K, 1, 1)``
from ``parallel/mesh.py`` over NCCL, the fold's rows from
``data/splits.py``, its loader from ``train/kfold.py:make_fold_loaders``,
its own weights, and ``make_train_step`` (``entries/train.py:Trainer``).
The ranks open their windows together after a barrier; rank 0 gathers
the ranks' counts over the fold group. Each rank holds its own fold to the
reference on its own card, and hands its result to this process, which
loads nothing of the program."""

from __future__ import annotations

import os
import socket
import sys
import traceback

import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, port: int, args: dict, queue) -> None:
    try:
        queue.put((rank, _rank_run(rank, world, port, args)))
    except BaseException:   # reported to the parent, which fails the run
        queue.put((rank, {"error": traceback.format_exc()}))


def _rank_run(rank: int, world: int, port: int, args: dict) -> dict:
    import torch
    import torch.distributed as dist

    from benchmark import env
    from benchmark.entries.train import run_rank
    from benchmark.inputs import dataset
    from benchmark.timing import Spans

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world)})
    if args.get("device") == "cpu":       # a rehearsal: gloo between CPU processes
        device = torch.device("cpu")
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
    else:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank, device_id=device)
    try:
        from image_classification_tpu_torch.parallel.distributed import all_gather_json
        from image_classification_tpu_torch.parallel.mesh import FOLD_AXIS, MeshSpec, build_mesh

        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // world))
        mesh = build_mesh(MeshSpec(data=1, model=1, fold=world))
        data = dataset(args["traffic"], args["cfg_doc"]["config"], args["seed"], device)
        spans = Spans()
        out = run_rank(args["cfg_doc"], args["traffic"], args["seed"], args["seconds"],
                       args["trace"], device, data, spans, fold=mesh.index(FOLD_AXIS),
                       mesh=mesh, barrier=dist.barrier)
        win = out["window"]
        counts = all_gather_json({"images": win["images"], "wall_s": win["wall_s"]},
                                 mesh.group(FOLD_AXIS), device)
        if rank == 0:
            out["gathered"] = counts
        out["kind"] = (torch.cuda.get_device_name(device) if device.type == "cuda"
                       else "cpu")
        out["forbidden"] = env.loaded_forbidden()
        return out
    finally:
        dist.destroy_process_group()


def run(cfg_doc, traffic, seed, seconds, trace, chips: int, device: str = "cuda") -> list[dict]:
    """Every rank's result, in rank order; raises if a rank failed.
    ``device="cpu"`` rehearses the path on CPU processes over gloo."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    args = {"cfg_doc": cfg_doc, "traffic": traffic, "seed": seed, "seconds": seconds,
            "trace": trace, "device": device}
    procs = [ctx.Process(target=_rank, args=(r, chips, port, args, queue), daemon=False)
             for r in range(chips)]
    for p in procs:
        p.start()
    results: dict[int, dict] = {}
    try:
        while len(results) < chips:
            rank, res = queue.get(timeout=900)
            results[rank] = res
            if "error" in res:
                break
    finally:
        for p in procs:
            p.join(timeout=60 if len(results) == chips else 5)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    errors = [f"rank {r}:\n{res['error']}" for r, res in results.items() if "error" in res]
    if errors or len(results) < chips:
        print("\n".join(errors) or "a rank gave no result", file=sys.stderr)
        raise RuntimeError("a fold-parallel rank failed")
    return [results[r] for r in range(chips)]
