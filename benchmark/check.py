"""The readings that the limits of ``benchmark/limits/`` are set from, at
the cell's own size on the card, many seeds in one process:

    python3 -m benchmark.check --workload <name> --seeds 1,2,... \
        [--control-seeds ...] [--fault-seeds ...] [--out FILE]

For each seed: the program's numbers (set-up and the first three steps of
a train cell, without a window; one pass of ``check_batches`` batches of a
predict cell), held to the reference as a run holds them. With
``--control-seeds``: the control, the reference in fp8 put in the
program's place. With ``--fault-seeds`` (train cells): the program fed half
of each batch, the mean taken over the rest. Prints one JSON line a
reading. The benchmark's runs do not run this."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import env  # noqa: E402
from benchmark.spec import Spec  # noqa: E402


def half_batch(step):
    """A fault: the step trains on the first half of each batch only."""
    def faulty(state, batch, generator=None, draws=None):
        half = {k: v[: len(v) // 2] for k, v in batch.items()}
        return step(state, half, generator=generator, draws=draws)
    return faulty


def readings(spec: Spec, workload: str, seeds, control_seeds, fault_seeds, device):
    from benchmark.entries import predict as pe
    from benchmark.entries import train as te
    from benchmark.inputs import dataset
    from benchmark.timing import Spans

    w = spec.workload(workload)
    cfg_doc, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    jobs = ([("program", s) for s in seeds] + [("control", s) for s in control_seeds]
            + [("half_batch", s) for s in fault_seeds])
    for kind, seed in jobs:
        t0 = time.perf_counter()
        data = dataset(traffic, cfg_doc["config"], seed, device)
        if traffic["entry"] == "predict":
            p = pe.Predictor(cfg_doc, traffic, seed, device, data, Spans())
            ids, probs, w_ = p.one_pass(max_batches=traffic["check_batches"])
            p.free()
            rows = pe.sample_rows(seed, len(ids), traffic["check_images"])
            if kind == "program":
                nums = pe.reference_numbers((ids, probs), cfg_doc, data, p.weights_seeds, rows,
                                            device)
            elif kind == "control":
                nums = pe.control_numbers(cfg_doc, data, p.weights_seeds, rows, device)
            else:
                raise ValueError("a predict cell has no half-batch fault")
        else:
            wrap = half_batch if kind == "half_batch" else None
            t = te.Trainer(cfg_doc, traffic, seed, device, data, Spans(), wrap_step=wrap)
            first = t.first_steps()
            ws, spe = t.weights_seed, t.steps_per_epoch
            t.free()
            if kind == "control":
                nums = te.control_numbers(first, cfg_doc, data, ws, spe, device)
            else:
                nums = te.reference_numbers(first, cfg_doc, data, ws, spe, device)
        yield {"workload": workload, "kind": kind, "seed": seed,
               "numbers": {k: v[0] for k, v in nums.items()},
               "at": {k: v[1] for k, v in nums.items()},
               "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    root = Path(__file__).resolve().parent.parent
    env.set_caches(root)
    import torch

    if not torch.cuda.is_available():
        print("check: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = open(args.out, "a") if args.out else None
    try:
        for r in readings(Spec(root), args.workload, ints(args.seeds),
                          ints(args.control_seeds), ints(args.fault_seeds), device):
            line = json.dumps(r)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    env.require_no_jax()
    return 0


if __name__ == "__main__":
    sys.exit(main())
