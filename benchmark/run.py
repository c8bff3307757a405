"""Run one cell of the benchmark once and print its result.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix and its metrics come from
``BENCHMARK.json`` and the files it names (``benchmark/spec.py``). With
``--trace 0`` the last line of standard output holds the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics, each from its own
reader in ``benchmark/metrics/``, with the device's busy time, the traced
window and the breakdown of the profiled stretch. Every run holds what its
window produced to the reference (``benchmark/compare.py``) and prints each
number compared beside its limit, last on standard error and under
``checks`` in the result. A run on a machine without the cards the cell
asks for, or with JAX or the JAX package loaded, prints no result and
exits with another code than 0."""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import compare, env  # noqa: E402
from benchmark.spec import Spec, load_json  # noqa: E402
from benchmark.timing import percentile  # noqa: E402

NO_CARD = 2
JAX_LOADED = 3


def process_start_time() -> float:
    """This process' start, seconds since the epoch (``/proc``)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def end_to_end(role: str, ranks: list[dict], setup_s: float) -> dict:
    """Every end-to-end number the entry's window gives."""
    rate = sum(r["window"]["images"] / r["window"]["wall_s"] for r in ranks)
    out = {"setup_s": (setup_s, "s")}
    if role == "train":
        step_ms = [ms for r in ranks for ms in r["window"]["step_ms"]]
        out["train_images_per_s"] = (rate, "images/s")
        out["train_step_p95_ms"] = (percentile(step_ms, 95), "ms")
    else:
        out["predict_images_per_s"] = (rate, "images/s")
    return out


def reader_context(entry: str, cfg_doc: dict, traffic: dict, chips: int, ranks) -> dict:
    return {"entry": entry, "role": "predict" if entry == "predict" else "train",
            "cfg": cfg_doc["config"], "traffic": traffic, "chips": chips,
            "ranks": [{"images": r["window"]["images"], "wall_s": r["window"]["wall_s"],
                       "steps": r["window"]["steps"], "loader_wait_ms": r["loader_wait_ms"],
                       "trace": r["trace"]} for r in ranks]}


def run_cell(spec: Spec, workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", wrap=None) -> tuple[dict, str]:
    """The result line's dict, and the host line printed before it.
    ``device="cpu"`` rehearses the cell on the CPU with the kernels' plain
    versions: its line says ``platform: cpu`` and holds no metric, since
    every metric here is the card's (``main`` prints no such line). ``wrap`` wraps the
    program's train step or ``predict_ensemble`` (the tests' faults)."""
    import torch

    w = spec.workload(workload)
    cfg_doc, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    limits = load_json(spec.bench_dir / "limits" / f"{workload}.json")
    chips = int(w["chips"])
    entry = traffic["entry"]
    if entry == "foldpar":
        from benchmark.entries import foldpar

        ranks = foldpar.run(cfg_doc, traffic, seed, seconds, trace, chips, device=device)
        forbidden = sorted({m for r in ranks for m in r["forbidden"]})
        if forbidden:
            raise RuntimeError(f"a rank loaded JAX or the JAX package: {forbidden}")
        kind = ranks[0]["kind"]
    else:
        from benchmark.inputs import dataset
        from benchmark.timing import Spans

        if chips != 1:
            raise ValueError(f"entry {entry!r} runs on one card, the cell asks for {chips}")
        dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        data = dataset(traffic, cfg_doc["config"], seed, dev)
        spans = Spans()
        if entry == "train":
            from benchmark.entries.train import run_rank

            ranks = [run_rank(cfg_doc, traffic, seed, seconds, trace, dev, data, spans,
                              wrap_step=wrap)]
        else:
            from benchmark.entries import predict

            ranks = [predict.run(cfg_doc, traffic, seed, seconds, trace, dev, data, spans,
                                 wrap_predict=wrap)]
        kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    role = "predict" if entry == "predict" else "train"
    setup_s = min(r["window"]["wall_start"] for r in ranks) - t_start
    numbers = {}
    for i, r in enumerate(ranks):
        for name, (value, where) in r["numbers"].items():
            numbers[name] = max(numbers.get(name, (-1.0, "")),
                                (value, where if len(ranks) == 1 else f"rank {i}, {where}"))
    correct, checks = compare.judge(numbers, limits)
    failed = sum(r["window"]["failed"] for r in ranks)
    line = {"correct": bool(correct and failed == 0),
            "attempted": sum(r["window"]["attempted"] for r in ranks),
            "failed": failed,
            "metrics": {},
            "device": {"platform": "gpu" if device == "cuda" else device, "kind": kind,
                       "count": chips,
                       "memory_peak_bytes": max(r["peak_bytes"] or 0 for r in ranks)}}
    if device == "cuda" and not trace:
        values = end_to_end(role, ranks, setup_s)
        for m in spec.metrics_of(workload, "end_to_end"):
            line["metrics"][m["name"]] = {"value": values[m["name"]][0], "unit": m["unit"]}
    elif device == "cuda":
        from benchmark.trace import breakdown

        ctx = reader_context(entry, cfg_doc, traffic, chips, ranks)
        for m in spec.metrics_of(workload, "per_layer"):
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                line["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        traces = [r["trace"] for r in ranks]
        line["device"]["busy_s"] = sum(t.busy_s for t in traces) / len(traces)
        line["device"]["window_s"] = sum(t.window_s for t in traces) / len(traces)
        line["breakdown"] = breakdown(traces)
        print(f"trace: {sum(t.kernels for t in traces)} kernel records, "
              f"{sum(t.launches for t in traces)} launches, "
              f"{sum(t.lost for t in traces)} launches without a record, "
              f"{sum(t.outside for t in traces)} operations outside the stretch",
              file=sys.stderr)
    line["checks"] = checks
    return line, env.host_line()


def main(argv=None) -> int:
    t_start = process_start_time()
    args = parse(argv)
    root = Path(__file__).resolve().parent.parent
    env.set_caches(root)
    spec = Spec(root)
    w = spec.workload(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
        print(f"benchmark: the cell {args.workload} needs {w['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, device_count() "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return NO_CARD
    env.require_no_jax()
    line, host = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start)
    found = env.loaded_forbidden()
    if found:
        print(f"benchmark: JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return JAX_LOADED
    print(host, flush=True)
    print(json.dumps(line), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}, {c['at']})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
