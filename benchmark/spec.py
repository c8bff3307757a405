"""The benchmark's definition, read from ``BENCHMARK.json`` at the root of
the checkout, and the files it names, found by name:

- a configuration ``<config>`` is ``benchmark/configs/<config>.json`` (its
  ``config`` dict is the program's ``Config`` as it is run);
- a traffic mix ``<traffic>`` is ``benchmark/traffic/<traffic>.json``: the
  entry it drives (``train``, ``predict`` or ``foldpar``) and its
  parameters;
- a per-layer metric ``<metric>`` is read by ``benchmark/metrics/<metric>.py``,
  whose ``read(ctx)`` returns the number or None.

A later change adds a cell, a configuration, a traffic mix or a metric by
adding files and entries; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRIES = ("train", "predict", "foldpar")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad {what} name {name!r}: 1-64 of letters, digits, '_', "
                         "'.', '-', not starting with '.' or '-'")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT.match(unit):
        raise ValueError(f"bad unit {unit!r}: 1-16 of letters, digits, '_', '/', '%', "
                         "'.', '-'")
    return unit


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench_dir = self.root / "benchmark"
        self.doc = load_json(self.root / "BENCHMARK.json")
        for c in self.doc["configs"]:
            check_name(c["name"], "config")
        for w in self.doc["workloads"]:
            check_name(w["name"], "workload")
            check_name(w["config"], "config")
            check_name(w["traffic"], "traffic")
        for m in self.doc["end_to_end"] + self.doc["per_layer"]:
            check_name(m["name"], "metric")
            check_unit(m["unit"])

    def workload(self, name: str) -> dict:
        check_name(name, "workload")
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        """The configuration's file: ``source``, ``reduced``, ``config``."""
        return load_json(self.bench_dir / "configs" / f"{check_name(name, 'config')}.json")

    def traffic(self, name: str) -> dict:
        t = load_json(self.bench_dir / "traffic" / f"{check_name(name, 'traffic')}.json")
        if t.get("entry") not in ENTRIES:
            raise ValueError(f"traffic {name!r}: entry {t.get('entry')!r} not in {ENTRIES}")
        return t

    def metrics_of(self, workload: str, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics a workload reports:
        those that list it, or that list no workloads."""
        return [m for m in self.doc[kind]
                if "workloads" not in m or workload in m["workloads"]]

    def reader(self, metric: str):
        """``benchmark/metrics/<metric>.py``'s ``read``."""
        path = self.bench_dir / "metrics" / f"{check_name(metric, 'metric')}.py"
        mod_name = "benchmark_metric_" + re.sub(r"\W", "_", metric)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        if spec is None or spec.loader is None:
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
