"""The predict cell's entry: ``infer/predict.py:predict_ensemble`` over
the port's loader of the benchmark's test set, as ``cli predict`` scores
it: the eval views, each fold model's forward in its inference cast, the
ensemble's mean. Passes over the test set repeat for the window; the
benchmark's wrapper around the loader ends the last pass when the window
closes (each batch ends in the program's own pull to the host, so a pass
that returns has finished). The first pass's probabilities of a sample
of images drawn from the seed are held to the reference once the models
are freed."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare
from benchmark.entries.common import peak_bytes, program_config, release
from benchmark.inputs import derive_seed, make_weights
from benchmark.reference.train import ensemble_probs, param_spec
from benchmark.trace import profiled, read_profile


class Clipped:
    """The test loader, ending its pass at ``deadline`` (host clock) or
    after ``max_batches``; counts the batches and the real images it
    handed out, and spans each ``next``."""

    def __init__(self, loader, spans, deadline: float | None = None,
                 max_batches: int | None = None):
        self.loader, self.spans = loader, spans
        self.deadline, self.max_batches = deadline, max_batches
        self.batches = self.images = 0

    def __iter__(self):
        it = iter(self.loader)
        try:
            while True:
                if self.deadline is not None and time.perf_counter() >= self.deadline:
                    return
                if self.max_batches is not None and self.batches >= self.max_batches:
                    return
                with self.spans("loader_next"):
                    batch = next(it, None)
                if batch is None:
                    return
                self.batches += 1
                self.images += int(batch["mask"].sum())
                yield batch
        finally:
            it.close()

    def batch_ids(self):
        return self.loader.batch_ids()


class Predictor:
    def __init__(self, cfg_doc: dict, traffic: dict, seed: int, device: torch.device,
                 data: dict, spans, wrap_predict=None):
        from image_classification_tpu_torch.data.loader import DataLoader
        from image_classification_tpu_torch.data.manifest import Manifest
        from image_classification_tpu_torch.data.source import ArraySource
        from image_classification_tpu_torch.infer.predict import predict_ensemble
        from image_classification_tpu_torch.models.factory import create_model

        self.device, self.spans = device, spans
        cfg = self.cfg = program_config(cfg_doc, seed, **traffic.get("config", {}))
        test = data["test"]
        n = len(test["labels"])
        manifest = Manifest(np.array([f"te{i:05d}" for i in range(n)], dtype=object),
                            np.full(n, -1), is_test=True)
        self.loader = DataLoader(ArraySource(test["images"]), manifest,
                                 batch_size=traffic["batch"], pad_last=True, device=device,
                                 prefetch_depth=cfg.prefetch_depth)
        spec = param_spec(cfg_doc["config"])
        self.weights_seeds = [derive_seed(seed, "weights", m) for m in range(traffic["models"])]
        self.models = []
        for m, ws in enumerate(self.weights_seeds):
            module = create_model(cfg, generator=torch.Generator().manual_seed(
                derive_seed(seed, "init", m))).module.to(device)
            module.load_state_dict(make_weights(spec, ws, device), strict=True)
            self.models.append(module)
        self.predict = predict_ensemble if wrap_predict is None else wrap_predict(predict_ensemble)

    def one_pass(self, spans=None, deadline=None, max_batches=None):
        wrapper = Clipped(self.loader, spans or self.spans, deadline, max_batches)
        with (spans or self.spans)("predict"):
            ids, _, probs = self.predict(self.models, wrapper, self.cfg)
        return ids, probs, wrapper

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        wall_start = time.time()
        deadline = t0 + seconds
        images = batches = bad_rows = 0
        first = None
        while time.perf_counter() < deadline:
            ids, probs, w = self.one_pass(deadline=deadline)
            images += w.images
            batches += w.batches
            bad_rows += int((~np.isfinite(probs).all(axis=1)).sum())
            if first is None:
                first = (ids, probs)
        wall = time.perf_counter() - t0
        return {"steps": batches, "images": images, "wall_s": wall, "wall_start": wall_start,
                "attempted": batches, "failed": min(bad_rows, batches), "first": first}

    def stretch(self, batches: int):
        """``batches`` more batches under the profiler, after one whose
        records are dropped; their Trace."""
        from benchmark.timing import Spans

        marked = Spans(marking=True)
        (_, _, w), prof, window = profiled(
            lambda: self.one_pass(marked, max_batches=1),
            lambda: self.one_pass(marked, max_batches=batches))
        marks = [m for m in marked.marks if window[0] <= m[1]]
        return read_profile(prof, window, marks, w.batches, w.images)

    def free(self) -> None:
        del self.models, self.loader
        release(self.device)


def sample_rows(seed: int, n_scored: int, n_sample: int) -> np.ndarray:
    rng = np.random.default_rng(derive_seed(seed, "sample"))
    return np.sort(rng.choice(n_scored, size=min(n_sample, n_scored), replace=False))


def reference_numbers(first, cfg_doc, data, weights_seeds, rows, device, quant=None) -> dict:
    ids, probs = first
    expect = np.array([f"te{i:05d}" for i in rows], dtype=object)
    if list(np.asarray(ids, dtype=object)[rows]) != list(expect):
        raise RuntimeError("the program's ids do not follow the test set's order")
    cfg = cfg_doc["config"]
    spec = param_spec(cfg)
    weights = [make_weights(spec, s, device) for s in weights_seeds]
    images = torch.from_numpy(data["test"]["images"][rows]).to(device)
    ref = ensemble_probs(weights, images, cfg, quant=quant)
    return compare.predict_numbers(torch.from_numpy(probs[rows]).to(device), ref)


def control_numbers(cfg_doc, data, weights_seeds, rows, device) -> dict:
    from benchmark.reference.quant import fp8

    cfg = cfg_doc["config"]
    spec = param_spec(cfg)
    weights = [make_weights(spec, s, device) for s in weights_seeds]
    images = torch.from_numpy(data["test"]["images"][rows]).to(device)
    return compare.predict_numbers(ensemble_probs(weights, images, cfg, quant=fp8),
                                   ensemble_probs(weights, images, cfg))


def run(cfg_doc, traffic, seed, seconds, trace, device, data, spans, wrap_predict=None) -> dict:
    p = Predictor(cfg_doc, traffic, seed, device, data, spans, wrap_predict)
    p.one_pass(max_batches=traffic["warm_batches"])        # set-up: every shape once
    spans.total.clear()
    spans.count.clear()
    win = p.window(seconds)
    tr = p.stretch(traffic["trace_batches"]) if trace else None
    peak = peak_bytes(device)
    loader_wait = spans.mean_ms("loader_next")
    p.free()
    first = win.pop("first")
    rows = sample_rows(seed, len(first[0]), traffic["check_images"])
    numbers = reference_numbers(first, cfg_doc, data, p.weights_seeds, rows, device)
    return {"window": win, "trace": tr, "peak_bytes": peak, "loader_wait_ms": loader_wait,
            "numbers": numbers}
