"""The train cells' entry: ``train/step.py:make_train_step``'s step, fed
by ``data/loader.py`` (``train/kfold.py:make_fold_loaders``: the
configuration's sampler) over the benchmark's train set (or one fold's
rows of it, ``foldpar``), its draws from a
generator on the card reseeded each step from the run's seed, dispatched
ahead in a closed loop (the host waits on nothing until the window
closes).

Set-up builds the one train step and state, loads the benchmark's
weights into the model, and runs the first three steps through the
window's own call and feed, keeping what the comparison needs: the loss
of each, the first moment after the first, and the parameters and EMA
after the third. The window goes on from the fourth step with the same
objects. Once it has closed and the program is freed, the reference runs
the same three steps and ``compare.py`` judges them."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare
from benchmark.entries.common import Marks, peak_bytes, program_config, release, sync
from benchmark.inputs import derive_seed, make_weights
from benchmark.reference.train import param_spec, train_steps
from benchmark.trace import profiled, read_profile

FIRST_STEPS = 3


class Trainer:
    """One fold's training as the program runs it. ``fold``/``mesh``: the
    fold-parallel rank's fold (0-based) and its mesh; without a mesh, the
    whole train set. ``wrap_step`` wraps the program's step (the tests'
    faults)."""

    def __init__(self, cfg_doc: dict, traffic: dict, seed: int, device: torch.device,
                 data: dict, spans, fold: int = 0, mesh=None, wrap_step=None):
        from image_classification_tpu_torch.data.manifest import Manifest
        from image_classification_tpu_torch.data.source import ArraySource
        from image_classification_tpu_torch.data.splits import stratified_kfold
        from image_classification_tpu_torch.models.factory import create_model
        from image_classification_tpu_torch.parallel.mesh import DATA_AXIS
        from image_classification_tpu_torch.train.kfold import make_fold_loaders
        from image_classification_tpu_torch.train.loop import build_lr_schedule
        from image_classification_tpu_torch.train.loss import build_criterion
        from image_classification_tpu_torch.train.optim import build_optimizer
        from image_classification_tpu_torch.train.step import make_train_step
        from image_classification_tpu_torch.train.train_state import create_train_state

        self.seed, self.fold, self.device, self.spans = seed, fold, device, spans
        cfg = self.cfg = program_config(cfg_doc, seed, **traffic.get("config", {}))
        train = data["train"]
        labels = train["labels"]
        manifest = Manifest(np.array([f"tr{i:05d}" for i in range(len(labels))], dtype=object),
                            labels)
        source = ArraySource(train["images"])
        if mesh is None:
            # the whole set as one fold's train rows: the configuration's
            # oversampling and sampler (shuffled, or weighted with replacement)
            rows, group = np.arange(len(labels)), None
            loader, _, fold_labels = make_fold_loaders(cfg, source, manifest, rows, rows[:0],
                                                       device=device)
            self.steps_per_epoch = len(loader)
        else:
            splits = list(stratified_kfold(labels, cfg.num_folds, cfg.fold_seed))
            tr, va = splits[fold]
            loader, _, fold_labels = make_fold_loaders(cfg, source, manifest, tr, va,
                                                       device=device, mesh=mesh)
            # the folds' least, as train/foldpar.py sizes every fold's epoch
            self.steps_per_epoch = min(len(t) for t, _ in splits) // cfg.batch_size
            group = mesh.group(DATA_AXIS)
        counts = np.bincount(fold_labels, minlength=cfg.num_classes)
        self.loader = loader
        self.feed = self._epochs()
        bundle = create_model(cfg, generator=torch.Generator().manual_seed(
            derive_seed(seed, "init", fold)))
        bundle.module.to(device)
        self.weights_seed = derive_seed(seed, "weights", fold)
        bundle.module.load_state_dict(
            make_weights(param_spec(cfg_doc["config"]), self.weights_seed, device),
            strict=True)
        criterion = build_criterion(cfg, class_counts=torch.as_tensor(counts, device=device),
                                    group=group)
        tx = build_optimizer(cfg, build_lr_schedule(cfg, self.steps_per_epoch))
        self.b1 = tx.b1
        self.state = create_train_state(bundle.module, use_ema=cfg.use_ema, use_swa=cfg.use_swa)
        step = make_train_step(bundle, cfg, tx, criterion, mesh=mesh)
        self.step = step if wrap_step is None else wrap_step(step)
        self.bundle = bundle
        self.gen = torch.Generator(device=device)
        self.index = 0

    def _epochs(self):
        epoch = 0
        while True:
            self.loader.set_epoch(epoch)
            yield from self.loader
            epoch += 1

    def step_seed(self, i: int) -> int:
        return derive_seed(self.seed, "step", self.fold, i)

    def step_once(self, spans=None):
        spans = spans or self.spans
        with spans("loader_next"):
            batch = next(self.feed)
        self.gen.manual_seed(self.step_seed(self.index))
        with spans("step"):
            self.state, metrics = self.step(self.state, batch, generator=self.gen)
        self.index += 1
        return batch, metrics

    @property
    def batch_images(self) -> int:
        return self.cfg.batch_size    # the global batch, every data rank's rows

    def first_steps(self) -> dict:
        """Steps 1-3, and what the comparison keeps of them."""
        rows, losses = [], []
        names = self.state.names()
        for i in range(FIRST_STEPS):
            batch, metrics = self.step_once()
            rows.append(np.asarray(batch["index"]).copy())
            losses.append(metrics["loss"])
            if i == 0:
                grad1 = {k: (m.detach() / (1.0 - self.b1)).to("cpu", copy=True)
                         for k, m in zip(names, self.state.mu)}
        params = {k: p.detach().to("cpu", copy=True) for k, p in zip(names, self.state.params())}
        ema = {k: e.detach().to("cpu", copy=True) for k, e in zip(names, self.state.ema)}
        sync(self.device)
        return {"rows": rows, "seeds": [self.step_seed(i) for i in range(FIRST_STEPS)],
                "loss": [float(x) for x in losses], "grad1": grad1,
                "params": params, "ema": ema}

    def window(self, seconds: float) -> dict:
        """Steps until ``seconds`` have passed, then a synchronise."""
        sync(self.device)
        marks = Marks(self.device)
        marks.mark()
        t0 = time.perf_counter()
        wall_start = time.time()
        losses, attempted, raised = [], 0, 0
        while True:
            attempted += 1
            try:
                _, metrics = self.step_once()
            except (RuntimeError, ValueError, FloatingPointError):
                raised += 1
                break
            marks.mark()
            losses.append(metrics["loss"])
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        wall = time.perf_counter() - t0
        finite = torch.isfinite(torch.stack(losses)).cpu().numpy() if losses else np.ones(0)
        steps = len(losses)
        return {"steps": steps, "images": steps * self.batch_images, "wall_s": wall,
                "wall_start": wall_start, "step_ms": marks.intervals_ms(),
                "attempted": attempted, "failed": raised + int((~finite.astype(bool)).sum())}

    def stretch(self, steps: int, warm: int = 2):
        """``steps`` more steps under the profiler, after ``warm`` whose
        records are dropped; their Trace."""
        from benchmark.timing import Spans

        marked = Spans(marking=True)

        def run(n):
            def go():
                for _ in range(n):
                    self.step_once(marked)
                sync(self.device)
            return go

        _, prof, window = profiled(run(warm), run(steps))
        marks = [m for m in marked.marks if window[0] <= m[1]]
        return read_profile(prof, window, marks, steps, steps * self.batch_images)

    def free(self) -> None:
        self.feed.close()
        del self.state, self.step, self.bundle, self.feed, self.loader
        release(self.device)


def reference_numbers(first: dict, cfg_doc: dict, data: dict, weights_seed: int,
                      steps_per_epoch: int, device: torch.device, quant=None) -> dict:
    """The reference's three steps from the same weights, rows and draw
    seeds, against the program's; the numbers ``compare.py`` judges."""
    cfg = cfg_doc["config"]
    rows = first["rows"]
    flat = np.concatenate(rows)
    if cfg["use_sampler"]:
        # the weighted sampler draws with replacement, as the recipe does:
        # a row may come twice, a batch may not
        if len({r.tobytes() for r in rows}) != len(rows):
            raise RuntimeError("a batch of the first steps repeats another")
    elif len(np.unique(flat)) != len(flat):
        raise RuntimeError("the first steps' rows are not all different")
    w0 = make_weights(param_spec(cfg), weights_seed, device)
    train = data["train"]
    batches = [(torch.from_numpy(train["images"][r]).to(device),
                torch.from_numpy(train["labels"][r]).to(device)) for r in rows]
    ref = train_steps(w0, batches, first["seeds"], cfg, steps_per_epoch, quant=quant)
    prog = {"loss": first["loss"],
            "grad1": {k: v.to(device) for k, v in first["grad1"].items()},
            "change": {k: v.to(device) - w0[k] for k, v in first["params"].items()},
            "ema_change": {k: v.to(device) - w0[k] for k, v in first["ema"].items()}}
    return compare.train_numbers(prog, ref)


def control_numbers(first: dict, cfg_doc: dict, data: dict, weights_seed: int,
                    steps_per_epoch: int, device: torch.device) -> dict:
    """The control: the reference in fp8 put in the program's place."""
    from benchmark.reference.quant import fp8

    cfg = cfg_doc["config"]
    w0 = make_weights(param_spec(cfg), weights_seed, device)
    train = data["train"]
    batches = [(torch.from_numpy(train["images"][r]).to(device),
                torch.from_numpy(train["labels"][r]).to(device)) for r in first["rows"]]
    low = train_steps(w0, batches, first["seeds"], cfg, steps_per_epoch, quant=fp8)
    ref = train_steps(w0, batches, first["seeds"], cfg, steps_per_epoch)
    return compare.train_numbers(low, ref)


def run_rank(cfg_doc, traffic, seed, seconds, trace, device, data, spans, *,
             fold=0, mesh=None, wrap_step=None, barrier=None) -> dict:
    """One trainer's whole run: set-up, window, stretch, reference."""
    trainer = Trainer(cfg_doc, traffic, seed, device, data, spans, fold=fold, mesh=mesh,
                      wrap_step=wrap_step)
    first = trainer.first_steps()
    if barrier is not None:
        barrier()
    spans.total.clear()
    spans.count.clear()
    win = trainer.window(seconds)
    tr = trainer.stretch(traffic["trace_steps"]) if trace else None
    peak = peak_bytes(device)
    out = {"window": win, "trace": tr, "peak_bytes": peak,
           "loader_wait_ms": spans.mean_ms("loader_next"),
           "weights_seed": trainer.weights_seed, "steps_per_epoch": trainer.steps_per_epoch}
    trainer.free()
    out["numbers"] = reference_numbers(first, cfg_doc, data, out["weights_seed"],
                                       out["steps_per_epoch"], device)
    return out
