"""Step timing, throughput and duty cycle, port of
``image_classification_tpu/utils/profiler.py``, and the program's spans.

:class:`StepTimer` splits an epoch's wall time into the host's wait for the
next batch (``data_wait``) and the rest; the train step returns before the
card finishes, so the caller synchronises the device (``sync``) before the
timer's clock is read at the end of an epoch. :func:`span` marks a stretch
of the program (the train step's aug, forward, backward and update, the
predict loop's views, forward and host pull, the loader's hand-over) while
a ``torch.profiler`` session records; :func:`recorded` gives what was
marked. :func:`trace` records a ``torch.profiler`` chrome trace of a region
into ``profile_dir``, and its spans beside it. :func:`device_ms` times a
function's kernels on the card.

This module imports only torch and the standard library: tools load it by
path, alone.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import os
import threading
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _autograd_profiler


@dataclass
class StepTimer:
    """``data_time``: host time spent waiting for the next batch;
    ``n_steps`` / ``n_images``: the steps and images counted by
    :meth:`step`."""

    data_time: float = 0.0
    n_steps: int = 0
    n_images: int = 0
    _t0: float = field(default_factory=time.perf_counter)

    @contextlib.contextmanager
    def data_wait(self):
        t = time.perf_counter()
        yield
        self.data_time += time.perf_counter() - t

    def step(self, n_images: int = 0) -> None:
        """Count one step of ``n_images`` images."""
        self.n_steps += 1
        self.n_images += n_images

    @property
    def wall_time(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def duty_cycle(self) -> float:
        """Fraction of wall time NOT spent waiting on input."""
        wall = max(self.wall_time, 1e-9)
        return 1.0 - self.data_time / wall

    @property
    def images_per_sec(self) -> float:
        return self.n_images / max(self.wall_time, 1e-9)

    def summary(self) -> dict[str, float]:
        return {
            "steps": self.n_steps,
            "images_per_sec": round(self.images_per_sec, 2),
            "duty_cycle": round(self.duty_cycle, 4),
            "data_time_s": round(self.data_time, 3),
            "wall_time_s": round(self.wall_time, 3),
        }


# Spans. One recorder a process: the spans recorded since the last clear(),
# in the order they opened, and each thread's open spans, innermost last.
# Nothing is recorded unless a torch.profiler session is in its recording
# phase: torch sets ``_is_profiler_enabled`` when that phase starts and
# clears it when it stops (not in a schedule's warm-up), and it is read
# from the module at each span, never copied.
_spans: list[_Span] = []
_threads = threading.local()
_collection: _Span | None = None      # the generation-2 collection under way
_OFF = contextlib.nullcontext()


def _open_spans() -> list[_Span]:
    stack = getattr(_threads, "open", None)
    if stack is None:
        stack = _threads.open = []
    return stack


class _Span:
    __slots__ = ("name", "parent", "step", "rows", "start_ns", "end_ns", "events")

    def __init__(self, name: str, step, rows):
        self.name, self.step, self.rows = name, step, rows
        self.end_ns = self.events = None
        stack = _open_spans()
        self.parent = stack[-1] if stack else None
        if step is None and self.parent is not None:
            self.step = self.parent.step
        _spans.append(self)
        self.start_ns = time.time_ns()

    def __enter__(self) -> _Span:
        _open_spans().append(self)
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        return self

    def __exit__(self, *exc) -> bool:
        if self.events is not None:
            self.events[1].record()
        self.end_ns = time.time_ns()
        _open_spans().pop()
        return False


def span(name: str, *, step=None, rows=None):
    """A context manager that records the region as a span named ``name``
    while a ``torch.profiler`` session records, and does nothing otherwise.
    A span records its parent (the innermost span open on this thread), the
    step or batch id ``step`` (by default its parent's), the ``rows`` it
    handled, its host start and end from ``time.time_ns`` (the clock of
    ``torch.profiler``'s timestamps), and, where CUDA is initialised, a
    pair of CUDA events on the current stream at entry and exit, which give
    the stream's time from the span's first queued work to its last.
    Nothing waits on them here: :func:`recorded` reads them."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, step, rows)


def _on_collection(phase: str, info: dict) -> None:
    """A ``gc.callbacks`` hook: each generation-2 collection, while spans
    record, as the span ``host.gc`` (host times only), its parent the span
    open when it started."""
    global _collection
    if not _autograd_profiler._is_profiler_enabled or info["generation"] != 2:
        return
    if phase == "start":
        _collection = _Span("host.gc", None, None)
    elif _collection is not None:
        _collection.end_ns = time.time_ns()
        _collection = None


gc.callbacks.append(_on_collection)


def recorded() -> list[dict]:
    """The spans recorded since the last :func:`clear`, in the order they
    opened: ``name``, ``parent`` (the parent's index in this list, None for
    none), ``step``, ``rows``, ``start_ns`` and ``end_ns`` (``time.time_ns``),
    and ``device_ms`` (None without CUDA events). Call it once the device
    has been synchronised."""
    index = {id(s): i for i, s in enumerate(_spans)}
    return [{"name": s.name, "parent": index.get(id(s.parent)), "step": s.step,
             "rows": s.rows, "start_ns": s.start_ns, "end_ns": s.end_ns,
             "device_ms": None if s.events is None else s.events[0].elapsed_time(s.events[1])}
            for s in _spans]


def clear() -> None:
    """Forget the recorded spans."""
    _spans.clear()


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(profile_dir: str | None, name: str = "trace"):
    """A ``torch.profiler`` trace of the region (CPU, and CUDA where
    available) written to ``{profile_dir}/{name}.json``, and the region's
    spans (:func:`recorded`) to ``{profile_dir}/{name}.spans.json``; nothing
    without a ``profile_dir``."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    clear()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, f"{name}.json"))
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    with open(os.path.join(profile_dir, f"{name}.spans.json"), "w") as f:
        json.dump(recorded(), f)


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` a call on the current CUDA stream: ``iters``
    calls queued behind a spin kernel, so the card runs them back to back
    whatever the host's launch rate, between two CUDA events. (Short
    ``torch.profiler`` traces lose kernel records: 1 to all 20 of 20 on an
    H100.) ``fn`` must not wait for the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    spin_ms = 2e3 * (time.perf_counter() - t0) + 1.0
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * _spin_cycles_per_ms()))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        covered = not start.query()     # the spin outlasted the queueing
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / iters
        spin_ms *= 4
    raise RuntimeError("device_ms: the host did not queue the calls within the spin")


@functools.cache
def _spin_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` a millisecond on this card."""
    cycles = 10_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles // 10)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)
