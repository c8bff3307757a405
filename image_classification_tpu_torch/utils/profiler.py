"""Step timing, throughput and duty cycle, port of
``image_classification_tpu/utils/profiler.py``.

:class:`StepTimer` splits an epoch's wall time into the host's wait for the
next batch (``data_wait``) and the rest; the train step returns before the
card finishes, so the caller synchronises the device (``sync``) before the
timer's clock is read at the end of an epoch. :func:`trace` records a
``torch.profiler`` chrome trace of a region into ``profile_dir``.
:func:`device_ms` times a function's kernels on the card.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from dataclasses import dataclass, field

import torch


@dataclass
class StepTimer:
    """``data_time``: host time spent waiting for the next batch;
    ``compute_time``: host time in the step calls (dispatch; the card runs
    behind them)."""

    data_time: float = 0.0
    compute_time: float = 0.0
    n_steps: int = 0
    n_images: int = 0
    _t0: float = field(default_factory=time.perf_counter)

    @contextlib.contextmanager
    def data_wait(self):
        t = time.perf_counter()
        yield
        self.data_time += time.perf_counter() - t

    @contextlib.contextmanager
    def compute(self, n_images: int = 0):
        t = time.perf_counter()
        yield
        self.compute_time += time.perf_counter() - t
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


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(profile_dir: str | None, name: str = "trace"):
    """A ``torch.profiler`` trace of the region (CPU, and CUDA where
    available) written to ``{profile_dir}/{name}.json``; nothing without a
    ``profile_dir``."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, f"{name}.json"))


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
