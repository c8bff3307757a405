"""A profiled stretch and what the per-layer metrics read from it: the
device's operations (kernels, copies, sets) with their times, the
benchmark's own host spans, and a count of kernel launches against kernel
records, so that a trace that lost records says so. Only the card's
activity is recorded: recording every host op doubled the host's time a
step (a four-card trace of V4 at batch 128 read 236 ms a step against 120
unprofiled, on H100s), which a host-paced step shows as idle. The host spans
are taken on the profiler's clock (``time.time_ns``)."""

from __future__ import annotations

from dataclasses import dataclass, field

from benchmark.timing import busy, gaps, label_at

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
NOT_KERNELS = ("Memcpy", "Memset")
NAME_CHARS = 160


@dataclass
class Trace:
    """One rank's profiled stretch; times in seconds from the trace's
    start."""

    start: float
    end: float
    device: list[tuple[str, float, float]] = field(default_factory=list)
    spans: list[tuple[str, float, float]] = field(default_factory=list)
    launches: int = 0
    steps: int = 0      # optimizer steps or batches in the stretch
    images: int = 0

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return busy([(s, e) for _, s, e in self.device], self.start, self.end)

    @property
    def kernels(self) -> int:
        return sum(1 for n, _, _ in self.device if not n.startswith(NOT_KERNELS))

    @property
    def lost(self) -> int:
        """Launches the trace holds no kernel record of."""
        return max(self.launches - self.kernels, 0)

    @property
    def outside(self) -> int:
        """Device operations that started outside the stretch: on one
        clock, only what the stretch's first launches found queued."""
        return sum(1 for _, s, _ in self.device if not self.start <= s <= self.end)

    def seconds_of(self, names) -> float:
        """Device time of the operations whose name holds one of ``names``."""
        return sum(e - s for n, s, e in self.device if any(k in n for k in names))



def _trace_start_ns(prof) -> int:
    res = prof.profiler.kineto_results
    if hasattr(res, "trace_start_ns"):
        return int(res.trace_start_ns())
    return int(res.trace_start_us()) * 1000


def read_profile(prof, window_ns: tuple[int, int], spans_ns, steps: int,
                 images: int) -> Trace:
    """The stretch ``window_ns`` (host clock, ``time.time_ns``, the
    profiler's own clock) of ``prof``'s events, with the benchmark's host
    spans ``(name, start_ns, end_ns)``; times in seconds from the trace's
    start."""
    from torch.autograd import DeviceType

    t0 = _trace_start_ns(prof)
    device, launches = [], 0
    for e in prof.events():
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            device.append((e.name, s, t))
        elif e.name in LAUNCHES:
            launches += 1
    spans = [(n, (a - t0) * 1e-9, (b - t0) * 1e-9) for n, a, b in spans_ns]
    return Trace((window_ns[0] - t0) * 1e-9, (window_ns[1] - t0) * 1e-9, device, spans,
                 launches, steps, images)


def breakdown(traces: list[Trace], top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps by the benchmark's host span open when the card went idle, over
    every rank's stretch."""
    by_name: dict[str, float] = {}
    for tr in traces:
        for n, s, e in tr.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = []
    for tr in traces:
        for s, e in gaps([(s, e) for _, s, e in tr.device], tr.start, tr.end):
            idle.append((label_at(s, tr.spans), e - s))
    idle.sort(key=lambda kv: -kv[1])
    return {"device_ops": [[n[:NAME_CHARS], v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in idle[:top]]}


def profiled(warm, run):
    """``warm()`` then ``run()`` (each ending in a synchronise) under
    ``torch.profiler``, recording the card's activity only, so that the host
    runs at its unprofiled pace; ``warm`` is the profiler's warm-up phase,
    whose records are dropped (the tracer's start-up left a 118-214 ms gap
    in the first traced step of V4 at batch 256 on an H100). Returns (run's
    result, the profile, the stretch's (start, end) in ``time.time_ns``)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                  else [ProfilerActivity.CPU])
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        warm()
        prof.step()
        start = time.time_ns()
        out = run()
        end = time.time_ns()
        prof.step()
    return out, prof, (start, end)
