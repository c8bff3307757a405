"""The window's arithmetic and its host spans: rates, the pooled 95th
percentile, the union of device intervals, and idle gaps by open span."""

from __future__ import annotations

import contextlib
import math
import time
from collections import defaultdict


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    closest ranks (numpy's default), of all ``values``."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def intervals_between(ends_ms: list[float]) -> list[float]:
    """Step times from consecutive step ends: ``ends_ms[0]`` is the
    window's start mark, each later one a step's end."""
    return [b - a for a, b in zip(ends_ms, ends_ms[1:])]


def union(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals clipped to ``[lo, hi]``, as
    sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(intervals, lo: float, hi: float) -> float:
    return sum(e - s for s, e in union(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, at = [], lo
    for s, e in union(intervals, lo, hi):
        if s > at:
            out.append((at, s))
        at = e
    if hi > at:
        out.append((at, hi))
    return out


def label_at(t: float, spans) -> str:
    """The innermost of the ``(name, start, end)`` host spans open at
    ``t`` (the shortest that holds it), or ``"outside the spans"``."""
    best = None
    for name, s, e in spans:
        if s <= t < e and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else "outside the spans"


class Spans:
    """Host time in named spans around the benchmark's calls into the
    program: totals and counts, and, while ``marking``, each span's
    ``(name, start, end)`` in ``time.time_ns`` (the profiler's clock), so
    that a trace shows which span was open."""

    def __init__(self, marking: bool = False):
        self.total = defaultdict(float)
        self.count = defaultdict(int)
        self.marking = marking
        self.marks: list[tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        ns = time.time_ns() if self.marking else 0
        yield
        if self.marking:
            self.marks.append((name, ns, time.time_ns()))
        self.total[name] += time.perf_counter() - t
        self.count[name] += 1

    def mean_ms(self, name: str) -> float | None:
        n = self.count.get(name, 0)
        return 1e3 * self.total[name] / n if n else None
