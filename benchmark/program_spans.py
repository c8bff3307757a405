"""The program's own spans (``image_classification_tpu_torch/utils/
profiler.py:span``) on a traced stretch's timeline, for the metrics whose
source is ``program_span``.

The program records its spans while a profiler session records, which in a
traced run is exactly the stretch that ``trace.py:profiled`` profiles, on
``time.time_ns``, the profiler's clock. A one-card cell's readers take them
in the process, from the module object the program wrote to
(``profiler.recorded()``), once the stretch has ended in a synchronise. The
ranks of a four-card cell record theirs in their own processes, which hand
nothing back: there every reader here returns None. A program without
spans returns None too.

Placement. A ``Trace`` holds times from its start, which it does not keep.
Each of the benchmark's own ``step`` (train) or ``predict`` marks opens
microseconds before the program's outermost ``train_step`` or
``predict_ensemble`` span. The marks and those spans are paired in order,
and the trace's start is taken as the least of (span start - mark start)
over the pairs: marks and spans share one clock, so a pair whose span
opened later (the host held up between the two calls) moves nothing.
Placement fails, None, where the counts differ or where any pair's offset
is more than 5 ms from the least (the interpreter's switch interval, far
below a step or a batch): the pairing is then in doubt.

Idle. Each gap of the union of device operations over ``[Trace.start,
Trace.end]`` (``timing.gaps``) is put down to the innermost placed program
span open at the gap's start (``timing.label_at``): the host work the empty
queue waited for."""

from __future__ import annotations

from collections import defaultdict

from benchmark.timing import gaps, label_at

OUTER = {"train": ("step", "train_step"), "predict": ("predict", "predict_ensemble")}
MAX_SKEW_NS = 5_000_000
TRAIN_STEP = ("train_step", "train_step.augment", "train_step.forward",
              "train_step.backward", "train_step.update")


def recorded() -> list[dict] | None:
    """The program's spans, or None where the program records none."""
    from image_classification_tpu_torch.utils import profiler

    read = getattr(profiler, "recorded", None)
    return read() if read is not None else None


def place(trace, spans: list[dict], role: str):
    """``spans`` as ``(name, start, end, span)`` in seconds on ``trace``'s
    timeline, or None where the marks and the outermost spans do not pair."""
    mark, outer = OUTER[role]
    marks = [s for n, s, _ in trace.spans if n == mark]
    tops = [r for r in spans if r["name"] == outer and r["parent"] is None]
    if not tops or len(tops) != len(marks):
        return None
    offsets = [r["start_ns"] - round(m * 1e9) for r, m in zip(tops, marks)]
    start_ns = min(offsets)
    if max(offsets) - start_ns > MAX_SKEW_NS:
        return None
    return [(r["name"], (r["start_ns"] - start_ns) * 1e-9, (r["end_ns"] - start_ns) * 1e-9, r)
            for r in spans if r["end_ns"] is not None]


def placed(ctx: dict, role: str):
    """``(trace, the program's spans placed on it)`` of a one-card cell of
    ``role``, or None."""
    if ctx["role"] != role or len(ctx["ranks"]) != 1:
        return None
    trace = ctx["ranks"][0]["trace"]
    spans = recorded()
    if trace is None or not spans:
        return None
    got = place(trace, spans, role)
    return None if got is None else (trace, got)


def idle_by_span(trace, spans) -> dict[str, float]:
    """Seconds of the stretch with nothing on the card, by the innermost
    placed span open when each gap opened (``"outside the spans"``: none)."""
    labelled = [(n, s, e) for n, s, e, _ in spans]
    out: dict[str, float] = defaultdict(float)
    for s, e in gaps([(s, e) for _, s, e in trace.device], trace.start, trace.end):
        out[label_at(s, labelled)] += e - s
    return dict(out)


def device_ms_per(ctx: dict, role: str, name: str, per: str) -> float | None:
    """The device ms of the spans named ``name``, summed, over the number
    of spans named ``per`` (a step's or a batch's)."""
    got = placed(ctx, role)
    if got is None:
        return None
    ms = [r["device_ms"] for n, _, _, r in got[1] if n == name]
    count = sum(1 for n, *_ in got[1] if n == per)
    if not ms or not count or any(m is None for m in ms):
        return None
    return sum(ms) / count


def idle_ms_per(ctx: dict, role: str, names, per: str) -> float | None:
    """Device idle in ms, in the gaps that opened while the innermost open
    span was one named in ``names``, over the number of spans named
    ``per``."""
    got = placed(ctx, role)
    if got is None:
        return None
    trace, spans = got
    count = sum(1 for n, *_ in spans if n == per)
    if not count:
        return None
    idle = idle_by_span(trace, spans)
    return 1e3 * sum(v for k, v in idle.items() if k in names) / count
