"""device_idle_pct.train: the share of the profiled stretch in which no
operation ran on the card (the union of the trace's device intervals),
the mean over ranks."""


def read(ctx):
    if ctx["role"] != "train":
        return None
    traces = [r["trace"] for r in ctx["ranks"] if r["trace"] is not None]
    if not traces:
        return None
    return sum(100.0 * (1.0 - t.busy_s / t.window_s) for t in traces) / len(traces)
