"""loader_wait_ms.predict: the benchmark's host span around the loader's
``next()`` in the window, its mean a batch (the mean over ranks)."""


def read(ctx):
    if ctx["role"] != "predict":
        return None
    waits = [r["loader_wait_ms"] for r in ctx["ranks"] if r["loader_wait_ms"] is not None]
    return sum(waits) / len(waits) if waits else None
