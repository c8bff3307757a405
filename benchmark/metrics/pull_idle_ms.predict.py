"""pull_idle_ms.predict: the card's idle time in the gaps that opened while
the innermost open program span was ``predict.pull`` (the batch's
probabilities and mask copied to the host, which waits for the card), mean
a batch of the traced stretch: what the per-batch pull costs the card
(``benchmark/program_spans.py``)."""

from benchmark.program_spans import idle_ms_per


def read(ctx):
    return idle_ms_per(ctx, "predict", ("predict.pull",), "predict.pull")
