"""dispatch_idle_ms.train: the card's idle time in the gaps that opened
while the innermost open program span was ``train_step`` or one of its
parts (the card waiting on the step's own host dispatch), mean a step of
the traced stretch. A gap that opened in a generation-2 collection
(``host.gc``) or in the loader's ``loader.next`` is not counted here
(``benchmark/program_spans.py``)."""

from benchmark.program_spans import TRAIN_STEP, idle_ms_per


def read(ctx):
    return idle_ms_per(ctx, "train", TRAIN_STEP, "train_step")
