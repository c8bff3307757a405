"""aug_device_ms.train: the program's ``train_step.augment`` span (the aug's
draws, the aug, then MixUp/CutMix), its device time (CUDA events on the
stream at the span's entry and exit), mean a step of the traced stretch
(``benchmark/program_spans.py``)."""

from benchmark.program_spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, "train", "train_step.augment", "train_step")
