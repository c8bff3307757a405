"""update_device_ms.train: the program's ``train_step.update`` span (the
gradients' sum over the data ranks, then the fused clip, AdamW and EMA),
its device time, mean a step of the traced stretch
(``benchmark/program_spans.py``)."""

from benchmark.program_spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, "train", "train_step.update", "train_step")
