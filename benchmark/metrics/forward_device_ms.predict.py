"""forward_device_ms.predict: the program's ``predict.forward`` span (every
fold model's forward over the batch's stacked TTA views, and their
weighted sum), its device time, mean a batch of the traced stretch
(``benchmark/program_spans.py``)."""

from benchmark.program_spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, "predict", "predict.forward", "predict.pull")
