"""backward_device_ms.train: the program's ``train_step.backward`` spans
(``torch.autograd.grad`` and the microbatches' gradient sum; one a
microbatch), their device time summed over a step's microbatches, mean a
step of the traced stretch (``benchmark/program_spans.py``)."""

from benchmark.program_spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, "train", "train_step.backward", "train_step")
