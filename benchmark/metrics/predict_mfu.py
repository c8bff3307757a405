"""predict_mfu: forward operations of every model and view of a test
image at the window's images/s, over 989 TFLOP/s (bf16, dense)."""

from benchmark.rooflines import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "predict")
