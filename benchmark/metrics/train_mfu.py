"""train_mfu: model operations of a trained image (the forward's three
times, aux heads included, no recomputation, no aug; ``counts.py``) at
the window's images/s, over 989 TFLOP/s (bf16, dense) times the chips."""

from benchmark.rooflines import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "train")
