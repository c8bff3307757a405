"""dwconv_roofline_pct.train: the 7x7 depthwise conv of every block, its
forward, dx and dw: the least time at 67 TFLOP/s (f32, outside the tensor
cores) and 3.35 TB/s (``counts.dwconv_work``) over the device time of these
kernels (``csrc/dwconv7x7_fwd_wgrad.cu``)."""

from benchmark.rooflines import dwconv_least_s, roofline_pct

KERNELS = ("dwconv7x7_fwd_tile", "dwconv7x7_wgrad_tile", "dwconv7x7_wgrad_reduce")


def read(ctx):
    if ctx["role"] != "train":
        return None
    return roofline_pct(ctx, "train", KERNELS, dwconv_least_s(ctx))
