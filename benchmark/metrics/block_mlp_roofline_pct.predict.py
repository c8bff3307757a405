"""block_mlp_roofline_pct.predict: the fused ConvNeXt block tail (LayerNorm,
fc1, GELU, fc2, layer scale, residual) of the blocks whose width the
kernels below serve, C <= 512 (ConvNeXt-B's stages 0-2, 33 of its 36
blocks): the least time of its forward at 989 TFLOP/s and
3.35 TB/s (``counts.block_tail_work``) over the device time of these kernels
(``csrc/block_mlp.cu``, ``csrc/block_mlp_bwd.cu``, ``csrc/wgmma_gemm.cuh``)."""

from benchmark.rooflines import block_tail_least_s, roofline_pct

MAX_C = 512
KERNELS = ("namespace)::gemm_kernel<", "namespace)::ln_fwd_kernel<", "namespace)::prep_kernel<",
           "namespace)::ln_bwd_kernel", "namespace)::sum_partials_kernel",
           "namespace)::ln_rows_kernel", "namespace)::bwd_prep_kernel",
           "namespace)::sum_rows_kernel", "namespace)::gemm_f32_fma_kernel")


def read(ctx):
    if ctx["role"] != "predict":
        return None
    return roofline_pct(ctx, "predict", KERNELS, block_tail_least_s(ctx, MAX_C))
