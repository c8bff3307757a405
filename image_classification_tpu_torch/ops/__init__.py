"""The port's hand-written kernels, each beside its plain PyTorch version.

A wrapper takes the plain version only for a CPU tensor; for a CUDA tensor it
launches its kernel or raises. Each wrapper counts its launches in a plain
integer attribute, ``<wrapper>.launches``. The forward ops (``block_mlp``,
``depthwise_conv7x7``, ``gelu``) are differentiable: under autograd their
backwards call the backward wrappers (``*_bwd``; the depthwise backward
calls the forward and ``depthwise_conv7x7_wgrad``). ``warp`` (the
augmentation's bilinear resampling) is forward only.
"""

from image_classification_tpu_torch.ops.block_mlp import (
    block_mlp,
    block_mlp_available,
    block_mlp_bwd,
    block_mlp_bwd_reference,
    block_mlp_fwd,
    block_mlp_fwd_reference,
    block_mlp_reference,
)
from image_classification_tpu_torch.ops.dwconv import (
    depthwise_conv7x7,
    depthwise_conv7x7_bwd,
    depthwise_conv7x7_bwd_reference,
    depthwise_conv7x7_reference,
    depthwise_conv7x7_wgrad,
    depthwise_conv7x7_wgrad_reference,
)
from image_classification_tpu_torch.ops.gelu import (
    gelu,
    gelu_bwd,
    gelu_grad_reference,
    gelu_reference,
)
from image_classification_tpu_torch.ops.warp import warp, warp_reference

KERNEL_WRAPPERS = (depthwise_conv7x7, block_mlp, gelu,
                   depthwise_conv7x7_bwd, block_mlp_bwd, gelu_bwd, warp,
                   depthwise_conv7x7_wgrad)

__all__ = [
    "KERNEL_WRAPPERS",
    "block_mlp",
    "block_mlp_available",
    "block_mlp_bwd",
    "block_mlp_bwd_reference",
    "block_mlp_fwd",
    "block_mlp_fwd_reference",
    "block_mlp_reference",
    "depthwise_conv7x7",
    "depthwise_conv7x7_bwd",
    "depthwise_conv7x7_bwd_reference",
    "depthwise_conv7x7_reference",
    "depthwise_conv7x7_wgrad",
    "depthwise_conv7x7_wgrad_reference",
    "gelu",
    "gelu_bwd",
    "gelu_grad_reference",
    "gelu_reference",
    "warp",
    "warp_reference",
]
