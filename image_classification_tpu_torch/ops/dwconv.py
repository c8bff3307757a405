"""7x7 depthwise convolution, SAME, no bias, channels-last.

Port of ``image_classification_tpu/ops/dwconv.py:depthwise_conv7x7``
(forward only). ``x`` is ``(B, H, W, C)`` and ``w`` is ``(7, 7, C)``; ``w`` is
cast to ``x``'s dtype first, taps accumulate in f32, and the result is stored
in ``x``'s dtype, as in the Pallas kernel. The conv bias is added by the
caller (``models/convnext.py``), as in ``models/layers.py:PallasDWConv``.

On a CPU tensor :func:`depthwise_conv7x7` runs :func:`depthwise_conv7x7_reference`;
on a CUDA tensor it launches the hand-written kernel ``csrc/dwconv7x7.cu``
(see the note at its top), or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

K = 7


def depthwise_conv7x7_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: an f32 grouped conv, rounded to x's dtype."""
    c = x.shape[-1]
    wf = w.to(x.dtype).float().permute(2, 0, 1).unsqueeze(1)     # (C, 1, 7, 7)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), wf, padding=K // 2, groups=c)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def depthwise_conv7x7(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return depthwise_conv7x7_reference(x, w)
    from image_classification_tpu_torch.ops import _build

    if x.dim() != 4 or tuple(w.shape) != (K, K, x.shape[-1]):
        raise ValueError(f"depthwise_conv7x7: x {tuple(x.shape)} needs "
                         f"(B,H,W,C), w {tuple(w.shape)} needs (7,7,C)")
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"depthwise_conv7x7: unsupported dtype {x.dtype}")
    w = w.to(x.dtype).contiguous()
    _build.require_cuda("depthwise_conv7x7", x, w)
    B, H, W, C = x.shape
    if B > 65535 or -(-C // 32) > 65535:
        raise ValueError(f"depthwise_conv7x7: grid too large for {tuple(x.shape)}")
    y = torch.empty_like(x)
    if y.numel():
        with torch.cuda.device(x.device):
            code = _build.library().ic_dwconv7x7_fwd(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), B, H, W, C,
                _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x))
        _build.check(code, "depthwise_conv7x7")
        depthwise_conv7x7.launches += 1
    return y


depthwise_conv7x7.launches = 0
