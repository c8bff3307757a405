"""Fused ConvNeXt block tail, forward:
``y = res + g * fc2(GELU_erf(fc1(LN(x))))`` over rows of ``(M, C)``.

Port of ``image_classification_tpu/ops/block_mlp.py:block_mlp`` (forward
only). ``x`` is the dwconv output that feeds the LayerNorm and ``res`` the
block's input. Weights keep ``nn.Linear``'s ``(out, in)`` layout:
``w1 (4C, C)``, ``w2 (C, 4C)``. As in the Pallas kernel, every parameter is
first cast to ``x``'s dtype; LN statistics (biased variance as
``E[x^2] - mean^2``, eps inside the rsqrt), bias, GELU and ``res + g * u`` run
in f32; the LN output is rounded to the working dtype before fc1, and ``h``
before fc2.

On a CPU tensor :func:`block_mlp` runs :func:`block_mlp_reference`; on a CUDA
tensor it launches ``csrc/block_mlp.cu`` (LN rows, then two hand-written
GEMMs with fused epilogues; see the note at its top), or raises.
"""

from __future__ import annotations

import torch

from image_classification_tpu_torch.ops.gelu import gelu_f32

# The JAX package's cutoff (ops/block_mlp.py:block_mlp_available): ConvNeXt
# stages 0-2 take the fused tail, stage 3 (C = 1024 for ConvNeXt-B) the
# unfused one. It was measured on a TPU; deciding it again on the H100 is
# ROADMAP item B.1.
MAX_FUSED_C = 512


def block_mlp_available(c: int) -> bool:
    return c <= MAX_FUSED_C


def block_mlp_reference(x, res, s, t, w1, b1, w2, b2, g, eps: float = 1e-6):
    """Plain PyTorch version, with the kernel's rounding points."""
    dt = x.dtype
    f = lambda v: v.to(dt).float()  # noqa: E731  (param -> x dtype -> f32)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    r = torch.rsqrt(var.clamp_min(0.0) + eps)
    xhat = ((xf - mu) * r * f(s) + f(t)).to(dt)
    h = gelu_f32(xhat.float() @ f(w1).t() + f(b1)).to(dt)
    u = h.float() @ f(w2).t() + f(b2)
    return (f(res) + f(g) * u).to(dt)


def block_mlp(x, res, s, t, w1, b1, w2, b2, g, eps: float = 1e-6):
    if x.device.type == "cpu":
        return block_mlp_reference(x, res, s, t, w1, b1, w2, b2, g, eps)
    from image_classification_tpu_torch.ops import _build

    dt = x.dtype
    if dt not in _build.DTYPE_CODES:
        raise ValueError(f"block_mlp: unsupported dtype {dt}")
    M, C = x.shape
    H4 = w1.shape[0]
    shapes = {"res": (res, (M, C)), "s": (s, (C,)), "t": (t, (C,)),
              "w1": (w1, (H4, C)), "b1": (b1, (H4,)), "w2": (w2, (C, H4)),
              "b2": (b2, (C,)), "g": (g, (C,))}
    for name, (v, want) in shapes.items():
        if tuple(v.shape) != want:
            raise ValueError(f"block_mlp: {name} is {tuple(v.shape)}, "
                             f"expected {want}")
    if dt == torch.bfloat16 and C % 8:
        raise ValueError("block_mlp: the bf16 kernel needs C % 8 == 0 "
                         "(16-byte rows)")
    if -(-M // (128 if dt == torch.bfloat16 else 64)) > 65535:
        raise ValueError(f"block_mlp: M={M} rows exceed the launch grid")
    args = [v.to(dt).contiguous() for v in (res, s, t, w1, b1, w2, b2, g)]
    _build.require_cuda("block_mlp", x, *args)
    if any(v.data_ptr() % 16 for v in (x, *args)):
        raise ValueError("block_mlp: tensors must start on 16-byte boundaries")
    xhat = torch.empty_like(x)
    h = torch.empty((M, H4), dtype=dt, device=x.device)
    y = torch.empty_like(x)
    if M:
        res_, s_, t_, w1_, b1_, w2_, b2_, g_ = args
        with torch.cuda.device(x.device):
            code = _build.library().ic_block_mlp_fwd(
                x.data_ptr(), res_.data_ptr(), s_.data_ptr(), t_.data_ptr(),
                w1_.data_ptr(), b1_.data_ptr(), w2_.data_ptr(), b2_.data_ptr(),
                g_.data_ptr(), xhat.data_ptr(), h.data_ptr(), y.data_ptr(),
                M, C, H4, float(eps), _build.DTYPE_CODES[dt],
                _build.stream_ptr(x))
        _build.check(code, "block_mlp")
        block_mlp.launches += 1
    return y


block_mlp.launches = 0
