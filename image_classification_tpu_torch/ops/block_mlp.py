"""Fused ConvNeXt block tail, forward and backward:
``y = res + g * fc2(GELU_erf(fc1(LN(x))))`` over rows of ``(M, C)``.

Port of ``image_classification_tpu/ops/block_mlp.py:block_mlp`` and its
custom VJP. ``x`` is the dwconv output that feeds the LayerNorm and ``res``
the block's input. Weights keep ``nn.Linear``'s ``(out, in)`` layout:
``w1 (4C, C)``, ``w2 (C, 4C)``. As in the Pallas kernels, every parameter is
first cast to ``x``'s dtype; LN statistics (biased variance as
``E[x^2] - mean^2``, eps inside the rsqrt), bias, GELU and ``res + g * u`` run
in f32; the LN output is rounded to the working dtype before fc1, and ``h``
before fc2.

For training the forward also returns what ``_block_mlp_fwd`` saves: ``a``
(fc1 output before GELU) and ``u`` (fc2 output), rounded to the working
dtype. The backward (``_bwd_kernel``) returns the nine gradients
``(dx, dres, ds, dt, dw1, db1, dw2, db2, dg)``: ``dres = dy``; ``dx`` in
``x``'s dtype; the others in f32, each in its parameter's dtype. Its rounding
points: ``du = dy * g`` and ``da = (du @ w2) * gelu'(a)`` are rounded before
they feed a product, ``h = GELU(a_saved)`` is rounded, the column sums
``db1 = sum(da)``, ``db2 = sum(du)`` take the unrounded values, and
``dg = sum(dy * u_saved)`` the saved (rounded) ``u``.

:func:`block_mlp` is the op the model calls; when autograd records it, it
runs as :class:`_BlockMlpFunction`. On a CPU tensor both directions run their
plain versions (:func:`block_mlp_fwd_reference`,
:func:`block_mlp_bwd_reference`); on a CUDA tensor they launch hand-written
kernels, or raise. In bf16 both directions run on one GEMM core on wgmma fed
by TMA (``csrc/wgmma_gemm.cuh``) with row passes and fused epilogues around
it: the forward in ``csrc/block_mlp.cu``, the backward in
``csrc/block_mlp_bwd.cu``. In f32 both run the FMA path of
``csrc/block_mlp.cu`` (see the notes at the sources' tops).
"""

from __future__ import annotations

import torch

from image_classification_tpu_torch.ops.gelu import gelu_f32, gelu_grad_f32

# The JAX package's cutoff (ops/block_mlp.py:block_mlp_available): ConvNeXt
# stages 0-2 take the fused tail, stage 3 (C = 1024 for ConvNeXt-B) the
# unfused one. It was measured on a TPU; deciding it again on the H100 is
# ROADMAP item D.4.
MAX_FUSED_C = 512


def block_mlp_available(c: int) -> bool:
    return c <= MAX_FUSED_C


def _ln_rows(x, s, t, eps):
    """(z, r, xhat in f32) with the kernels' f32 statistics; s, t already in
    f32 after the cast to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    r = torch.rsqrt(var.clamp_min(0.0) + eps)
    z = (xf - mu) * r
    return z, r, z * s + t


def block_mlp_fwd_reference(x, res, s, t, w1, b1, w2, b2, g, eps: float = 1e-6):
    """Plain PyTorch version of the training forward: ``(y, a, u)``, with the
    kernel's rounding points."""
    dt = x.dtype
    f = lambda v: v.to(dt).float()  # noqa: E731  (param -> x dtype -> f32)
    xhat = _ln_rows(x, f(s), f(t), eps)[2].to(dt)
    a = xhat.float() @ f(w1).t() + f(b1)
    h = gelu_f32(a).to(dt)
    u = h.float() @ f(w2).t() + f(b2)
    return (f(res) + f(g) * u).to(dt), a.to(dt), u.to(dt)


def block_mlp_reference(x, res, s, t, w1, b1, w2, b2, g, eps: float = 1e-6):
    """Plain PyTorch version of the forward."""
    return block_mlp_fwd_reference(x, res, s, t, w1, b1, w2, b2, g, eps)[0]


def block_mlp_bwd_reference(x, a, u, s, t, w1, b1, w2, b2, g, dy,
                            eps: float = 1e-6):
    """Plain PyTorch version of the backward: the nine gradients
    ``(dx, dres, ds, dt, dw1, db1, dw2, db2, dg)``."""
    dt = x.dtype
    f = lambda v: v.to(dt).float()  # noqa: E731
    sf = f(s)
    z, r, xhat = _ln_rows(x, sf, f(t), eps)
    xhat_bf = xhat.to(dt).float()
    af = a.float()
    h_bf = gelu_f32(af).to(dt).float()
    dyf = dy.to(dt).float()
    du = dyf * f(g)
    du_bf = du.to(dt).float()
    dh = du_bf @ f(w2)
    da = dh * gelu_grad_f32(af)
    da_bf = da.to(dt).float()
    dxhat = da_bf @ f(w1)
    dz = dxhat * sf
    m1 = dz.mean(-1, keepdim=True)
    m2 = (dz * z).mean(-1, keepdim=True)
    dx = (r * (dz - m1 - z * m2)).to(dt)
    grads = ((dxhat * z).sum(0), dxhat.sum(0), da_bf.t() @ xhat_bf, da.sum(0),
             du_bf.t() @ h_bf, du.sum(0), (dyf * u.float()).sum(0))
    params = (s, t, w1, b1, w2, b2, g)
    return (dx, dy, *(v.to(p.dtype) for v, p in zip(grads, params)))


def _prepare(name, x, res, s, t, w1, b1, w2, b2, g, unused=()):
    """Checks shapes for the CUDA kernels; returns the parameters cast to
    x's dtype, contiguous (None for the names in ``unused``, which are not
    cast), and the library module."""
    from image_classification_tpu_torch.ops import _build

    dt = x.dtype
    if dt not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {dt}")
    M, C = x.shape
    H4 = w1.shape[0]
    shapes = {"res": (res, (M, C)), "s": (s, (C,)), "t": (t, (C,)),
              "w1": (w1, (H4, C)), "b1": (b1, (H4,)), "w2": (w2, (C, H4)),
              "b2": (b2, (C,)), "g": (g, (C,))}
    for key, (v, want) in shapes.items():
        if tuple(v.shape) != want:
            raise ValueError(f"{name}: {key} is {tuple(v.shape)}, "
                             f"expected {want}")
    if C > MAX_FUSED_C:
        raise ValueError(f"{name}: C={C} exceeds {MAX_FUSED_C}")
    if dt == torch.bfloat16 and (C % 8 or H4 % 8):
        raise ValueError(f"{name}: the bf16 kernel needs C % 8 == 0 and "
                         f"4C % 8 == 0 (16-byte rows), got C={C}, 4C={H4}")
    if -(-M // (128 if dt == torch.bfloat16 else 64)) > 65535:
        raise ValueError(f"{name}: M={M} rows exceed the launch grid")
    names = ("res", "s", "t", "w1", "b1", "w2", "b2", "g")
    args = [None if k in unused else v.to(dt).contiguous()
            for k, v in zip(names, (res, s, t, w1, b1, w2, b2, g))]
    _build.require_cuda(name, x, *(v for v in args if v is not None))
    return args, _build


def _aligned(name, *tensors):
    if any(v.data_ptr() % 16 for v in tensors):
        raise ValueError(f"{name}: tensors must start on 16-byte boundaries")


def block_mlp_fwd(x, res, s, t, w1, b1, w2, b2, g, eps: float = 1e-6,
                  save: bool = True):
    """The forward, ``(y, a, u)``: with ``save`` (training) ``a`` and ``u``
    are the residuals the backward needs, else ``None``."""
    if x.device.type == "cpu":
        y, a, u = block_mlp_fwd_reference(x, res, s, t, w1, b1, w2, b2, g, eps)
        return (y, a, u) if save else (y, None, None)
    args, _build = _prepare("block_mlp", x, res, s, t, w1, b1, w2, b2, g)
    dt = x.dtype
    M, C = x.shape
    H4 = w1.shape[0]
    xhat = torch.empty_like(x)
    h = torch.empty((M, H4), dtype=dt, device=x.device)
    y = torch.empty_like(x)
    a = torch.empty((M, H4), dtype=dt, device=x.device) if save else None
    u = torch.empty_like(x) if save else None
    _aligned("block_mlp", x, *args, *([a, u] if save else []))
    if M:
        res_, s_, t_, w1_, b1_, w2_, b2_, g_ = args
        with torch.cuda.device(x.device):
            code = _build.library().ic_block_mlp_fwd(
                x.data_ptr(), res_.data_ptr(), s_.data_ptr(), t_.data_ptr(),
                w1_.data_ptr(), b1_.data_ptr(), w2_.data_ptr(), b2_.data_ptr(),
                g_.data_ptr(), xhat.data_ptr(), h.data_ptr(), y.data_ptr(),
                a.data_ptr() if save else None, u.data_ptr() if save else None,
                M, C, H4, float(eps), _build.DTYPE_CODES[dt],
                _build.stream_ptr(x))
        _build.check(code, "block_mlp")
        block_mlp.launches += 1
    return y, a, u


def block_mlp_bwd(x, a, u, s, t, w1, b1, w2, b2, g, dy, eps: float = 1e-6):
    """The nine gradients ``(dx, dres, ds, dt, dw1, db1, dw2, db2, dg)`` of
    :func:`block_mlp` at ``x`` with the saved ``a``, ``u``, for ``dy``. bf16
    runs ``csrc/block_mlp_bwd.cu`` (wgmma + TMA), f32 the FMA path of
    ``csrc/block_mlp.cu``; both write every gradient outright."""
    if x.device.type == "cpu":
        return block_mlp_bwd_reference(x, a, u, s, t, w1, b1, w2, b2, g, dy, eps)
    args, _build = _prepare("block_mlp_bwd", x, u, s, t, w1, b1, w2, b2, g,
                            unused=("b1", "b2"))
    dt = x.dtype
    M, C = x.shape
    H4 = w1.shape[0]
    if M < 1:
        raise ValueError("block_mlp_bwd: needs at least one row")
    for key, v, want in (("a", a, (M, H4)), ("dy", dy, (M, C))):
        if tuple(v.shape) != want or v.dtype != dt:
            raise ValueError(f"block_mlp_bwd: {key} is {tuple(v.shape)} "
                             f"{v.dtype}, expected {want} {dt}")
    u_, s_, t_, w1_, _, w2_, _, g_ = args
    a, dy = a.contiguous(), dy.contiguous()
    _build.require_cuda("block_mlp_bwd", x, a, dy)
    lib = _build.library()
    dev = x.device
    bf16 = dt == torch.bfloat16
    xhat, du, dx = (torch.empty_like(x) for _ in range(3))
    da = torch.empty((M, H4), dtype=dt, device=dev)
    h = torch.empty((M, H4), dtype=dt, device=dev) if bf16 else None
    dxhat = torch.empty((M, C), dtype=torch.float32, device=dev)
    floats = (lib.ic_block_mlp_bwd_bf16_scratch(M, C) if bf16 else
              lib.ic_block_mlp_bwd_scratch(M, C, H4, _build.DTYPE_CODES[dt]))
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    ds, dt_, db2, dg = (torch.empty(C, **f32) for _ in range(4))
    db1 = torch.empty(H4, **f32)
    dw1 = torch.empty((H4, C), **f32)
    dw2 = torch.empty((C, H4), **f32)
    _aligned("block_mlp_bwd", x, a, dy, u_, s_, t_, w1_, w2_, g_, xhat, du, da,
             dx, *([h] if bf16 else []))
    inputs = (x, a, u_, s_, t_, w1_, w2_, g_, dy)
    outputs = (dx, ds, dt_, dw1, db1, dw2, db2, dg)
    with torch.cuda.device(dev):
        if bf16:
            err = lib.ic_block_mlp_bwd_bf16(
                *(v.data_ptr() for v in (*inputs, xhat, du, da, h, dxhat,
                                         scratch, *outputs)),
                M, C, float(eps), _build.stream_ptr(x))
        else:
            err = lib.ic_block_mlp_bwd(
                *(v.data_ptr() for v in (*inputs, xhat, du, da, dxhat, scratch,
                                         *outputs)),
                M, C, H4, float(eps), _build.DTYPE_CODES[dt],
                _build.stream_ptr(x))
    _build.check(err, "block_mlp_bwd")
    block_mlp_bwd.launches += 1
    grads = (ds, dt_, dw1, db1, dw2, db2, dg)
    params = (s, t, w1, b1, w2, b2, g)
    return (dx, dy, *(v if v.dtype == p.dtype else v.to(p.dtype)
                      for v, p in zip(grads, params)))


class _BlockMlpFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, res, s, t, w1, b1, w2, b2, g, eps):
        y, a, u = block_mlp_fwd(x, res, s, t, w1, b1, w2, b2, g, eps, save=True)
        ctx.save_for_backward(x, a, u, s, t, w1, b1, w2, b2, g)
        ctx.eps, ctx.res_dtype = eps, res.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, a, u, s, t, w1, b1, w2, b2, g = ctx.saved_tensors
        dx, dres, *grads = block_mlp_bwd(x, a, u, s, t, w1, b1, w2, b2, g,
                                         dy.contiguous(), ctx.eps)
        return (dx, dres.to(ctx.res_dtype), *grads, None)


def block_mlp(x, res, s, t, w1, b1, w2, b2, g, eps: float = 1e-6):
    """The block tail; differentiable in every tensor argument."""
    tensors = (x, res, s, t, w1, b1, w2, b2, g)
    if torch.is_grad_enabled() and any(v.requires_grad for v in tensors):
        return _BlockMlpFunction.apply(*tensors, eps)
    return block_mlp_fwd(*tensors, eps, save=False)[0]


block_mlp.launches = 0
block_mlp_bwd.launches = 0
