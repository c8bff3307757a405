"""The port's backward kernels (their plain versions, which the wrappers run
on a CPU tensor) against the JAX package's VJPs on the same numpy inputs, in
f32 and in bf16, and against torch.autograd through the plain forwards.
The JAX Pallas kernels run in interpret mode, as the JAX tests run them.

Tolerances:
- f32: both sides compute in f32 with sums in another order. Element
  gradients (GELU, dx) agree to ~10 f32 ulps; reductions over rows (weight
  and affine gradients, up to a few hundred terms here) to ~1e-5 of their
  largest element.
- bf16: the port rounds where the Pallas kernels round, so what remains is
  f32 summation order, which can move a bf16 rounding by one unit in the
  last place (2^-8 relative); a flipped rounding of an intermediate that
  feeds a sum (du, da) moves the sum by about that much of one term.
- against torch.autograd (f32): the kernels' GELU gradient uses the exact
  Gaussian pdf where autograd differentiates the A&S erf polynomial, whose
  slope differs from the pdf by up to ~1e-6; elsewhere the two are the
  same function, differentiated in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_classification_tpu.ops.block_mlp import block_mlp as jax_block_mlp
from image_classification_tpu.ops import dwconv as jax_dwconv_mod
from image_classification_tpu.ops.dwconv import depthwise_conv7x7 as jax_dwconv
from image_classification_tpu.ops.gelu import gelu_erf_free_pallas
from image_classification_tpu_torch.ops import (
    KERNEL_WRAPPERS,
    block_mlp,
    block_mlp_bwd_reference,
    block_mlp_fwd_reference,
    block_mlp_reference,
    depthwise_conv7x7,
    depthwise_conv7x7_bwd,
    depthwise_conv7x7_bwd_reference,
    depthwise_conv7x7_reference,
    depthwise_conv7x7_wgrad,
    depthwise_conv7x7_wgrad_reference,
    gelu,
    gelu_grad_reference,
    gelu_reference,
)

from image_classification_tpu_torch.ops import dwconv as dwconv_mod

from test_torch_ops import _block_inputs
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse, module scope)

BF16_REL = 2.0 ** -7   # one bf16 ulp of the largest element, with margin


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _close(ours, ref, rel, name=""):
    ours = ours.detach().float().numpy() if isinstance(ours, torch.Tensor) else ours
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * scale, err_msg=name)


@pytest.fixture(autouse=True)
def _interpret_kernels(monkeypatch):
    monkeypatch.setenv("IC_TPU_BLOCKMLP_INTERPRET", "1")
    monkeypatch.setenv("IC_TPU_GELU_INTERPRET", "1")


# ------------------------------------------------------------------- GELU
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_bwd_matches_jax_pallas_vjp(dtype):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(12, 256)) * 3).astype(np.float32)
    x[0, :5] = [0.0, -0.0, 1e-8, -30.0, 30.0]
    dy = rng.normal(size=x.shape).astype(np.float32)
    jdt = jnp.dtype(dtype)
    xj, dyj = jnp.asarray(x).astype(jdt), jnp.asarray(dy).astype(jdt)
    _, vjp = jax.vjp(gelu_erf_free_pallas, xj)
    ref = _np(vjp(dyj)[0])
    tdt = getattr(torch, dtype)
    xt = _t(_np(xj), tdt).requires_grad_()
    ours = torch.autograd.grad(gelu(xt), xt, _t(_np(dyj), tdt))[0]
    assert ours.dtype == tdt
    _close(gelu_grad_reference(xt.detach(), _t(_np(dyj), tdt)), ref,
           1e-6 if dtype == "float32" else BF16_REL)
    _close(ours, ref, 1e-6 if dtype == "float32" else BF16_REL)


def test_gelu_bwd_matches_autograd_of_plain_forward():
    x = torch.from_numpy((np.random.default_rng(6).normal(size=(64, 96)) * 4)
                         .astype(np.float32)).requires_grad_()
    dy = torch.randn(64, 96, generator=torch.Generator().manual_seed(0))
    auto = torch.autograd.grad(gelu_reference(x), x, dy)[0]
    ours = gelu_grad_reference(x.detach(), dy)
    np.testing.assert_allclose(ours.numpy(), auto.numpy(), rtol=0,
                               atol=4e-6 * float(dy.abs().max()))


# ------------------------------------------------------------------ dwconv
@pytest.mark.parametrize("shape", [(2, 9, 9, 16), (3, 11, 7, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dwconv_bwd_matches_jax_pallas_vjp(shape, dtype):
    """``w`` is an f32 parameter cast to the working dtype before the op, so
    in bf16 ``dw`` comes back rounded to bf16 and upcast (``_dwconv_bwd``)."""
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(7, 7, shape[-1])) * 0.2).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    jdt = jnp.dtype(dtype)
    xj, gj = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    _, vjp = jax.vjp(lambda a, b: jax_dwconv(a, b, interpret=True), xj,
                     jnp.asarray(w))
    rdx, rdw = (_np(v) for v in vjp(gj))
    tdt = getattr(torch, dtype)
    xt = _t(_np(xj), tdt).requires_grad_()
    wt = _t(w).requires_grad_()
    dx, dw = torch.autograd.grad(depthwise_conv7x7(xt, wt), (xt, wt),
                                 _t(_np(gj), tdt))
    assert dx.dtype == tdt and dw.dtype == torch.float32
    if dtype == "bfloat16":  # dw was rounded to bf16 before the upcast
        assert torch.equal(dw, dw.bfloat16().float())
    rel = 1e-5 if dtype == "float32" else BF16_REL
    _close(dx, rdx, rel, "dx")
    _close(dw, rdw, rel, "dw")


# (2, 9, 11, 40), then the chip check's edge shapes: V2's stage 0 at 60x80
# input, maps smaller than the kernel, an odd small map, and a map wider than
# the wgrad kernel's 65-column strip
@pytest.mark.parametrize("shape", [(2, 9, 11, 40), (2, 15, 20, 128), (2, 3, 5, 40),
                                   (2, 1, 1, 40), (3, 13, 17, 40), (1, 9, 70, 40)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dwconv_wgrad_matches_jax_wgrad_pallas(dtype, shape):
    """The wgrad-only plain version against ``_wgrad_pallas`` (interpret
    mode), summed in f32 in another order. In bf16 the port rounds each
    product to bf16, as the kernel multiplies its bf16 tiles, while XLA on
    the CPU keeps the interpret-mode products in f32: the sums then differ
    by ~2^-9 of a product per term, at random signs, which BF16_REL bounds;
    the same sums over unrounded products agree to f32 noise."""
    rng = np.random.default_rng(23)
    jdt = jnp.dtype(dtype)
    x = jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(jdt)
    g = jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(jdt)
    ref = _np(jax_dwconv_mod._wgrad_pallas(x, g, interpret=True))
    tdt = getattr(torch, dtype)
    xt, gt = _t(_np(x), tdt), _t(_np(g), tdt)
    for fn in (depthwise_conv7x7_wgrad, depthwise_conv7x7_wgrad_reference):
        dw = fn(xt, gt)
        assert dw.shape == (7, 7, shape[-1]) and dw.dtype == torch.float32
        _close(dw, ref, 1e-5 if dtype == "float32" else BF16_REL, fn.__name__)
    _close(depthwise_conv7x7_wgrad_reference(xt.float(), gt.float()), ref, 1e-5,
           "f32 products")


@pytest.mark.parametrize("hwc", [
    (65, 65, 128),    # ConvNeXt-B stage 0 at 260 px: the JAX package fuses
    (66, 66, 128),    # ConvNeXt-B stage 0 at 264 px: it splits
    (65, 65, 192),    # ConvNeXt-L stage 0 at 260 px: it splits
    (33, 33, 384),    # ConvNeXt-L stage 1 at 260 px: it fuses
])
def test_dwconv_bwd_takes_the_split_route(hwc, monkeypatch):
    """At every shape, where ``_bwd_pallas`` fuses and where it splits, the
    port runs the forward on g with the flipped filter and the wgrad-only
    kernel."""
    calls = []
    monkeypatch.setattr(dwconv_mod, "_dwconv_forward", lambda *a: calls.append("forward"))
    monkeypatch.setattr(dwconv_mod, "depthwise_conv7x7_wgrad", lambda *a: calls.append("wgrad"))
    x = torch.empty(1, *hwc)
    dwconv_mod.depthwise_conv7x7_bwd(x, torch.empty_like(x), torch.empty(7, 7, hwc[2]))
    assert calls == ["forward", "wgrad"]


def _split_route_against_bwd_pallas(shape, seed):
    rng = np.random.default_rng(seed)
    x, g = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    w = (rng.normal(size=(7, 7, shape[-1])) * 0.2).astype(np.float32)
    rdx, rdw = (_np(v) for v in jax_dwconv_mod._bwd_pallas(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(w), interpret=True))
    dx, dw = depthwise_conv7x7_bwd(_t(x), _t(g), _t(w))
    _close(dx, rdx, 1e-5, "dx")
    _close(dw, rdw, 1e-5, "dw")


def test_dwconv_bwd_split_route_matches_jax_bwd_pallas():
    """At 1x17x17x1536 (10,972 * 1536 = 16,852,992 B: ``_bwd_pallas``
    splits too) the port's backward against ``_bwd_pallas`` (interpret
    mode), in f32."""
    shape = (1, 17, 17, 1536)
    assert jax_dwconv_mod._bwd_bytes_per_image(*shape[1:]) > jax_dwconv_mod._VMEM_BUDGET
    _split_route_against_bwd_pallas(shape, seed=29)


def test_dwconv_bwd_split_route_matches_jax_fused_bwd_pallas():
    """At 1x9x9x40, where ``_bwd_pallas`` runs its fused kernel, the port's
    split route against it (interpret mode), in f32."""
    shape = (1, 9, 9, 40)
    assert jax_dwconv_mod._bwd_bytes_per_image(*shape[1:]) <= jax_dwconv_mod._VMEM_BUDGET
    _split_route_against_bwd_pallas(shape, seed=31)


def test_dwconv_bwd_matches_autograd_of_plain_forward():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(2, 10, 13, 20)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(7, 7, 20)) * 0.2).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 10, 13, 20)).astype(np.float32))
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    auto = torch.autograd.grad(depthwise_conv7x7_reference(xa, wa), (xa, wa), g)
    for ours, ref in zip(depthwise_conv7x7_bwd_reference(x, g, w), auto):
        _close(ours, ref.numpy(), 1e-5)


# -------------------------------------------------------------- block tail
NAMES = ("dx", "dres", "ds", "dt", "dw1", "db1", "dw2", "db2", "dg")
ORDER = ("x", "res", "s", "t", "w1", "b1", "w2", "b2", "g")


def _jax_block_vjp(a, dy, dtype, tm=32):
    jdt = jnp.dtype(dtype)
    args = [jnp.asarray(a[k]).astype(jdt) if k in ("x", "res") else jnp.asarray(a[k])
            for k in ORDER]
    y, vjp = jax.vjp(lambda *v: jax_block_mlp(*v, 1e-6, tm, True), *args)
    dyj = jnp.asarray(dy).astype(jdt)
    return _np(y), [_np(v) for v in vjp(dyj)], args, dyj


def _port_block_grads(args, dyj, dtype):
    tdt = getattr(torch, dtype)
    t = [_t(_np(v), tdt if k in ("x", "res") else torch.float32).requires_grad_()
         for k, v in zip(ORDER, args)]
    # the port keeps nn.Linear's (out, in) weight layout
    w1 = t[4].detach().t().contiguous().requires_grad_()
    w2 = t[6].detach().t().contiguous().requires_grad_()
    leaves = [t[0], t[1], t[2], t[3], w1, t[5], w2, t[7], t[8]]
    y = block_mlp(*leaves)
    grads = list(torch.autograd.grad(y, leaves, _t(_np(dyj), tdt)))
    grads[4], grads[6] = grads[4].t(), grads[6].t()   # back to flax layout
    return y, grads, leaves


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_mlp_bwd_matches_jax_pallas_vjp(dtype):
    """M = 50 is not a multiple of the tile (32): the JAX kernel pads to 64
    rows, and the padded rows must add nothing to any column sum."""
    m, c = 50, 32
    a = _block_inputs(m, c, seed=11)
    dy = np.random.default_rng(12).normal(size=(m, c)).astype(np.float32)
    ref_y, ref, args, dyj = _jax_block_vjp(a, dy, dtype)
    y, ours, _ = _port_block_grads(args, dyj, dtype)
    tdt = getattr(torch, dtype)
    assert ours[0].dtype == ours[1].dtype == tdt
    assert all(g.dtype == torch.float32 for g in ours[2:])
    rel = 1e-5 if dtype == "float32" else BF16_REL
    _close(y, ref_y, rel, "y")
    for name, o, r in zip(NAMES, ours, ref):
        assert o.shape == r.shape, name
        # The f32 gradients of the bf16 run are sums of products of values
        # both sides rounded alike (measured: dx bit-equal, the sums within
        # 2.2e-7 of their largest element), so they are held to f32 noise;
        # a flipped rounding of du or da would move a sum by ~2^-8 of one of
        # its 50 terms, ~1e-4, and fail.
        _close(o, r, rel if name in ("dx", "dres") else 1e-5, name)


@pytest.mark.parametrize("m,c", [(64, 32), (50, 40), (130, 24)])
def test_block_mlp_train_forward_saves_the_pallas_residuals(m, c):
    """The training forward returns what ``_block_mlp_fwd`` saves: ``a`` (fc1
    output before GELU) and ``u`` (fc2 output), rounded to the working
    dtype; the forward's ``h`` is GELU of the unrounded ``a``. Rows and
    widths the kernels tile unevenly: 50 and 130 rows against the JAX
    kernel's 32-row tiles (it saves a and u padded) and the card's 128-row
    tiles; C = 40 and 24 against the 64-column TMA boxes."""
    from image_classification_tpu.ops.block_mlp import _block_mlp_fwd

    a = _block_inputs(m, c, seed=4 + m + c)
    args = [jnp.asarray(a[k]).astype(jnp.bfloat16) if k in ("x", "res")
            else jnp.asarray(a[k]) for k in ORDER]
    y, saved = _block_mlp_fwd(*args, 1e-6, 32, True)
    t = [_t(_np(v), torch.bfloat16 if k in ("x", "res") else torch.float32)
         for k, v in zip(ORDER, args)]
    t[4], t[6] = t[4].t(), t[6].t()
    oy, oa, ou = block_mlp_fwd_reference(*t)
    assert oy.dtype == oa.dtype == ou.dtype == torch.bfloat16
    assert oa.shape == (m, 4 * c) and ou.shape == (m, c)
    for name, o, r in (("y", oy, y), ("a", oa, saved[1][:m]), ("u", ou, saved[2][:m])):
        _close(o, _np(r), BF16_REL, name)
    assert torch.equal(oy, block_mlp_reference(*t))


def test_block_mlp_bwd_matches_autograd_of_plain_forward():
    a = {k: torch.from_numpy(v) for k, v in _block_inputs(40, 24, seed=8).items()}
    a["w1"], a["w2"] = a["w1"].t().contiguous(), a["w2"].t().contiguous()
    dy = torch.randn(40, 24, generator=torch.Generator().manual_seed(1))
    leaves = [a[k].clone().requires_grad_() for k in ORDER]
    auto = torch.autograd.grad(block_mlp_reference(*leaves), leaves, dy)
    _, sa, su = block_mlp_fwd_reference(*(a[k] for k in ORDER))
    ours = block_mlp_bwd_reference(a["x"], sa, su, *(a[k] for k in ORDER[2:]), dy)
    for name, o, r in zip(NAMES, ours, auto):
        _close(o, r.numpy(), 2e-5, name)


def test_backward_wrappers_take_the_plain_path_on_cpu():
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    x = torch.randn(2, 9, 9, 16, requires_grad=True)
    w = torch.randn(7, 7, 16, requires_grad=True)
    y = depthwise_conv7x7(x, w)
    rows = y.reshape(-1, 16)
    p = [torch.randn(*s, requires_grad=True) for s in
         ((16,), (16,), (64, 16), (64,), (16, 64), (16,), (16,))]
    out = gelu(block_mlp(rows, rows, *p))
    out.sum().backward()
    assert all(v.grad is not None for v in (x, w, *p))
    assert [fn.launches for fn in KERNEL_WRAPPERS] == [0] * len(KERNEL_WRAPPERS)
