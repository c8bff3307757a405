"""Guards on the port's kernel bindings that need no card: every C entry in
``csrc/`` has its ctypes signature and every signature its entry, the
warp's path is chosen in one Python function and passed to the kernel as
chosen, and GELU on a CPU tensor is its plain version without a build or
Triton."""

import importlib
import re
import sys
from contextlib import nullcontext

import pytest
import torch

from image_classification_tpu_torch.ops import _build, gelu, gelu_bwd
from image_classification_tpu_torch.ops import warp as warp_fn
from image_classification_tpu_torch.ops.gelu import gelu_grad_reference, gelu_reference
from image_classification_tpu_torch.ops.warp import (
    MAX_CHANNELS,
    STAGE_MAX_BYTES,
    STAGE_MIN_RATIO,
    warp_reference,
    warp_staged,
)

gelu_mod = importlib.import_module("image_classification_tpu_torch.ops.gelu")

# C parameter and return types -> their ctypes in _build._SIGNATURES
_CTYPES = {"void*": _build._P, "int": _build._I, "int64_t": _build._I64,
           "float": _build._F}
_ENTRY = re.compile(r'extern "C"\s+(int64_t|int)\s+(ic_\w+)\s*\(([^)]*)\)')


def _c_entries() -> dict:
    """name -> ([argument ctypes], return ctype) of every ``extern "C"``
    entry in csrc/ that returns an int or an int64_t, read from the text."""
    out = {}
    for src in sorted(_build.CSRC_DIR.glob("*.cu")):
        for ret, name, args in _ENTRY.findall(src.read_text()):
            types = []
            for arg in args.split(","):
                decl = " ".join(arg.replace("const ", "").split()[:-1])
                decl += "*" * arg.count("*")
                types.append(_CTYPES["void*" if "*" in decl else decl.replace("*", "")])
            assert name not in out, f"{name} defined twice"
            out[name] = (types, _CTYPES[ret])
    return out


def test_every_c_entry_has_its_signature_and_every_signature_its_entry():
    entries = _c_entries()
    assert {"ic_gelu_fwd", "ic_warp", "ic_dwconv7x7_fwd"} <= set(entries)
    assert set(entries) == set(_build._SIGNATURES)
    for name, (argtypes, restype) in _build._SIGNATURES.items():
        assert entries[name] == (argtypes, restype), name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_warp_path_choice(dtype):
    """Staged where the padded 60x80 source fits and the batch's output
    pays for copying it (V3.1: 128 x 224²), gathered at the other shipped
    shapes (V4: 32 x 260², the V2 ensemble: 64 x 224², V2: 64 x 60x80) and
    from RandAugment's 224x224 source; the size limit and the ratio exactly
    where the function states them."""
    for c in range(1, MAX_CHANNELS + 1):
        assert warp_staged(60, 80, c, dtype, 128 * 224 * 224)
        for out_pixels in (32 * 260 * 260, 64 * 224 * 224, 64 * 60 * 80):
            assert not warp_staged(60, 80, c, dtype, out_pixels)
        assert not warp_staged(224, 224, c, dtype, 2 ** 40)
    ratio = STAGE_MIN_RATIO * 60 * 80
    assert warp_staged(60, 80, 3, dtype, ratio) and not warp_staged(60, 80, 3, dtype, ratio - 1)
    texel = MAX_CHANNELS * dtype.itemsize
    pixels = STAGE_MAX_BYTES // texel
    assert pixels * texel == STAGE_MAX_BYTES
    assert warp_staged(1, pixels, 3, dtype, 2 ** 40) and warp_staged(pixels, 1, 3, dtype, 2 ** 40)
    assert not warp_staged(1, pixels + 1, 3, dtype, 2 ** 40)
    h = pixels // 128
    assert warp_staged(h, 128, 3, dtype, 2 ** 40) and not warp_staged(h, 129, 3, dtype, 2 ** 40)
    with pytest.raises(ValueError):
        warp_staged(60, 80, MAX_CHANNELS + 1, dtype, 2 ** 40)


class _FakeLibrary:
    """Records the kernel entries' arguments; launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def fake_card(monkeypatch):
    """Meta tensors take the wrappers' card path, with the library faked."""
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: nullcontext())
    return lib


@pytest.mark.parametrize("h,w,ho,wo,dtype,staged", [
    (6, 8, 200, 150, torch.bfloat16, 1), (6, 8, 200, 150, torch.float32, 1),
    (6, 8, 7, 9, torch.bfloat16, 0), (224, 224, 70, 80, torch.bfloat16, 0)])
def test_warp_passes_the_choice_to_the_kernel(fake_card, h, w, ho, wo, dtype, staged):
    warp_fn.launches = 0
    img = torch.empty(2, h, w, 3, dtype=dtype, device="meta")
    coords = torch.empty(2, ho, wo, 2, device="meta")
    out = warp_fn(img, coords)
    assert out.shape == (2, ho, wo, 3) and out.dtype == dtype
    [(name, args)] = fake_card.calls
    assert name == "ic_warp"
    assert args[3:10] == (2, h, w, 3, ho * wo, _build.DTYPE_CODES[dtype], staged)
    assert staged == warp_staged(h, w, 3, dtype, 2 * ho * wo)
    assert warp_fn.launches == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gelu_launches_the_cuda_forward(fake_card, dtype):
    gelu.launches = 0
    x = torch.empty(5, 13, dtype=dtype, device="meta")
    assert gelu(x).shape == (5, 13)
    assert fake_card.calls == [("ic_gelu_fwd", (0, 0, 65, _build.DTYPE_CODES[dtype], 0))]
    assert gelu.launches == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gelu_on_cpu_is_the_plain_version_without_a_build_or_triton(monkeypatch, dtype):
    def must_not_run(*args, **kwargs):
        raise AssertionError("the CPU path reached a kernel")

    monkeypatch.setattr(_build, "library", must_not_run)
    monkeypatch.setattr(_build, "build", must_not_run)
    monkeypatch.setattr(gelu_mod, "_triton_bwd_kernel", must_not_run)
    monkeypatch.setitem(sys.modules, "triton", None)     # an import would raise
    gelu.launches = gelu_bwd.launches = 0
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(7, 9, 33, generator=g) * 3.0).to(dtype)
    assert torch.equal(gelu(x), gelu_reference(x))
    flat = x.reshape(-1)[1:]                             # an offset view
    assert torch.equal(gelu(flat), gelu_reference(flat))
    xg = x.clone().requires_grad_(True)
    dy = torch.randn(7, 9, 33, generator=g).to(dtype)
    gelu(xg).backward(dy)
    assert torch.equal(xg.grad, gelu_grad_reference(x, dy))
    assert gelu.launches == gelu_bwd.launches == 0


def test_warp_on_cpu_is_the_plain_version_without_a_build(monkeypatch):
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("built on the CPU path"))
    g = torch.Generator().manual_seed(1)
    img = torch.rand(3, 13, 17, 3, generator=g) * 255
    coords = torch.rand(3, 11, 19, 2, generator=g) * 40 - 10
    warp_fn.launches = 0
    assert torch.equal(warp_fn(img, coords), warp_reference(img, coords))
    assert warp_fn.launches == 0
