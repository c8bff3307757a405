"""Device times of the GELU forward and the aug's warp at the shapes the port
runs, beside their library calls and, with ``--variants``, beside launch
variants of this checkout's CUDA sources.

    python image_classification_tpu_torch/tools/time_gelu_warp.py [--variants] [--out FILE]

Times (``utils/profiler.py:device_ms``: 20 calls queued behind a spin
kernel, between CUDA events), on seeded bf16 inputs:

* ``gelu`` (the forward wrapper) at every (rows, 4 C) its callers give it:
  ConvNeXt-B's stage 3 at the predict batch (256 x 9 x 9 rows), at a train
  microbatch (16 x 9 x 9) and at V2's 60x80 (64 x 2 x 3); ConvNeXt-L's
  stages 2 and 3 at a microbatch; the V2 ensemble's ConvNeXt-B stage 3 at
  224 (64 x 7 x 7) and ViT-B's MLP (64 x 197); ``F.gelu`` beside each;
* ``warp`` at each launch shape of the aug: V4's 60x80 -> 260x260 (batch
  32), V2's 60x80 -> 60x80 (batch 64; the geometric warp and RandAugment's
  affine slots), the V2 ensemble's 60x80 -> 224x224 and its RandAugment
  slots on the 224x224 result (batch 64), V3.1's 60x80 -> 224x224 (batch
  128); the coordinates are the port's own draws with every geometric
  probability 1; ``F.grid_sample`` (reflection, ``align_corners=True``,
  which is reflect-101) beside each;
* with ``--variants``: the GELU forward built from this checkout's
  ``csrc/gelu.cu`` with 1, 2 or 4 16-byte loads a thread an iteration, on as
  many blocks as are resident at once or on as many as cover the array in
  one grid-stride pass, with and without the evict-first hints, and with
  the IEEE-rounded reciprocal (``__frcp_rn``) in place of ``rcp.approx``;
  the warp built from ``csrc/warp.cu`` on each path (staged wherever the
  source fits, whatever ``warp_staged`` picks) with 1, 2 or 4 output pixels
  a thread, its staged blocks by the kernel's rule (about one wave), 4 or
  16 an image, or one pass of 256 threads each. Each warp variant must give
  the wrapper's bits; each GELU variant's distance from the wrapper is
  printed in bf16 ulps. A warp row also names the path the wrapper took.

The wrappers timed are those of whichever ``image_classification_tpu_torch``
Python imports, so an earlier checkout is timed with ``PYTHONPATH=<checkout>
python <this file>`` (without ``--variants``); the timer, the shapes and the
variants' sources are always this checkout's, and its helpers its own (not
``chip_smoke.py``'s, which need this checkout's package). To compare two
checkouts, run them in turns in one call on the card (earlier, this, this,
earlier). Needs
one CUDA card and ``nvcc``; prints one JSON line a row and, with ``--out``,
writes them as JSON lines.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

CHECKOUT = Path(__file__).resolve().parents[2]
CSRC = CHECKOUT / "image_classification_tpu_torch" / "csrc"
HBM_BYTES_PER_S = 3.35e12
# (rows, columns) of the GELU forward's callers
GELU_SHAPES = ((20736, 4096), (1296, 4096), (384, 4096), (4624, 3072),
               (1296, 6144), (3136, 4096), (12608, 3072))
NATIVE = (60, 80)
# (what, config, overrides, batch, source): source "native" is a 60x80
# image through the geometric warp; "slot" is RandAugment's affine slot on
# the geometric warp's output
WARP_SHAPES = (
    ("V4", "v4.json", (), 32, "native"),
    ("V2", "v2_convbase.json", (), 64, "native"),
    ("V2 RandAugment", "v2_convbase.json", (), 64, "slot"),
    ("V2 ensemble", "v2_convbase.json", ("image_size=[224,224]",), 64, "native"),
    ("V2 ensemble RandAugment", "v2_convbase.json", ("image_size=[224,224]",), 64, "slot"),
    ("V3.1", "v3_1.json", (), 128, "native"),
)
GEOMETRY_ALL_ONES = dict(hflip_prob=1.0, vflip_prob=1.0, ssr_prob=1.0,
                         distortion_prob=1.0)

GELU_VARIANT_SRC = r"""
#include "gelu.cu"

template <int U, bool S, bool E>
int v(const void* x, void* y, int64_t n, int blocks, cudaStream_t st) {
  return launch_gelu_fwd<__nv_bfloat16, U, S, E>(x, y, n, blocks, st);
}

extern "C" int ic_gelu_variant(const void* x, void* y, int64_t n, int unroll,
                               int blocks, int stream_hint, int exact,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int key = unroll * 4 + stream_hint * 2 + exact;
  switch (key) {
    case 1 * 4 + 2: return v<1, true, false>(x, y, n, blocks, st);
    case 1 * 4 + 0: return v<1, false, false>(x, y, n, blocks, st);
    case 1 * 4 + 3: return v<1, true, true>(x, y, n, blocks, st);
    case 2 * 4 + 2: return v<2, true, false>(x, y, n, blocks, st);
    case 4 * 4 + 2: return v<4, true, false>(x, y, n, blocks, st);
    case 4 * 4 + 0: return v<4, false, false>(x, y, n, blocks, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int ic_gelu_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}
"""

WARP_VARIANT_SRC = r"""
#include "warp.cu"

extern "C" int ic_warp_variant(const void* img, const void* coords, void* out,
                               int B, int H, int W, int C, int P, int staged,
                               int pix, int spans, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pix) {
    case 1:
      return launch_path<__nv_bfloat16, 1, 1>(img, coords, out, B, H, W, C, P, staged,
                                           spans, st);
    case 2:
      return launch_path<__nv_bfloat16, 2, 2>(img, coords, out, B, H, W, C, P, staged,
                                           spans, st);
    case 4:
      return launch_path<__nv_bfloat16, 4, 4>(img, coords, out, B, H, W, C, P, staged,
                                           spans, st);
    default:
      return cudaErrorInvalidValue;
  }
}
"""

# (name, unroll, blocks: 0 as many as are resident at once (the kernel's),
# k > 0 k an SM, -1 one grid-stride pass (as many blocks as cover the
# vectors with `unroll` a thread), hint, exact reciprocal)
GELU_VARIANTS = (("U1 resident, hints", 1, 0, 1, 0), ("U1 resident, no hints", 1, 0, 0, 0),
                 ("U1 one pass, hints", 1, -1, 1, 0), ("U1 one pass, no hints", 1, -1, 0, 0),
                 ("U2 one pass, hints", 2, -1, 1, 0), ("U4 resident, hints", 4, 0, 1, 0),
                 ("U4 resident, no hints", 4, 0, 0, 0),
                 ("U1 one pass, hints, exact rcp", 1, -1, 1, 1),
                 ("U1 resident, hints, exact rcp", 1, 0, 1, 1))
# (pixels a thread, blocks an image: 0 the kernel's rule, 2 ** 30 one pass
# of a block each); staged blocks also at 4 and 16 an image
WARP_VARIANTS = {0: [(n, 0) for n in (1, 2, 4)],
                 1: [(n, s) for n in (1, 2, 4) for s in (0, 4, 16, 2 ** 30)]}


def _load(name: str, rel: str):
    """A module of this checkout, loaded by path, whichever package the
    wrappers come from."""
    path = CHECKOUT / "image_classification_tpu_torch" / rel
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module          # for its dataclasses
    spec.loader.exec_module(module)
    return module


device_ms = _load("_ic_timer", "utils/profiler.py").device_ms


def variant_library(src: str, stem: str) -> ctypes.CDLL:
    """``src`` (which includes a source of this checkout's ``csrc/``) built
    into its own library, once per hash of the sources."""
    from image_classification_tpu_torch.ops import _build

    digest = hashlib.sha256(src.encode())
    for p in sorted(CSRC.glob("*.cu*")):
        digest.update(p.read_bytes())
    so = _build.BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            cu = Path(tmp) / f"{stem}.cu"
            cu.write_text(src)
            out = Path(tmp) / "lib.so"
            proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC),
                                   "-shared", "-o", str(out), str(cu)],
                                  capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {stem}:\n{proc.stdout}{proc.stderr}")
            out.replace(so)
    return ctypes.CDLL(str(so))


def bf16_ulps(a, b) -> int:
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max().item())


def time_gelu(gen, lib) -> list[dict]:
    from image_classification_tpu_torch.ops import gelu

    rows = []
    for shape in GELU_SHAPES:
        x = (torch.randn(*shape, generator=gen, device="cuda") * 3.0).to(torch.bfloat16)
        n = x.numel()
        row = {"what": "gelu", "shape": list(shape),
               "kernel_ms": device_ms(lambda: gelu(x)),
               "library_ms": device_ms(lambda: torch.nn.functional.gelu(x)),
               "bound_ms": 4 * n / HBM_BYTES_PER_S * 1e3}
        if lib is not None:
            want, row["variants_ms"], row["variants_ulps"] = gelu(x), {}, {}
            sms = lib.ic_gelu_sms()
            for name, unroll, per_sm, hint, exact in GELU_VARIANTS:
                y = torch.empty_like(x)
                one_pass = -(-n // (8 * 256 * unroll))
                blocks = {0: 0, -1: one_pass}.get(per_sm, per_sm * sms)

                def launch(y=y, unroll=unroll, blocks=blocks, hint=hint, exact=exact):
                    code = lib.ic_gelu_variant(x.data_ptr(), y.data_ptr(), n, unroll,
                                               blocks, hint, exact,
                                               torch.cuda.current_stream().cuda_stream)
                    if code:
                        raise RuntimeError(f"gelu variant {name}: CUDA error {code}")
                row["variants_ms"][name] = device_ms(launch)
                row["variants_ulps"][name] = bf16_ulps(y, want)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del x
    return rows


def geometric_coords(gen, config: str, over, batch: int):
    """(batch, Ho, Wo, 2) source coordinates of the geometric warp, drawn
    with every geometric probability 1, and the output size."""
    from image_classification_tpu_torch.aug.geometry import draw_geometry, source_coords
    from image_classification_tpu_torch.aug.pipeline import aug_configs_from
    from image_classification_tpu_torch.core.config import load_config

    cfg = load_config(str(CHECKOUT / "configs" / config), list(over))
    cfg = cfg.replace(**GEOMETRY_ALL_ONES)
    g = aug_configs_from(cfg)["geometry"]
    out_hw = tuple(cfg.image_size)
    return source_coords(draw_geometry(gen, batch, out_hw, g), NATIVE, out_hw, g), out_hw


def randaug_coords(gen, batch: int, hw):
    """(batch, H, W, 2) source coordinates of one RandAugment slot on an
    (H, W) image, its op, magnitude and sign drawn as the aug draws them
    (about a third of the ops are geometric; the rest sample the grid):
    ``aug/randaug.py:affine_warp``'s, written out here, as an earlier
    checkout has no ``affine_coords``."""
    from image_classification_tpu_torch.aug.geometry import output_grid
    from image_classification_tpu_torch.aug.randaug import (
        RandAugmentCfg,
        draw_rand_augment,
        slot_matrix,
    )

    d = draw_rand_augment(gen, batch, RandAugmentCfg())
    frac = d.mags[:, 0] / 10.0
    m = slot_matrix(d.op_ids[:, 0], torch.where(d.signs[:, 0], frac, -frac), hw)
    m = m[..., None, None]
    grid = output_grid(*hw, device=m.device)
    x, y = grid[None, ..., 0], grid[None, ..., 1]
    return torch.stack([m[:, 1, 0] * x + m[:, 1, 1] * y + m[:, 1, 2],
                        m[:, 0, 0] * x + m[:, 0, 1] * y + m[:, 0, 2]], dim=-1)


def grid_sample_reflect(img, coords):
    """``F.grid_sample`` reflecting about the edge pixels' centres
    (``align_corners=True``: reflect-101) on an NCHW view."""
    B, H, W, C = img.shape
    grid = torch.stack([coords[..., 1] / (W - 1) * 2 - 1,
                        coords[..., 0] / (H - 1) * 2 - 1], dim=-1).to(img.dtype)
    nchw = img.permute(0, 3, 1, 2)
    return lambda: torch.nn.functional.grid_sample(
        nchw, grid, mode="bilinear", padding_mode="reflection", align_corners=True)


def warp_inputs(gen, config, over, batch, source):
    """The bf16 image and the coordinates of one launch shape."""
    coords, out_hw = geometric_coords(gen, config, over, batch)
    hw = NATIVE
    if source == "slot":
        coords, hw = randaug_coords(gen, batch, out_hw), out_hw
    img = (torch.rand(batch, *hw, 3, generator=gen, device="cuda") * 255).to(torch.bfloat16)
    return img, coords.contiguous()


def time_warp(gen, lib) -> list[dict]:
    from image_classification_tpu_torch.ops import warp

    rows = []
    for what, config, over, batch, source in WARP_SHAPES:
        img, coords = warp_inputs(gen, config, over, batch, source)
        B, H, W, C = img.shape
        P = coords.shape[1] * coords.shape[2]
        nbytes = img.numel() * 2 + coords.numel() * 4 + B * P * C * 2
        row = {"what": "warp", "cell": what, "image": list(img.shape),
               "coords": list(coords.shape),
               "kernel_ms": device_ms(lambda: warp(img, coords)),
               "library_ms": device_ms(grid_sample_reflect(img, coords)),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        chooser = getattr(sys.modules[warp.__module__], "warp_staged", None)
        if chooser is not None:
            row["path"] = "staged" if chooser(H, W, C, img.dtype, B * P) else "gather"
        if lib is not None:
            from image_classification_tpu_torch.ops.warp import MAX_CHANNELS, STAGE_MAX_BYTES

            want, row["variants_ms"] = warp(img, coords), {}
            fits = H * W * MAX_CHANNELS * img.element_size() <= STAGE_MAX_BYTES
            for staged in (0, 1) if fits else (0,):
                for pix, spans in WARP_VARIANTS[staged]:
                    out = torch.empty_like(want)

                    def launch(out=out, staged=staged, pix=pix, spans=spans):
                        code = lib.ic_warp_variant(
                            img.data_ptr(), coords.data_ptr(), out.data_ptr(), B, H, W,
                            C, P, staged, pix, spans,
                            torch.cuda.current_stream().cuda_stream)
                        if code:
                            raise RuntimeError(f"warp variant: CUDA error {code}")
                    blocks = {0: "the kernel's blocks", 2 ** 30: "a pass a block"}.get(
                        spans, f"{spans} blocks an image")
                    name = f"{'staged' if staged else 'gather'}, {pix} px a thread, {blocks}"
                    row["variants_ms"][name] = device_ms(launch)
                    if not torch.equal(out, want):
                        raise RuntimeError(f"warp {name} differs from the wrapper at {what}")
        rows.append(row)
        print(json.dumps(row), flush=True)
        del img, coords
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", action="store_true",
                        help="also time launch variants of this checkout's sources")
    parser.add_argument("--out", help="write the rows as JSON lines here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_gelu_warp: needs a CUDA card")
    import image_classification_tpu_torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    package = str(Path(image_classification_tpu_torch.__file__).parent)
    print(f"package {package}; {card}; device time a call, mean of 20", flush=True)
    glib = wlib = None
    if args.variants:
        glib = variant_library(GELU_VARIANT_SRC, "ic_gelu_variants")
        glib.ic_gelu_variant.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int64]
                                         + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        glib.ic_gelu_variant.restype = ctypes.c_int
        wlib = variant_library(WARP_VARIANT_SRC, "ic_warp_variants")
        wlib.ic_warp_variant.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                                         + [ctypes.c_void_p])  # ..., staged, pix, spans
        wlib.ic_warp_variant.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = time_gelu(gen, glib) + time_warp(gen, wlib)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps({**row, "package": package, "card": card}) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
