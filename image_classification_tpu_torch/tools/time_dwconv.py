"""Device times of the 7x7 depthwise kernels at the shapes the port runs.

    python image_classification_tpu_torch/tools/time_dwconv.py [--variants] [--out FILE]

Times (``utils/profiler.py:device_ms``: 20 calls queued behind a spin
kernel, between CUDA events) the forward wrapper ``depthwise_conv7x7`` at
every stage of ConvNeXt-B and ConvNeXt-L at 260 px and batches 16 (a train
microbatch), 32, 64 (an eval batch), 128 and 256 (a predict batch: 64 images
x 4 TTA views), and the backward at every stage of both models at the
train microbatch of 16 (``time_backward``: the split route, the wgrad-only
kernel alone and, in a checkout that still has it, the fused kernel);
cuDNN's call beside each, on the same bf16 inputs. The wrappers timed are those of whichever
``image_classification_tpu_torch`` Python imports, so the script also times
an earlier checkout: ``PYTHONPATH=<checkout> python <this file>``; the timer
is always this checkout's.

``--variants`` also builds, from this checkout's
``csrc/dwconv7x7_fwd_wgrad.cu``, a separate library that launches the
forward with a given thread width TW (5 or 9 output columns a thread) and
number of column groups a block, times each launch shape at every forward
shape, and requires each to give the wrapper's bits; ``wide_warps`` is the
warp count by which the port's wrapper picks its launch (``FWD_WIDE_WARPS``).

Needs one CUDA card and ``nvcc``; prints one line a shape and, with
``--out``, writes them as JSON lines.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ITERS = 20
MAPS = (65, 33, 17, 9)                       # stages 0-3 at 260 px
MODELS = {"convnext_base": (128, 256, 512, 1024),
          "convnext_large": (192, 384, 768, 1536)}
BATCHES = (16, 32, 64, 128, 256)
TRAIN_BATCH = 16                             # the train microbatch

VARIANT_SRC = r"""
#include "dwconv7x7_fwd_wgrad.cu"

extern "C" long long ic_fwd_wide_warps(int B, int W, int C) {
  return fwd_wide_warps(B, W, C);
}

extern "C" int ic_fwd_max_groups(int tw) { return fwd_max_groups(tw); }

extern "C" int ic_fwd_variant(const void* x, const void* w, void* y, int B,
                              int H, int W, int C, int tw, int ng, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tw) {
    case 5: return launch_fwd_tw<__nv_bfloat16, 5>(x, w, y, B, H, W, C, ng, st);
    case 9: return launch_fwd_tw<__nv_bfloat16, 9>(x, w, y, B, H, W, C, ng, st);
    default: return cudaErrorInvalidValue;
  }
}
"""


def _timer():
    """This checkout's ``utils/profiler.py:device_ms``, loaded by path (it
    needs only torch), whichever package the wrappers come from."""
    path = Path(__file__).resolve().parents[1] / "utils" / "profiler.py"
    spec = importlib.util.spec_from_file_location("_ic_timer", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module          # for its dataclasses
    spec.loader.exec_module(module)
    return module.device_ms


device_ms = _timer()


def variant_library() -> ctypes.CDLL:
    """Builds (once per source hash) and loads the launch-shape library."""
    from image_classification_tpu_torch.ops import _build

    src = _build.CSRC_DIR / "dwconv7x7_fwd_wgrad.cu"
    digest = hashlib.sha256(VARIANT_SRC.encode() + src.read_bytes()
                            + (_build.CSRC_DIR / "common.cuh").read_bytes())
    so = _build.BUILD_DIR / f"libic_fwd_variants_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            cu = Path(tmp) / "fwd_variants.cu"
            cu.write_text(VARIANT_SRC)
            out = Path(tmp) / "lib.so"
            subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                            str(_build.CSRC_DIR), "-shared", "-o", str(out),
                            str(cu)], check=True, capture_output=True, text=True)
            out.replace(so)
    lib = ctypes.CDLL(str(so))
    lib.ic_fwd_wide_warps.argtypes = [ctypes.c_int] * 3
    lib.ic_fwd_wide_warps.restype = ctypes.c_longlong
    lib.ic_fwd_max_groups.argtypes = [ctypes.c_int]
    lib.ic_fwd_max_groups.restype = ctypes.c_int
    lib.ic_fwd_variant.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.ic_fwd_variant.restype = ctypes.c_int
    return lib


def launch_shapes(lib, W: int) -> list[tuple[int, int]]:
    """(columns a thread, column groups a block) to time at map width W:
    1, 2 and 4 groups, and as many as cover W in one strip (within the
    registers' limit), for each compiled width."""
    out = []
    for tw in (5, 9):
        full = min(-(-W // tw), lib.ic_fwd_max_groups(tw))
        out += [(tw, ng) for ng in sorted({1, 2, 4, full}) if ng <= full]
    return out


def cudnn_forward(x, w):
    xc = x.permute(0, 3, 1, 2)                 # NHWC storage = channels_last
    wc = w.permute(2, 0, 1).unsqueeze(1).contiguous()
    return lambda: torch.nn.functional.conv2d(xc, wc, padding=3, groups=x.shape[-1])


def cudnn_bwd(x, g, w, with_dx: bool):
    """cuDNN's backward on channels-last views: dw, and dx too if asked."""
    xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    wc = w.permute(2, 0, 1).unsqueeze(1).contiguous()
    return lambda: torch.ops.aten.convolution_backward(
        gc, xc, wc, None, [1, 1], [3, 3], [1, 1], False, [0, 0], x.shape[-1],
        [with_dx, True, False])


def time_forward(lib, gen) -> list[dict]:
    from image_classification_tpu_torch.ops.dwconv import depthwise_conv7x7

    rows = []
    for model, dims in MODELS.items():
        for hw, c in zip(MAPS, dims):
            w = (torch.randn(7, 7, c, generator=gen, device="cuda") * 0.15).to(torch.bfloat16)
            for b in BATCHES:
                x = torch.randn(b, hw, hw, c, generator=gen,
                                device="cuda").to(torch.bfloat16)
                row = {"what": "forward", "model": model, "shape": [b, hw, hw, c],
                       "wrapper_ms": device_ms(lambda: depthwise_conv7x7(x, w)),
                       "cudnn_ms": device_ms(cudnn_forward(x, w))}
                if lib is not None:
                    want = depthwise_conv7x7(x, w)
                    row["variants_ms"] = {}
                    for tw, ng in launch_shapes(lib, hw):
                        y = torch.empty_like(x)

                        def launch(y=y, tw=tw, ng=ng):
                            code = lib.ic_fwd_variant(
                                x.data_ptr(), w.data_ptr(), y.data_ptr(), b, hw, hw,
                                c, tw, ng, torch.cuda.current_stream().cuda_stream)
                            if code:
                                raise RuntimeError(f"TW={tw} x {ng}: CUDA error {code}")
                        row["variants_ms"][f"{tw}x{ng}"] = device_ms(launch)
                        if not torch.equal(y, want):
                            raise RuntimeError(f"TW={tw} x {ng} differs from the "
                                               f"wrapper at {row['shape']}")
                    row["wide_warps"] = lib.ic_fwd_wide_warps(b, hw, c)
                rows.append(row)
                print(json.dumps(row), flush=True)
                del x
    return rows


def bf16_ulps(a, b) -> int:
    """Largest distance between two bf16 tensors in units in the last place."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max().item())


def time_backward(gen) -> list[dict]:
    """The depthwise backward (dx and dw) at every stage of both models at
    the train microbatch: the split route (the forward stencil on g with the
    flipped filter, then the wgrad-only kernel), the wrapper
    ``depthwise_conv7x7_bwd`` as the checkout routes it, the fused kernel
    where the checkout still has one (``fused_bwd``; then also how far the
    split route's dx and dw lie from its), the wgrad alone, and cuDNN's
    ``aten.convolution_backward`` for both gradients and for dw alone."""
    from image_classification_tpu_torch.ops import dwconv

    fused = getattr(dwconv, "fused_bwd", None)
    rows = []
    for model, dims in MODELS.items():
        for hw, c in zip(MAPS, dims):
            shape = (TRAIN_BATCH, hw, hw, c)
            x, g = (torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
                    for _ in range(2))
            w = (torch.randn(7, 7, c, generator=gen, device="cuda")
                 * 0.15).to(torch.bfloat16)
            wf = w.flip(0, 1).contiguous()

            def split():
                return (dwconv._dwconv_forward(g, wf),
                        dwconv.depthwise_conv7x7_wgrad(x, g))
            row = {"what": "backward", "model": model, "shape": list(shape),
                   "split_route_ms": device_ms(split),
                   "wrapper_ms": device_ms(lambda: dwconv.depthwise_conv7x7_bwd(x, g, w)),
                   "wgrad_ms": device_ms(lambda: dwconv.depthwise_conv7x7_wgrad(x, g)),
                   "cudnn_ms": device_ms(cudnn_bwd(x, g, w, True)),
                   "cudnn_wgrad_ms": device_ms(cudnn_bwd(x, g, w, False))}
            if fused is not None:
                row["fused_bwd_ms"] = device_ms(lambda: fused(x, g, w))
                (sdx, sdw), (fdx, fdw) = split(), fused(x, g, w)
                row["split_vs_fused_dx_ulps"] = bf16_ulps(sdx, fdx)
                row["split_vs_fused_dw_max_rel"] = (
                    (sdw - fdw).abs().max() / fdw.abs().max()).item()
            rows.append(row)
            print(json.dumps(row), flush=True)
            del x, g
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", action="store_true",
                        help="also time each launch shape of the forward")
    parser.add_argument("--out", help="write the rows as JSON lines here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_dwconv: needs a CUDA card")
    import image_classification_tpu_torch

    name = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"package {Path(image_classification_tpu_torch.__file__).parent}; "
          f"{name}; device time a call, mean of {ITERS}", flush=True)
    lib = variant_library() if args.variants else None
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = time_forward(lib, gen) + time_backward(gen)
    if args.out:
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps({**row, "card": name}) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
