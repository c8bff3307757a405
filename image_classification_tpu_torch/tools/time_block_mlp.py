"""Device times of the block tail's bf16 backward at the train step's shapes.

    python image_classification_tpu_torch/tools/time_block_mlp.py [--out FILE]

Times (``utils/profiler.py:device_ms``: 20 calls queued behind a spin
kernel, between CUDA events) ``block_mlp_bwd`` at the shapes one train
microbatch of 16 images at 260 px gives it: ConvNeXt-B's M = 67600 / 17424 /
4624 rows at C = 128 / 256 / 512 and ConvNeXt-L's 67600 / 17424 at 192 /
384, on the same bf16 inputs, beside its bound (the larger of its bytes,
16 M C + 48 C^2, at 3.35 TB/s and its 32 M C^2 FLOP at 989 TFLOP/s, as
``chip_smoke.py`` counts them). Where the checkout has the GEMM core's own
entry (``ic_block_mlp_gemm``), it also times each of the backward's four
products alone at its shape and split, with an f32 epilogue, and prints its
TFLOP/s.

The wrappers timed are those of whichever ``image_classification_tpu_torch``
Python imports, so an earlier checkout is timed with ``PYTHONPATH=<checkout>
python <this file>``; the timer is always this checkout's. To compare two
checkouts, run them in turns in one call on the card (earlier, this, this,
earlier). Needs one CUDA card and ``nvcc``; prints one line a shape and,
with ``--out``, writes them as JSON lines.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

SHAPES = {"convnext_base": ((67600, 128), (17424, 256), (4624, 512)),
          "convnext_large": ((67600, 192), (17424, 384))}
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12


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


def inputs(gen, m: int, c: int):
    """The backward's inputs: the block's parameters and x from a seed, a and
    u from the training forward, dy from the seed."""
    from image_classification_tpu_torch.ops import block_mlp_fwd

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    x = randn(m, c)
    f32 = dict(dtype=torch.float32)
    params = (1 + 0.1 * randn(c, **f32), 0.1 * randn(c, **f32),
              randn(4 * c, c, scale=c ** -0.5), 0.1 * randn(4 * c, **f32),
              randn(c, 4 * c, scale=(4 * c) ** -0.5), 0.1 * randn(c, **f32),
              0.5 + 0.1 * randn(c, **f32))
    _, a, u = block_mlp_fwd(x, randn(m, c), *params, 1e-6, save=True)
    return (x, a, u, *params, randn(m, c))


def time_products(lib, gen, m: int, c: int) -> dict:
    """Each of the four products alone on the GEMM core: (ms, TFLOP/s)."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    du, xhat, da, h = randn(m, c), randn(m, c), randn(m, 4 * c), randn(m, 4 * c)
    w1, w2 = randn(4 * c, c), randn(c, 4 * c)
    out = {}
    # (name, A, B, A K-major, split over K, output rows, K)
    for name, a, b, kmajor, split, rows, k in (
            ("dh", du, w2, True, False, m, c), ("dxhat", da, w1, True, False, m, 4 * c),
            ("dW1", da, xhat, False, True, 4 * c, m), ("dW2", du, h, False, True, c, m)):
        n = b.shape[1]
        splits = lib.ic_block_mlp_gemm_splits(rows, n, k) if split else 1
        res = torch.empty(splits, rows, n, dtype=torch.float32, device="cuda")

        def launch(a=a, b=b, kmajor=kmajor, split=split, rows=rows, n=n, k=k, res=res):
            code = lib.ic_block_mlp_gemm(a.data_ptr(), b.data_ptr(), res.data_ptr(),
                                         int(kmajor), int(split), rows, n, k,
                                         torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"GEMM core {name}: CUDA error {code}")
        ms = device_ms(launch)
        out[name] = {"ms": ms, "tflops": 2 * rows * n * k / ms / 1e9, "splits": splits}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="write the rows as JSON lines here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_block_mlp: needs a CUDA card")
    import image_classification_tpu_torch
    from image_classification_tpu_torch.ops import _build, block_mlp_bwd

    name = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"package {Path(image_classification_tpu_torch.__file__).parent}; "
          f"{name}; device time a call, mean of 20", flush=True)
    lib = _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for model, shapes in SHAPES.items():
        for m, c in shapes:
            bwd_args = inputs(gen, m, c)
            ms = device_ms(lambda: block_mlp_bwd(*bwd_args))
            bound = max((16 * m * c + 48 * c * c) / HBM_BYTES_PER_S,
                        32 * m * c * c / BF16_TENSOR_FLOPS) * 1e3
            row = {"model": model, "M": m, "C": c, "bwd_ms": ms, "bound_ms": bound,
                   "share_of_bound": bound / ms}
            if hasattr(lib, "ic_block_mlp_gemm"):
                row["products"] = time_products(lib, gen, m, c)
            rows.append(row)
            print(json.dumps(row), flush=True)
            del bwd_args
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps({**row, "card": name}) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
