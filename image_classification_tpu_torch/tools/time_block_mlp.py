"""Device times of the block tail's bf16 kernels (forward and backward) and
of the composed route the model takes above ``MAX_FUSED_C``.

    python image_classification_tpu_torch/tools/time_block_mlp.py [--rows fwd,bwd,composed] [--out FILE]

Times (``utils/profiler.py:device_ms``: 20 calls queued behind a spin
kernel, between CUDA events), each on the same seeded bf16 inputs:

* ``block_mlp_fwd`` for inference (``save=False``) at the predict slice's
  shapes (256 view images at 260 px: ConvNeXt-B's M = 1081600 / 278784 /
  73984 rows at C = 128 / 256 / 512), beside its bound: the larger of its
  bytes, 6 M C + 16 C^2, at 3.35 TB/s and its 16 M C^2 FLOP at 989 TFLOP/s;
* ``block_mlp_fwd`` for training (``save=True``, which also writes a and u:
  10 M C bytes more) and ``block_mlp_bwd`` (16 M C + 48 C^2 bytes, 32 M C^2
  FLOP) at the shapes one train microbatch of 16 images gives them:
  ConvNeXt-B's M = 67600 / 17424 / 4624 at C = 128 / 256 / 512 and
  ConvNeXt-L's 67600 / 17424 at 192 / 384;
* where the checkout has the entries, each product alone on the GEMM core,
  with its TFLOP/s: the forward's fc1 and fc2 with their epilogues
  (``ic_block_mlp_fc_bf16``), the backward's four with an f32 epilogue
  (``ic_block_mlp_gemm``);
* the composed route of ``models/convnext.py`` (LayerNorm, ``torch.matmul``,
  ``ops.gelu``, ``torch.matmul``, layer scale and residual) at every forward
  shape above, and at the widths past ``MAX_FUSED_C``: ConvNeXt-L's stage 2
  (M = 4624, C = 768) and ConvNeXt-B's stage 3 (M = 1296 and 20736, C =
  1024), the yardstick for that cutoff.

The wrappers timed are those of whichever ``image_classification_tpu_torch``
Python imports, so an earlier checkout is timed with ``PYTHONPATH=<checkout>
python <this file>``; the timer is always this checkout's. To compare two
checkouts, run them in turns in one call on the card (earlier, this, this,
earlier). ``--rows`` keeps some kinds of row (default all three). Needs one
CUDA card and ``nvcc``; prints one JSON line a row and, with ``--out``,
writes them as JSON lines.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

PREDICT_SHAPES = ((1081600, 128), (278784, 256), (73984, 512))
TRAIN_SHAPES = {"convnext_base": ((67600, 128), (17424, 256), (4624, 512)),
                "convnext_large": ((67600, 192), (17424, 384))}
WIDE_SHAPES = ((4624, 768), (1296, 1024), (20736, 1024))
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


def bound_ms(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS) * 1e3


def randn(gen, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


def block_inputs(gen, m: int, c: int):
    """x, res and the block's parameters from a seed (layer scale 0.5 + noise,
    so y does not hide in the residual)."""
    f32 = dict(dtype=torch.float32)
    return (randn(gen, m, c), randn(gen, m, c), 1 + 0.1 * randn(gen, c, **f32),
            0.1 * randn(gen, c, **f32), randn(gen, 4 * c, c, scale=c ** -0.5),
            0.1 * randn(gen, 4 * c, **f32), randn(gen, c, 4 * c, scale=(4 * c) ** -0.5),
            0.1 * randn(gen, c, **f32), 0.5 + 0.1 * randn(gen, c, **f32))


def composed(x, res, s, t, w1, b1, w2, b2, g):
    """The block tail as ``models/convnext.py`` composes it above
    ``MAX_FUSED_C``."""
    from image_classification_tpu_torch.models.layers import layer_norm
    from image_classification_tpu_torch.ops import gelu

    dt = x.dtype
    h = layer_norm(x, s, t, 1e-6)
    h = gelu(torch.matmul(h, w1.to(dt).t()) + b1.to(dt))
    h = (torch.matmul(h, w2.to(dt).t()) + b2.to(dt)) * g.to(dt)
    return res + h


def composed_ms_of(args) -> float:
    return device_ms(lambda: composed(*args))


def composed_ms(gen, m: int, c: int) -> float:
    return composed_ms_of(block_inputs(gen, m, c))


def time_fc(lib, gen, m: int, c: int, save: bool) -> dict:
    """fc1 and fc2 alone on the GEMM core with their epilogues: (ms, TFLOP/s)."""
    stream = torch.cuda.current_stream().cuda_stream
    xhat, res, h = randn(gen, m, c), randn(gen, m, c), randn(gen, m, 4 * c)
    w1 = randn(gen, 4 * c, c, scale=c ** -0.5)
    w2 = randn(gen, c, 4 * c, scale=(4 * c) ** -0.5)
    b1, b2, g = randn(gen, 4 * c), randn(gen, c), randn(gen, c)
    h_out, y = torch.empty_like(h), torch.empty_like(res)
    a = torch.empty_like(h) if save else None
    u = torch.empty_like(res) if save else None
    out = {}
    # (name, which, A, W, bias, res, gamma, out, aux, N, K)
    for name, which, A, W, bias, r, gm, o, aux, n, k in (
            ("fc1", 1, xhat, w1, b1, None, None, h_out, a, 4 * c, c),
            ("fc2", 2, h, w2, b2, res, g, y, u, c, 4 * c)):
        def launch(which=which, A=A, W=W, bias=bias, r=r, gm=gm, o=o, aux=aux, n=n, k=k):
            code = lib.ic_block_mlp_fc_bf16(
                which, A.data_ptr(), W.data_ptr(), bias.data_ptr(),
                None if r is None else r.data_ptr(), None if gm is None else gm.data_ptr(),
                o.data_ptr(), None if aux is None else aux.data_ptr(), m, n, k, stream)
            if code:
                raise RuntimeError(f"GEMM core {name}: CUDA error {code}")
        ms = device_ms(launch)
        out[name] = {"ms": ms, "tflops": 2 * m * n * k / ms / 1e9}
    return out


def time_products(lib, gen, m: int, c: int) -> dict:
    """Each of the backward's four products alone on the GEMM core with an f32
    epilogue: (ms, TFLOP/s)."""
    du, xhat, da, h = randn(gen, m, c), randn(gen, m, c), randn(gen, m, 4 * c), randn(gen, m, 4 * c)
    w1, w2 = randn(gen, 4 * c, c), randn(gen, c, 4 * c)
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


def fwd_row(lib, gen, model: str, m: int, c: int, save: bool) -> dict:
    from image_classification_tpu_torch.ops import block_mlp_fwd

    args = block_inputs(gen, m, c)
    ms = device_ms(lambda: block_mlp_fwd(*args, 1e-6, save=save))
    bound = bound_ms((16 if save else 6) * m * c + 16 * c * c, 16 * m * c * c)
    row = {"what": "fwd", "variant": "training" if save else "inference",
           "model": model, "M": m, "C": c, "ms": ms, "bound_ms": bound,
           "share_of_bound": bound / ms,
           "composed_ms": composed_ms_of(args)}
    if hasattr(lib, "ic_block_mlp_fc_bf16"):
        row["products"] = time_fc(lib, gen, m, c, save)
    return row


def bwd_row(lib, gen, model: str, m: int, c: int) -> dict:
    from image_classification_tpu_torch.ops import block_mlp_bwd, block_mlp_fwd

    x, res, *params = block_inputs(gen, m, c)
    _, a, u = block_mlp_fwd(x, res, *params, 1e-6, save=True)
    bwd_args = (x, a, u, *params, randn(gen, m, c))
    ms = device_ms(lambda: block_mlp_bwd(*bwd_args))
    bound = bound_ms(16 * m * c + 48 * c * c, 32 * m * c * c)
    row = {"what": "bwd", "model": model, "M": m, "C": c, "ms": ms, "bound_ms": bound,
           "share_of_bound": bound / ms}
    if hasattr(lib, "ic_block_mlp_gemm"):
        row["products"] = time_products(lib, gen, m, c)
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="write the rows as JSON lines here")
    parser.add_argument("--rows", default="fwd,bwd,composed",
                        help="kinds of row to time, comma-separated")
    args = parser.parse_args()
    kinds = set(args.rows.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("time_block_mlp: needs a CUDA card")
    import image_classification_tpu_torch
    from image_classification_tpu_torch.ops import _build

    name = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"package {Path(image_classification_tpu_torch.__file__).parent}; "
          f"{name}; device time a call, mean of 20", flush=True)
    lib = _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    jobs = [("fwd", lambda m=m, c=c: fwd_row(lib, gen, "convnext_base", m, c, False))
            for m, c in PREDICT_SHAPES]
    for model, shapes in TRAIN_SHAPES.items():
        for m, c in shapes:
            jobs.append(("fwd", lambda model=model, m=m, c=c:
                         fwd_row(lib, gen, model, m, c, True)))
            jobs.append(("bwd", lambda model=model, m=m, c=c: bwd_row(lib, gen, model, m, c)))
    for m, c in WIDE_SHAPES:
        jobs.append(("composed", lambda m=m, c=c: {
            "what": "composed", "M": m, "C": c, "composed_ms": composed_ms(gen, m, c)}))
    jobs = [job for kind, job in jobs if kind in kinds]
    rows = []
    for job in jobs:
        row = job()
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps({**row, "card": name}) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
