"""On-card smoke test of the PyTorch port: builds its kernels, holds each one
against its plain PyTorch version at the shapes of the predict slice, then
runs the slice itself (``cli predict``: 2 fold models of ConvNeXt-B with deep
supervision, 44 classes, 260x260, bf16, scale4 TTA) and checks it against
the same slice run through the plain versions in f32.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and Triton; imports no JAX. It
exits non-zero, before printing any result, when there is no card or any
phase fails. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from image_classification_tpu_torch import cli
from image_classification_tpu_torch.core.config import load_config
from image_classification_tpu_torch.data import (
    ArraySource,
    DataLoader,
    Manifest,
    SequentialSampler,
)
from image_classification_tpu_torch.data.source import decode_cache_key
from image_classification_tpu_torch.infer import predict_ensemble
from image_classification_tpu_torch.models.convnext import CONVNEXT_CONFIGS
from image_classification_tpu_torch.models.factory import create_model
from image_classification_tpu_torch.ops import (
    _build,
    block_mlp,
    block_mlp_available,
    block_mlp_reference,
    depthwise_conv7x7,
    depthwise_conv7x7_reference,
    gelu,
    gelu_reference,
)

REPO = os.path.dirname(os.path.abspath(__file__))
MODEL = "convnext_base"
IMAGE = 260
VIEWS_BATCH = 256        # 64 images (batch_size 32 x infer_batch_multiplier 2) x 4 views
N_IMAGES = 100           # 2 batches of 64; the second is padded and masked
# The f32 plain reference runs on the host CPU (the wrappers' path for CPU
# tensors) at ~0.65 s per view-forward, so it scores the first N_REF images.
N_REF = 16
NATIVE = (60, 80)
FOLD_SEEDS = (0, 1)
# Stage sizes at 260 px: 65, 33, 17, 9 (flax SAME padding on odd sizes).
STAGE_HW = (65, 33, 17, 9)
DEPTHS, DIMS = CONVNEXT_CONFIGS[MODEL]

# Tolerances, kernel vs plain version on identical bf16 inputs.
# dwconv, GELU: both compute in f32 and round once to bf16; the f32 results
# differ only in summation order / instruction choice (~1e-7 relative), which
# can move a rounding by at most one bf16 ulp.
ULP_TOL = 1
# block tail: two GEMMs with K up to 2048 whose f32 sums run in another order,
# and h is rounded to bf16 between them, so a one-ulp flip in h (2^-8
# relative) reaches y through fc2; bound the error by 2% of max |y|.
BLOCK_REL_TOL = 2e-2
# Slice: bf16 kernels vs f32 plain versions end to end. bf16 keeps 8 bits, so
# each of the 36 residual blocks adds ~0.4% relative noise to its output and
# the logits move by a few 1e-2. The first full run on an H100 measured
# max |d prob| = 6.5e-4 over 100 images; the bound is 3x that. Argmax must
# agree wherever the plain top-2 margin exceeds 2 * PROB_TOL.
PROB_TOL = 2e-3


class SmokeFailure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    """A check that stays under ``python -O``, unlike ``assert``."""
    if not ok:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def time_ms(fn, iters: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` launches, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp_distance(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 units in the last place between a and b."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max().item())


def randn(gen, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


def block_tail_inputs(gen, m, c, dtype):
    return (
        randn(gen, m, c, dtype=dtype), randn(gen, m, c, dtype=dtype),
        1 + 0.1 * randn(gen, c, dtype=torch.float32),
        0.1 * randn(gen, c, dtype=torch.float32),
        randn(gen, 4 * c, c, scale=c ** -0.5, dtype=dtype),
        0.1 * randn(gen, 4 * c, dtype=torch.float32),
        randn(gen, c, 4 * c, scale=(4 * c) ** -0.5, dtype=dtype),
        0.1 * randn(gen, c, dtype=torch.float32),
        # non-trivial layer scale, or y hides in the residual
        0.5 + 0.1 * randn(gen, c, dtype=torch.float32),
    )


def check_kernels() -> list[dict]:
    """Phase 2: each kernel against its plain version on the card, at the
    slice's shapes in bf16 (timed), and at small shapes in f32."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = []

    def report(name, shape, err, ulps, ms, plain_ms):
        print(f"kernel {name} {shape}: max_abs_err={err:.6g} ulps={ulps} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)

    # f32 paths at small odd shapes: the same kernels must match to f32 noise
    x = randn(gen, 2, 9, 13, 40, dtype=torch.float32)
    w = randn(gen, 7, 7, 40, dtype=torch.float32)
    err = (depthwise_conv7x7(x, w) - depthwise_conv7x7_reference(x, w)).abs().max().item()
    require(err <= 1e-5, f"dwconv f32 err {err}")
    x = randn(gen, 37, 129, scale=3.0, dtype=torch.float32)
    err = (gelu(x) - gelu_reference(x)).abs().max().item()
    require(err <= 1e-5, f"gelu f32 err {err}")
    args = block_tail_inputs(gen, 77, 40, torch.float32)
    err = (block_mlp(*args) - block_mlp_reference(*args)).abs().max().item()
    require(err <= 1e-4, f"block tail f32 err {err}")
    print("f32 kernel paths agree with their plain versions", flush=True)

    per_forward = {"dwconv": [0.0, 0.0], "block_mlp": [0.0, 0.0], "gelu": [0.0, 0.0]}
    max_err = {k: 0.0 for k in per_forward}
    for stage, (hw, c, depth) in enumerate(zip(STAGE_HW, DIMS, DEPTHS)):
        x = randn(gen, VIEWS_BATCH, hw, hw, c)
        w = randn(gen, 7, 7, c, scale=0.15)
        y, ref = depthwise_conv7x7(x, w), depthwise_conv7x7_reference(x, w)
        ulps = bf16_ulp_distance(y, ref)
        err = (y.float() - ref.float()).abs().max().item()
        require(ulps <= ULP_TOL, f"dwconv stage {stage}: {ulps} ulps")
        ms = time_ms(lambda: depthwise_conv7x7(x, w), 10)
        pms = time_ms(lambda: depthwise_conv7x7_reference(x, w), 5)
        report("dwconv", tuple(x.shape), err, ulps, ms, pms)
        per_forward["dwconv"][0] += depth * ms
        per_forward["dwconv"][1] += depth * pms
        max_err["dwconv"] = max(max_err["dwconv"], err)
        del x, y, ref

        if block_mlp_available(c):
            m = VIEWS_BATCH * hw * hw
            args = block_tail_inputs(gen, m, c, torch.bfloat16)
            y, ref = block_mlp(*args), block_mlp_reference(*args)
            err = (y.float() - ref.float()).abs().max().item()
            bound = BLOCK_REL_TOL * ref.float().abs().max().item()
            require(err <= bound, f"block tail stage {stage}: {err} > {bound}")
            ms = time_ms(lambda: block_mlp(*args), 5)
            pms = time_ms(lambda: block_mlp_reference(*args), 2)
            report("block_mlp", (m, c), err, "-", ms, pms)
            per_forward["block_mlp"][0] += depth * ms
            per_forward["block_mlp"][1] += depth * pms
            max_err["block_mlp"] = max(max_err["block_mlp"], err)
            del args, y, ref
        else:
            x = randn(gen, VIEWS_BATCH * hw * hw, 4 * c, scale=3.0)
            y, ref = gelu(x), gelu_reference(x)
            ulps = bf16_ulp_distance(y, ref)
            err = (y.float() - ref.float()).abs().max().item()
            require(ulps <= ULP_TOL, f"gelu: {ulps} ulps")
            ms = time_ms(lambda: gelu(x), 20)
            pms = time_ms(lambda: gelu_reference(x), 5)
            report("gelu", tuple(x.shape), err, ulps, ms, pms)
            per_forward["gelu"][0] += depth * ms
            per_forward["gelu"][1] += depth * pms
            max_err["gelu"] = err
            del x, y, ref
        torch.cuda.empty_cache()

    meta = {
        "dwconv": ("cuda", "image_classification_tpu_torch/csrc/dwconv7x7.cu",
                   "image_classification_tpu/ops/dwconv.py:205"),
        "block_mlp": ("cuda", "image_classification_tpu_torch/csrc/block_mlp.cu",
                      "image_classification_tpu/ops/block_mlp.py:253"),
        "gelu": ("triton", "image_classification_tpu_torch/ops/gelu.py",
                 "image_classification_tpu/ops/gelu.py:74"),
    }
    for name, (route, source, replaces) in meta.items():
        results.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": 0,
            "max_abs_err": max_err[name],
            # summed over the blocks of one forward of 256 views
            "ms": per_forward[name][0], "plain_ms": per_forward[name][1],
        })
    return results


def synthetic_test_set(cfg) -> tuple[list[str], np.ndarray]:
    """100 uint8 60x80 images from a numpy seed (a random colour per image
    plus noise), a test CSV with zero-padded numeric ids, and the
    decoded-image cache ``cli predict`` reads."""
    rng = np.random.default_rng(0)
    colour = rng.uniform(0, 255, size=(N_IMAGES, 1, 1, 3))
    noise = rng.normal(0, 40, size=(N_IMAGES, *NATIVE, 3))
    images = np.clip(np.round(colour + noise), 0, 255).astype(np.uint8)
    ids = [f"{i:04d}" for i in range(N_IMAGES)]
    with open(cfg.test_csv, "w") as f:
        f.write("id,predict\n" + "".join(f"{i},0\n" for i in ids))
    parsed = Manifest.from_csv(cfg.test_csv, is_test=True).ids
    key = decode_cache_key(cfg.test_dir, parsed, NATIVE)
    os.makedirs(cfg.cache_dir, exist_ok=True)
    images.tofile(os.path.join(cfg.cache_dir, f"imgs_{key}.u8"))
    with open(os.path.join(cfg.cache_dir, f"imgs_{key}.json"), "w") as f:
        json.dump({"shape": list(images.shape), "complete": True}, f)
    return [str(i) for i in parsed], images


def fold_models(cfg, device) -> list[torch.nn.Module]:
    """Fold models from torch.Generator seeds, layer scale set to U(0.3, 0.7)
    instead of its 1e-6 init so every block changes its input."""
    models = []
    for seed in FOLD_SEEDS:
        gen = torch.Generator().manual_seed(seed)
        model = create_model(cfg, generator=gen).module
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith(".gamma"):
                    p.copy_(0.3 + 0.4 * torch.rand(p.shape, generator=gen))
        models.append(model.to(device))
    return models


def run_slice(kernels: list[dict]) -> dict:
    """Phase 3: the predict slice on the card, then its f32 plain reference."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return _run_slice(kernels, tmp)


def _run_slice(kernels: list[dict], tmp: str) -> dict:
    cfg = load_config(os.path.join(REPO, "configs", "v4.json"), [
        f"test_csv={tmp}/test.csv", f"test_dir={tmp}/test",
        f"cache_dir={tmp}/cache", f"model_save_path={tmp}/models",
        f"submission_path={tmp}/submission.csv",
    ])
    require(cfg.batch_size * cfg.infer_batch_multiplier == 64,
            "configs/v4.json no longer predicts in batches of 64")
    ids, images = synthetic_test_set(cfg)
    models = fold_models(cfg, "cpu")
    os.makedirs(cfg.model_save_path)
    for fold, model in enumerate(models, start=1):
        torch.save(model.state_dict(), cli.checkpoint_path(cfg.model_save_path, fold))

    # Main path, through the user's entry point. Counters from 0 right before.
    wrappers = {"dwconv": depthwise_conv7x7, "block_mlp": block_mlp, "gelu": gelu}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    cli.main(["predict", "--config", os.path.join(REPO, "configs", "v4.json"),
              "--folds", "1,2", f"test_csv={cfg.test_csv}",
              f"test_dir={cfg.test_dir}", f"cache_dir={cfg.cache_dir}",
              f"model_save_path={cfg.model_save_path}",
              f"submission_path={cfg.submission_path}"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    forwards = len(FOLD_SEEDS) * -(-N_IMAGES // 64)
    per_forward = {"dwconv": sum(DEPTHS), "block_mlp": sum(DEPTHS[:3]),
                   "gelu": DEPTHS[3]}
    print(f"cli predict: {cli_s:.3f} s, launches {launches}, "
          f"{forwards} forwards", flush=True)
    for k, n in per_forward.items():
        require(launches[k] == n * forwards, f"{k}: {launches[k]} launches")
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
    with open(cfg.submission_path) as f:
        csv_rows = f.read().splitlines()
    require(csv_rows[0] == "id,predict" and len(csv_rows) == N_IMAGES + 1,
            f"submission has {len(csv_rows)} lines, header {csv_rows[:1]}")

    # The same slice, timed, on models already on the card.
    gpu_models = [m.to("cuda") for m in models]
    loader = DataLoader(ArraySource(images), Manifest(np.array(ids, object),
                        np.full(N_IMAGES, -1)), batch_size=64,
                        sampler=SequentialSampler(N_IMAGES), device="cuda")
    predict_ensemble(gpu_models, loader, cfg)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got_ids, preds, probs = predict_ensemble(gpu_models, loader, cfg)
    wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    require(got_ids == ids, "ids out of order")
    require([r.split(",")[1] for r in csv_rows[1:]] == [str(p) for p in preds],
            "cli predict's submission differs from predict_ensemble")
    require(probs.shape == (N_IMAGES, cfg.num_classes), f"probs {probs.shape}")
    require(bool(np.isfinite(probs).all()), "non-finite probabilities")
    require(float(np.abs(probs.sum(1) - 1.0).max()) < 1e-4,
            "probability rows do not sum to 1")
    del gpu_models, models
    torch.cuda.empty_cache()

    # Plain reference: the same checkpoints in f32 through the plain versions
    # (the wrappers' path for CPU tensors), on the first N_REF images. Each
    # image's result does not depend on its batch.
    torch.set_num_threads(os.cpu_count() or 1)
    cfg32 = cfg.replace(compute_dtype="float32")
    ref_models = fold_models(cfg32, "cpu")
    ref_loader = DataLoader(ArraySource(images[:N_REF]), loader.manifest.subset(
        np.arange(N_REF)), batch_size=N_REF, device="cpu")
    t0 = time.perf_counter()
    _, ref_preds, ref_probs = predict_ensemble(ref_models, ref_loader, cfg32)
    ref_s = time.perf_counter() - t0
    probs, preds = probs[:N_REF], preds[:N_REF]
    delta = float(np.abs(probs - ref_probs).max())
    top2 = np.sort(ref_probs, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * PROB_TOL
    agree = int((preds == ref_preds)[decided].sum())
    print(f"slice vs f32 plain ({ref_s:.1f} s on the host): max|dprob|={delta:.6g} "
          f"(tol {PROB_TOL}), argmax {agree}/{int(decided.sum())} decided rows "
          f"agree, {int((preds == ref_preds).sum())}/{N_REF} overall",
          flush=True)
    require(delta <= PROB_TOL, f"probability delta {delta} > {PROB_TOL}")
    require(agree == int(decided.sum()), "argmax differs on a decided row")
    return {"images_per_s": N_IMAGES / wall, "wall_s": wall,
            "peak_mem_gib": peak_gib, "max_dprob": delta}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    so, build_s = _build.build()
    print(f"kernels built in {build_s:.2f} s -> {os.path.relpath(so, REPO)}",
          flush=True)

    kernels = check_kernels()
    stats = run_slice(kernels)
    print(f"slice: {stats['images_per_s']} images/s ({N_IMAGES} images x "
          f"{len(FOLD_SEEDS)} folds x 4 views in {stats['wall_s']} s), peak "
          f"memory {stats['peak_mem_gib']} GiB, on {smi}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
