"""The scale-out's train steps held against one process, shared by
``chip_smoke.py`` (phase ``parallel``: two gloo ranks on one card, NCCL at
world 1, the fold-parallel entry) and ``tools/run_multicard.py`` (four cards
over NCCL), so that every one-card check runs the code the four-card run
depends on.

A job (:func:`par_job`) is one global batch of uint8 60x80 images, its labels
and one set of global draws, for a config on a mesh (data, model).
:func:`par_step` runs one train step of it on this process' rows from seeded
weights past warmup, then times more steps; :func:`par_compare` holds the
ranks' results against one process' on the same job. The bounds below are
the ones every such comparison uses, each with its reason.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np
import torch

from image_classification_tpu_torch import cli
from image_classification_tpu_torch.aug.draws import draws_to
from image_classification_tpu_torch.core.config import load_config
from image_classification_tpu_torch.models.convnext import CONVNEXT_CONFIGS
from image_classification_tpu_torch.models.factory import create_model
from image_classification_tpu_torch.models.layers import drop_path_rates, drop_sites
from image_classification_tpu_torch.models.vit import VIT_CONFIGS
from image_classification_tpu_torch.ops import (
    block_mlp,
    block_mlp_available,
    block_mlp_bwd,
    depthwise_conv7x7,
    depthwise_conv7x7_bwd,
    depthwise_conv7x7_wgrad,
    gelu,
    gelu_bwd,
    warp,
)
from image_classification_tpu_torch.train.loop import build_lr_schedule
from image_classification_tpu_torch.train.loss import build_criterion
from image_classification_tpu_torch.train.optim import build_optimizer
from image_classification_tpu_torch.train.step import draw_train_step, make_train_step
from image_classification_tpu_torch.train.train_state import create_train_state
from image_classification_tpu_torch.utils.profiler import sync

NATIVE = (60, 80)
# The schedule's horizon needs a fold size: ~2/3 of a 44-class set of ~5000
# images in batches of 32 gives ~100 optimizer steps an epoch. The state
# starts at the end of warmup, where the LR peaks, so the checked update
# moves every parameter.
STEPS_PER_EPOCH = 100
# A bf16 train step on the card against the f32 step on the host (the
# reasons and measurements: chip_smoke.py, beside GRAD_MIN_COS).
TRAIN_LOSS_REL_TOL = 1e-3
# EfficientNet's bf16 step against the f32 host step: the running
# statistics' change over the step, rel. L2 (chip_smoke.py, beside
# EFF_LOSS_REL_TOL).
EFF_STATS_REL_L2 = 0.15
PAR_TIMED_STEPS = 2       # steps each rank times after the compared one
PAR_RDZV_TIMEOUT_S = 300
# N ranks against 1 on the same global batch, weights and draws, both on
# the card in the same dtype: each rank runs its kernels on its share of
# each microbatch (other GEMM shapes, so other bf16 roundings of the same
# rows) and the gradients add in another order, so the loss keeps the
# spirit of TRAIN_LOSS_REL_TOL; the parameters and EMA, one Adam step from
# zero moments (a step of ~lr per parameter whatever its gradient, so a
# gradient near 0 can flip sign), the train step check's 4 lr; BatchNorm's
# running statistics after the step (their change over it, rel. L2 over
# every BatchNorm): in f32 the same function to f32 rounding, in bf16
# EFF_STATS_REL_L2, the bound for bf16 rounding of a B0 step. ViT-B/16 on
# mesh_model=2 (each MLP split over the 2 ranks) against 1 process: in bf16
# each rank's fc2 product is rounded before the two are summed, so the
# loss keeps TRAIN_LOSS_REL_TOL; in f32 the f32 bound.
PAR_LOSS_REL_TOL = TRAIN_LOSS_REL_TOL
PAR_F32_LOSS_REL_TOL = 1e-5
PAR_F32_STATS_REL_L2 = 1e-4
PAR_BF16_STATS_REL_L2 = EFF_STATS_REL_L2
# cli train fold_parallel=true: each fold's train loss an epoch against the
# sequential cli train of the same fold (the same process-local work where a
# fold has one rank; the loss keeps the same bound).
PAR_ENTRY_LOSS_REL_TOL = TRAIN_LOSS_REL_TOL

WRAPPERS = {"dwconv": depthwise_conv7x7, "block_mlp": block_mlp, "gelu": gelu,
            "dwconv_bwd": depthwise_conv7x7_bwd, "block_mlp_bwd": block_mlp_bwd,
            "gelu_bwd": gelu_bwd, "warp": warp,
            "dwconv_wgrad": depthwise_conv7x7_wgrad}


class CheckFailure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    """A check that stays under ``python -O``, unlike ``assert``."""
    if not ok:
        raise CheckFailure(what)


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_launches() -> dict:
    return {k: fn.launches for k, fn in WRAPPERS.items()}


def expected_launches(cfg, steps: int, forwards: int, model_size: int | None = None) -> dict:
    """Each kernel's launches in ``steps`` optimizer steps and ``forwards``
    forwards without gradient of ``cfg``'s model (:func:`model_launches`,
    ``gradient_accumulation_steps`` microbatches a step, on a model axis of
    ``model_size``); per step the aug warps once, and once more for each
    RandAugment slot."""
    want = model_launches(cfg, cfg.gradient_accumulation_steps * steps, forwards,
                          model_size)
    want["warp"] = steps * (1 + (cfg.randaugment_num_ops if cfg.use_randaugment else 0))
    return want


def model_launches(cfg, micro: int, forwards: int, model_size: int | None = None) -> dict:
    """Each kernel's launches in ``micro`` microbatches forward and backward
    and ``forwards`` forwards without gradient of ``cfg``'s model, its MLPs
    split over a model axis of ``model_size`` (``cfg.mesh_model`` where
    None). A ViT: GELU forward in every block's MLP, and its backward per
    microbatch. A ConvNeXt: per microbatch and per forward, every block's
    depthwise forward and its tail: the block tail kernel where
    ``block_mlp_available`` and the block has no drop-path, exact GELU and
    an MLP that is not split (``ConvNeXtBlock.fused``: a block whose 4C
    divides by the model axis splits, ``parallel/shardings.py``), else the
    composed route, with the GELU kernel (none with tanh GELU);
    per microbatch every block of a trained stage runs the backward of both,
    the depthwise one as the forward stencil on g (dx) plus the wgrad
    kernel (dw), and the stem and the stages under ``freeze_stages`` run
    none (nothing before them is trained). Under ``block_remat`` each such
    block's backward first runs its tail's forward again (``"dots"`` and
    ``"full"``: the block tail kernel, or the composed route's GELU), and
    under ``"full"`` its depthwise forward too. EfficientNet launches
    none."""
    want = dict.fromkeys(WRAPPERS, 0)
    base = cfg.model_name.split(".")[0]
    if base in VIT_CONFIGS:
        depth = VIT_CONFIGS[base]["depth"]
        want["gelu"], want["gelu_bwd"] = depth * (micro + forwards), depth * micro
        return want
    if base not in CONVNEXT_CONFIGS:
        return want
    depths, dims = CONVNEXT_CONFIGS[base]
    rates = drop_path_rates(cfg.drop_path_rate, depths)
    model_size = cfg.mesh_model if model_size is None else model_size
    for stage, (d, c) in enumerate(zip(depths, dims)):
        split = model_size > 1 and 4 * c % model_size == 0
        for rate in rates[stage]:
            fused = (block_mlp_available(c) and rate == 0 and not cfg.gelu_approximate
                     and not split)
            tails = (["block_mlp"] if fused else
                     [] if cfg.gelu_approximate else ["gelu"])
            for name in ["dwconv", *tails]:
                want[name] += micro + forwards
            if stage >= cfg.freeze_stages:
                recomputed = {"none": [], "dots": tails,
                              "full": ["dwconv", *tails]}[cfg.block_remat]
                for name in ("dwconv", "dwconv_bwd", "dwconv_wgrad",
                             *(f"{t}_bwd" for t in tails), *recomputed):
                    want[name] += micro
    return want


def synthetic_images(n: int, seed: int) -> np.ndarray:
    """uint8 60x80 images from a numpy seed: a random colour per image plus
    noise."""
    rng = np.random.default_rng(seed)
    colour = rng.uniform(0, 255, size=(n, 1, 1, 3))
    noise = rng.normal(0, 40, size=(n, *NATIVE, 3))
    return np.clip(np.round(colour + noise), 0, 255).astype(np.uint8)


def train_inputs(cfg, n: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 60x80 images and labels from a numpy seed, on the host."""
    labels = np.random.default_rng(seed + 1).integers(0, cfg.num_classes, n)
    return torch.from_numpy(synthetic_images(n, seed)), torch.from_numpy(labels)


def seeded_model(cfg, seed: int):
    """The configured model from a torch.Generator seed, with layer scale
    drawn from U(0.3, 0.7) instead of its 1e-6 init so every block changes
    its input."""
    gen = torch.Generator().manual_seed(seed)
    bundle = create_model(cfg, generator=gen)
    with torch.no_grad():
        for name, p in bundle.module.named_parameters():
            if name.endswith(".gamma"):
                p.copy_(0.3 + 0.4 * torch.rand(p.shape, generator=gen))
    return bundle


def train_model(cfg, device):
    bundle = seeded_model(cfg, seed=7)
    bundle.module.to(device)
    return bundle


def rel_l2(a: list[torch.Tensor], b: list[torch.Tensor]) -> float:
    num = sum(float((x.double() - y.double()).pow(2).sum()) for x, y in zip(a, b))
    den = sum(float(y.double().pow(2).sum()) for y in b)
    return (num / max(den, 1e-300)) ** 0.5


def state_digest(*parts: list[torch.Tensor]) -> str:
    """A digest of the tensors' bytes: equal digests, bit-identical states."""
    h = hashlib.sha256()
    for part in parts:
        for t in part:
            h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy())
    return h.hexdigest()


# ------------------------------------------------------------------ steps
def par_job(config: str, over: list[str], batch: int, seed: int,
            spec: tuple[int, ...] = (-1, 1), timed: int = PAR_TIMED_STEPS,
            profile: bool | None = None) -> dict:
    """One global batch of uint8 60x80 images, its labels and one set of
    global draws (made on the host), for ``config`` with ``over``, on the
    ranks' mesh ``MeshSpec(*spec)`` (data, model[, fold]), with ``timed``
    steps timed after the compared one, and ``profile`` as
    :func:`par_worker`'s ranks pass it to :func:`par_step`."""
    cfg = load_config(config, over)
    images, labels = train_inputs(cfg, batch, seed=seed)
    sites = drop_sites(seeded_model(cfg, 7).module)
    draws = draw_train_step(torch.Generator().manual_seed(seed + 1), tuple(images.shape),
                            cfg, sites)
    return {"config": config, "over": list(over), "images": images, "labels": labels,
            "draws": draws, "spec": spec, "timed": timed, "profile": profile}


def _profiled_step(step, state, batch, gen, step_ms: float | None,
                   record: bool) -> dict | None:
    """Two more steps of ``step`` (every rank takes them: they hold
    collectives), with ``record`` under torch.profiler, the second read: the
    device time of its kernels, the device's idle share against ``step_ms``
    (a step's wall in the timed run, since the profiler slows the host), the
    device time under the gradient all-reduce (``train/step.py``'s
    ``all_reduce_sum_`` of the gradients) and under the model group's sums
    (``models/layers.py:model_sum``, forward, backward and recompute), each
    annotated for these steps only."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile, record_function

    from image_classification_tpu_torch.models import layers
    from image_classification_tpu_torch.train import step as step_mod

    reduce_sum, model_sum = step_mod.all_reduce_sum_, layers.model_sum

    def annotated(tensors, group):
        with record_function("grad_all_reduce"):
            reduce_sum(tensors, group)

    def model_annotated(x, group):
        with record_function("model_all_reduce"):
            return model_sum(x, group)

    if record:
        step_mod.all_reduce_sum_, layers.model_sum = annotated, model_annotated
    device = batch["image"].device
    try:
        for _ in range(2):   # the first warms the profiler up; the second is read
            gen.manual_seed(2000)
            region = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                      if record else contextlib.nullcontext())
            with region as prof:
                step(state, batch, generator=gen)
                sync(device)
    finally:
        step_mod.all_reduce_sum_, layers.model_sum = reduce_sum, model_sum
    if not record:
        return None
    cuda = torch.autograd.DeviceType.CUDA
    ranges = ("grad_all_reduce", "model_all_reduce")
    # an annotation's range on the host holds its kernels' device time; its
    # mirror on the device side is left out of the kernels' sum
    kernels = [e for e in prof.key_averages()
               if e.device_type == cuda and e.key not in ranges]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    reduce_ms, model_ms = (sum(e.device_time_total for e in prof.key_averages()
                               if e.key == key and e.device_type != cuda) / 1e3
                           for key in ranges)
    nccl_ms = sum(e.self_device_time_total for e in kernels
                  if "nccl" in e.key.lower()) / 1e3
    idle = None if not step_ms else max(0.0, 1 - dev_ms / step_ms)
    return {"device_ms": dev_ms, "idle": idle, "grad_all_reduce_ms": reduce_ms,
            "model_all_reduce_ms": model_ms, "nccl_ms": nccl_ms}


def par_step(job: dict, mesh=None, device: str | torch.device = "cuda",
             profile: bool | None = None) -> dict:
    """One train step of ``job`` on this process' rows of its global batch
    (all of them without a mesh; a model axis splits the MLPs), from the
    seeded weights past warmup, then ``job['timed']`` more on fresh draws,
    timed, then unless ``profile`` is None two more, under torch.profiler
    where it is True (:func:`_profiled_step`; every rank of a mesh passes a
    bool). Returns the compared step's loss, accuracy, kernel launches and
    the state after it (split tensors gathered), on the host, with a digest
    of the parameters and EMA, and on the card the compared step's peak
    memory (the model, the train state and the step's own)."""
    from image_classification_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
    from image_classification_tpu_torch.parallel.shardings import gather_tree, shard_model

    device = torch.device(device)
    cfg = load_config(job["config"], job["over"])
    index, count = (0, 1) if mesh is None else (mesh.index(DATA_AXIS),
                                                 mesh.size(DATA_AXIS))
    model_size = 1 if mesh is None else mesh.size(MODEL_AXIS)
    bundle = train_model(cfg, device)
    shard_model(bundle.module, mesh)
    tx = build_optimizer(cfg, build_lr_schedule(cfg, STEPS_PER_EPOCH))
    crit = build_criterion(cfg, group=None if mesh is None else mesh.group(DATA_AXIS))
    step = make_train_step(bundle, cfg, tx, crit, mesh=mesh)
    state = create_train_state(bundle.module, use_ema=cfg.use_ema)
    state.count = state.step = int(STEPS_PER_EPOCH * cfg.epochs
                                   * cfg.gradient_accumulation_steps * cfg.warmup_ratio)
    per = job["images"].shape[0] // count
    batch = {k: job[k][index * per:(index + 1) * per].to(device)
             for k in ("images", "labels")}
    batch = {"image": batch["images"], "label": batch["labels"]}
    draws = draws_to(job["draws"], device)
    stats0 = {k: v.clone() for k, v in bundle.module.named_buffers()}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    state, m = step(state, batch, draws=draws)
    sync(device)
    launches = read_launches()
    peak = (torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda"
            else None)
    names = state.names()
    whole = gather_tree({"params": dict(zip(names, state.params())),
                         "ema": dict(zip(names, state.ema or []))}, bundle.module)
    # copies: on the CPU ``.cpu()`` would alias the state the timed steps update
    params = [v.detach().to("cpu", copy=True) for v in whole["params"].values()]
    ema = [v.to("cpu", copy=True) for v in whole["ema"].values()]
    # the kernels launch on the card only; on the CPU every wrapper is its
    # plain version and counts nothing
    want = (expected_launches(cfg, 1, 0, model_size) if device.type == "cuda"
            else dict.fromkeys(WRAPPERS, 0))
    out = {"loss": float(m["loss"]), "accuracy": float(m["accuracy"]),
           "launches": launches, "lr": tx.schedule(state.count - 1),
           "params": params, "ema": ema, "digest": state_digest(params, ema),
           "stats": [(v - stats0[k]).cpu() for k, v in bundle.module.named_buffers()],
           "want": want, "step_ms": None, "profile": None, "peak_mem_gib": peak}
    gen = torch.Generator(device=device)
    t0 = time.perf_counter()
    for i in range(job["timed"]):
        gen.manual_seed(1000 + i)
        state, m = step(state, batch, generator=gen)
    sync(device)
    if job["timed"]:
        out["step_ms"] = (time.perf_counter() - t0) * 1e3 / job["timed"]
    if profile is not None:
        out["profile"] = _profiled_step(step, state, batch, gen, out["step_ms"], profile)
    return out


def summary(result: dict) -> dict:
    """``result`` of :func:`par_step` without its tensors: what another rank
    sends to the one that compares."""
    return {k: v for k, v in result.items() if k not in ("params", "ema", "stats")}


def par_compare(name: str, ranks: list[dict], one: dict, loss_tol: float,
                stats_tol: float | None) -> dict:
    """The ranks' step against the 1-process step: ``ranks[0]`` with its
    state, the others' :func:`summary` at least. The ranks' states must be
    bit-identical, and each rank's kernel launches those of its rows."""
    r0 = ranks[0]
    same = all(r["digest"] == r0["digest"] for r in ranks[1:])
    loss_rel = abs(r0["loss"] - one["loss"]) / abs(one["loss"])
    p_err = max(float((a - b).abs().max()) for a, b in zip(r0["params"], one["params"]))
    e_err = max((float((a - b).abs().max()) for a, b in zip(r0["ema"], one["ema"])),
                default=0.0)
    stats = rel_l2(r0["stats"], one["stats"]) if r0["stats"] else None
    lr = one["lr"]
    res = {"loss": [r0["loss"], one["loss"]], "loss_rel": loss_rel,
           "loss_tol": loss_tol, "accuracy": [r0["accuracy"], one["accuracy"]],
           "max_d_param": p_err, "max_d_ema": e_err, "param_tol": 4 * lr, "lr": lr,
           "stats_rel_l2": stats, "stats_tol": stats_tol, "ranks_bit_identical": same,
           "step_ms": [r["step_ms"] for r in ranks] + [one["step_ms"]]}
    print(f"parallel {name}: {len(ranks)} ranks vs 1 process: {res}", flush=True)
    require(same, f"{name}: the ranks' parameters differ")
    require(loss_rel <= loss_tol, f"{name}: loss rel {loss_rel} > {loss_tol}")
    require(p_err <= 4 * lr and e_err <= 4 * lr,
            f"{name}: params/EMA differ by {p_err}/{e_err} > 4 lr")
    if stats_tol is not None:
        require(stats is not None and stats <= stats_tol,
                f"{name}: running statistics rel L2 {stats} > {stats_tol}")
    for r in ranks:
        for k, n in r["want"].items():
            require(r["launches"][k] == n, f"{name}: a rank launched {k} "
                    f"{r['launches'][k]} times, expected {n}")
    return res


def remat_compare(name: str, modes: dict[str, list[dict]]) -> dict:
    """Each ``block_remat`` mode's ranks (:func:`summary` at least) against
    ``"none"``'s on the same mesh, weights, batch and draws: a recompute
    runs the same kernels and collectives on the same inputs, so the loss
    and every rank's parameters and EMA (their digest) must be equal to the
    bit. Returns each mode's verdict."""
    none = modes["none"]
    res = {mode: all(r["loss"] == n["loss"] and r["digest"] == n["digest"]
                     for r, n in zip(ranks, none)) for mode, ranks in modes.items()}
    print(f"parallel {name}: each block_remat mode bit-equal to none on every rank: "
          f"{res}", flush=True)
    for mode, same in res.items():
        require(same, f"{name}: block_remat={mode} differs from none: losses "
                f"{[r['loss'] for r in modes[mode]]} vs {[r['loss'] for r in none]}")
    return res


# ------------------------------------------------ ranks sharing one card
def par_worker(rank: int, world: int, rdzv: str, out: str, backend: str, jobs: list,
               argv: list | None) -> None:
    """One rank on the one card: joins the group (gloo for two ranks on one
    device, NCCL at world 1), then runs ``jobs`` through :func:`par_step`
    on the mesh of the data axis, or ``cli.main(argv)``; saves the results
    to ``{out}/rank{r}.pt``, with the state on rank 0 only (the others'
    :func:`summary` is what :func:`par_compare` reads)."""
    import datetime

    import torch.distributed as dist

    from image_classification_tpu_torch.parallel.mesh import (
        DATA_AXIS, Mesh, MeshSpec, build_mesh)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    kw = {"device_id": torch.device("cuda", 0)} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"file://{rdzv}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=PAR_RDZV_TIMEOUT_S), **kw)
    try:
        if argv is not None:
            cli.main(argv)
            return
        # at world 1 the data axis has no group of its own: hand it the world
        # group, so that the step goes through its gradient all-reduce
        results = [par_step(job, build_mesh(MeshSpec(*job["spec"])) if world > 1 else
                            Mesh((1, 1, 1), 0, {DATA_AXIS: dist.group.WORLD}),
                            profile=job.get("profile"))
                   for job in jobs]
        if rank > 0:
            results = [summary(r) for r in results]
        if backend == "nccl":
            results.append({"nccl": ".".join(map(str, torch.cuda.nccl.version()))})
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def par_spawn(tmp: str, tag: str, world: int, backend: str, jobs: list,
              argv: list | None = None) -> list:
    """:func:`par_worker` on ``world`` processes; their results by rank."""
    import torch.multiprocessing as mp

    out = os.path.join(tmp, tag)
    os.makedirs(out, exist_ok=True)
    mp.spawn(par_worker, args=(world, os.path.join(out, "rdzv"), out, backend, jobs, argv),
             nprocs=world, join=True)
    if argv is not None:
        return []
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------- fold-parallel entry
def read_submission(path: str) -> list[str]:
    with open(path) as f:
        return f.read().splitlines()


def check_fold_parallel_run(cfg, n_folds: int, epochs: int, shape: tuple[int, int, int],
                            n_test: int) -> list[dict]:
    """The files of ``cli train fold_parallel=true`` with ``cfg`` on the mesh
    ``shape``: one ``metrics.jsonl`` record a fold and epoch, the mesh and
    each fold's best logged once and no fold failed, the resume state and the
    best checkpoints of every fold, written once each, and a submission of
    ``n_test`` rows. Returns the records."""
    out = cfg.output_dir
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    with open(os.path.join(out, "train.log")) as f:
        log = f.read()
    folds = range(1, n_folds + 1)
    require(sorted((r["fold"], r["epoch"]) for r in records)
            == [(k, e) for k in folds for e in range(epochs)],
            f"metrics.jsonl: {[(r['fold'], r['epoch']) for r in records]}")
    require(log.count(f"mesh (fold, data, model) {tuple(shape)}") == 1
            and all(log.count(f"fold {k} best val acc") == 1 for k in folds)
            and "failed" not in log, "train.log:\n" + log[-3000:])
    state_dir = os.path.join(out, "train_state_foldpar")
    require(sorted(os.listdir(state_dir))
            == ["host_state.json", *(f"train_state_fold{k}.pt" for k in folds)],
            f"{state_dir}: {os.listdir(state_dir)}")
    models = sorted(os.listdir(cfg.model_save_path))
    require(models == sorted(f"{p}_fold{k}.{e}" for p in ("best_model", "best_loss_model")
                             for k in folds for e in ("json", "pt"))
            + ["norm_stats.json"] * ("norm_stats.json" in models),
            f"{cfg.model_save_path}: {models}")
    sub = read_submission(cfg.submission_path)
    require(sub[0] == "id,target" and len(sub) == n_test + 1,
            f"submission has {len(sub)} lines")
    return records


def compare_with_sequential(records: list[dict], seq: list[dict],
                            tol: float = PAR_ENTRY_LOSS_REL_TOL) -> dict:
    """Each fold's train loss an epoch, fold-parallel against the sequential
    ``cli train``; returns the relative differences by (fold, epoch)."""
    by = {(s["fold"], s["epoch"]): s for s in seq}
    rels = {}
    for r in sorted(records, key=lambda r: (r["fold"], r["epoch"])):
        s = by[(r["fold"], r["epoch"])]
        rel = abs(r["train_loss"] - s["train_loss"]) / abs(s["train_loss"])
        rels[f"{r['fold']}/{r['epoch']}"] = rel
        print(f"  fold {r['fold']} epoch {r['epoch'] + 1}: fold-parallel train loss "
              f"{r['train_loss']:.6f} ({r['steps']} steps, {r['images_per_sec']} images/s) "
              f"vs sequential {s['train_loss']:.6f} ({s['steps']} steps, "
              f"{s['images_per_sec']} images/s), rel {rel:.3g} (bound {tol}); val acc "
              f"{r['val_acc']:.4f} vs {s['val_acc']:.4f}", flush=True)
        require(r["steps"] == s["steps"] and rel <= tol,
                f"fold {r['fold']} epoch {r['epoch'] + 1}: fold-parallel vs sequential "
                f"train loss rel {rel}")
    return rels
