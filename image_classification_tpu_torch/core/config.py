"""Typed configuration, the PyTorch port's copy of
``image_classification_tpu/core/config.py``.

The port cannot import the JAX package's ``Config``: importing anything under
``image_classification_tpu`` runs its ``__init__``, which imports jax. This is
a field-for-field copy (names, defaults, validation), so ``configs/*.json``
and saved configs load unchanged; ``tests/test_torch_guards.py`` holds it to
the original.

Fields that pick a TPU lowering select nothing in the port, and are accepted
only so that presets still load: ``dwconv_impl``, ``gelu_impl``, ``mlp_2d``,
``pin_layout``, ``downsample_impl``, ``block_mlp_impl`` and ``warp_impl``. On
CUDA the 7x7 depthwise conv, the fused block tail (C <= 512) and the exact
GELU always run their hand-written kernels (``image_classification_tpu_torch/
ops``). ``block_remat`` is honoured, as in JAX: a ConvNeXt recomputes its
blocks in the backward (``"dots"`` keeps the depthwise and matmul outputs,
``"full"`` only each block's input; ``models/convnext.py``); EfficientNet
and ViT ignore it. ``prefetch_depth`` sets how many batches each loader assembles
ahead on its background thread; ``use_decode_cache`` whether the decoded
images persist in ``cache_dir`` or are decoded in memory for the run.
``debug_nans`` makes the fold loop check each step's loss and gradient norm.
The comments below are the JAX package's and quote TPU measurements.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Mapping, Sequence


@dataclass
class Config:
    # ------------------------------------------------------------------ data
    train_dir: str = "data/train"
    test_dir: str = "data/test"
    train_csv: str = "data/train.csv"
    test_csv: str = "data/sample_submission.csv"
    submission_path: str = "submission.csv"
    num_classes: int = 44
    # Native on-disk image size (H, W). The dataset is 60x80 JPEGs
    # (reference `progress.md:8`); host IO produces fixed-size uint8 batches
    # at this size and *all* resizing happens on device.
    native_size: tuple[int, int] = (60, 80)
    # Model input size (H, W)  (reference `config.py:11`).
    image_size: tuple[int, int] = (260, 260)
    # Progressive resizing (reference `config.py:12`, flag existed but was
    # disabled): train early epochs at smaller input sizes, ramping to
    # image_size over the first `progressive_stages` fractions of training.
    progressive_resizing: bool = False
    progressive_scales: tuple[float, ...] = (0.7, 0.85, 1.0)
    cache_dir: str = ".ic_tpu_cache"
    use_decode_cache: bool = True  # memmap uint8 cache of decoded images

    # -------------------------------------------------------- augmentation
    # Master switch: False makes the train step consume batch['image'] as
    # already-preprocessed float tensors at image_size (no device aug, no
    # in-batch mixing). Used for ablations and the torch trajectory-parity
    # test (identical post-aug inputs to both frameworks).
    aug_enabled: bool = True
    # Geometric (reference `dataset.py:196-210`)
    rrc_scale: tuple[float, float] = (0.8, 1.0)  # RandomResizedCrop area frac
    rrc_ratio: tuple[float, float] = (0.75, 4.0 / 3.0)
    hflip_prob: float = 0.5
    vflip_prob: float = 0.5
    ssr_prob: float = 0.5          # ShiftScaleRotate
    shift_limit: float = 0.1
    scale_limit: float = 0.2
    rotate_limit: float = 30.0
    # Noise / blur OneOf  (reference `dataset.py:201-205`)
    noise_blur_prob: float = 0.3
    gauss_noise_var: tuple[float, float] = (10.0, 50.0)
    blur_limit: tuple[int, int] = (3, 7)
    # Distortion OneOf  (reference `dataset.py:206-210`)
    distortion_prob: float = 0.3
    optical_distort_limit: float = 0.1
    optical_shift_limit: float = 0.1
    grid_distort_limit: float = 0.1
    grid_num_steps: int = 5
    elastic_alpha: float = 1.0
    elastic_sigma: float = 50.0
    # Color  (reference `dataset.py:211-216`)
    color_jitter_prob: float = 0.5
    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.2
    hue: float = 0.1
    color_shift_prob: float = 0.3  # OneOf {RGBShift, HSV, ToGray}
    rgb_shift_limit: float = 20.0
    hsv_hue_limit: float = 20.0
    hsv_sat_limit: float = 30.0
    hsv_val_limit: float = 20.0
    # CoarseDropout / random erasing  (reference `config.py:15`,
    # `dataset.py:219-230`)
    random_erasing_prob: float = 0.3
    erase_max_holes: int = 8
    erase_min_holes: int = 1
    # RandAugment (V2 recipe: timm rand-m9-n3-mstd0.5 with p=0.3,
    # reference `previous/V2-convbase/dataset.py:51-54`); off in V4
    use_randaugment: bool = False
    randaugment_prob: float = 0.3
    randaugment_num_ops: int = 3
    randaugment_magnitude: float = 9.0
    randaugment_mag_std: float = 0.5
    # MixUp / CutMix  (reference `config.py:16-17`, `dataset.py:70-190`)
    mixup_alpha: float = 0.2
    cutmix_alpha: float = 1.0
    mix_prob: float = 0.5
    # Normalization. ImageNet stats by default (reference `dataset.py:233-236`);
    # the notebook pipeline used dataset-computed stats (`example.py:134-135`).
    # norm_stats="dataset" computes (and caches) the train set's channel
    # mean/std and overrides mean/std with them (data/stats.py).
    norm_stats: str = "imagenet"        # "imagenet" | "dataset"
    mean: tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: tuple[float, float, float] = (0.229, 0.224, 0.225)
    # One-time bf16 cast of f32 params in predict_ensemble (halves the
    # per-forward HBM parameter traffic on the TTA-ensemble path; math
    # identical — flax casts params to compute dtype at use anyway).
    infer_cast_params: bool = True
    # Round the eval/TTA resize output back to uint8 before Normalize —
    # albumentations A.Resize operates on the uint8 image (`dataset.py:
    # 242-256`), and matching it keeps submissions bit-stable against
    # reference checkpoints (tests/test_infer_parity.py). False = pure
    # float convention.
    eval_resize_uint8: bool = True

    # --------------------------------------------------------------- model
    model_name: str = "convnext_base"
    pretrained: bool = False
    # Path to a local torch-format (or .safetensors) checkpoint to import.
    # There is no network download path; weight import is file based.
    pretrained_path: str | None = None
    # Drop the checkpoint's classifier head on import even when its shape
    # matches (the reference's local-weights path strips head/fc/classifier
    # keys unconditionally, `V3.2/train.py:100-106`; timm's download path
    # strips whenever num_classes differs). Off by default so an export ->
    # import round trip is the identity; the pretrained-regime ladder turns
    # it on to fine-tune with a fresh head like the reference does.
    pretrained_strip_head: bool = False
    use_deep_supervision: bool = True   # reference `config.py:22`
    aux_weight: float = 0.4             # reference `config.py:23`
    drop_rate: float = 0.0              # reference `V3.1/config.py:72`
    drop_path_rate: float = 0.0         # reference `V3.1/config.py:73`
    # exact erf GELU matches torch/timm weights (parity default); tanh
    # approximation is ~10% faster on the VPU
    gelu_approximate: bool = False
    # ConvNeXt depthwise-conv lowering: "conv" = lax.conv (XLA picks
    # channel-major layouts around it); "shift" = K^2 shifted FMAs
    # (layout-neutral, same math/params — see models/layers.ShiftDWConv)
    dwconv_impl: str = "conv"
    # Flatten (B,H,W,C)->(BHW,C) around each block's LN+MLP so XLA's
    # channel-major stage layouts can't decompose the matmuls per sample.
    # Bit-identical math; +20% step throughput measured on TPU v5e
    # (319 -> 383 img/s, docs/PERF_NOTES.md round 2).
    mlp_2d: bool = True
    # Pin row-major layouts on the activations entering/leaving each
    # depthwise conv (jax.experimental.layout.with_layout_constraint) so
    # XLA stops propagating channel-major {3,0,2,1} layouts across whole
    # stages (relayout copies at every block). Bit-identical on TPU;
    # measured +6.9% train step (349 -> 373 img/s, docs/PERF_NOTES.md).
    pin_layout: bool = True
    # Rematerialization of ConvNeXt blocks in the backward pass:
    # "none" = save all intermediates (XLA default); "dots" = save only
    # matmul + dwconv outputs, recompute LayerNorm/GELU in bwd (halves the
    # per-block (tokens, 4C) residual traffic); "full" = recompute whole
    # blocks (max activation-memory savings for large-image fine-tuning).
    block_remat: str = "none"
    # ConvNeXt block tail (LN+fc1+GELU+fc2+gamma+residual): "xla" composes
    # flax ops; "pallas" runs the fused whole-tail kernel with VMEM-resident
    # intermediates and a custom VJP (ops/block_mlp.py). Default on: measured
    # 384.6 -> 425.7 img/s on the V4 headline step (TPU v5e, round 3).
    # Auto-falls back per block when unsupported (drop_path>0, tanh GELU,
    # C>512, off-TPU) and is demoted to "xla" on multi-device meshes
    # (pallas_call has no SPMD partitioning rule — models/factory.py).
    block_mlp_impl: str = "pallas"
    # Single-pass fused clip+AdamW+EMA inside the jitted step
    # (train/fused.py): same math as the optax chain, one tree traversal.
    # Auto-falls back to the generic optax path for plateau/freeze modes.
    fused_update: bool = True
    # Bilinear-warp lowering for the device-side geometric augmentation:
    # "xla" = two MXU contractions with an HBM (B, P, H*C) intermediate;
    # "pallas" = fused ops/warp.py kernel, intermediate stays in VMEM (the
    # profiled (B, 67600, 180) relayout copy disappears). On data-parallel-
    # only meshes the kernel runs per-shard under jax.shard_map; demoted to
    # xla on tp/fold meshes (no SPMD rule for pallas_call) and off-TPU.
    warp_impl: str = "xla"
    # ConvNeXt 2x2/2 stage-downsample lowering: "conv" = nn.Conv (XLA conv
    # emitter, channel-major layout preference); "matmul" = W-fold reshape +
    # H-phase interleave + one MXU matmul (models/layers.patch_conv P=2 path;
    # bit-identical math, params unchanged). See docs/PERF_NOTES.md round 3.
    downsample_impl: str = "conv"
    # Exact-GELU lowering on the XLA block-MLP path: "xla" = gelu_erf_free
    # fused into the surrounding matmul epilogues; "pallas" = one elementwise
    # custom call per direction (ops/gelu.py gelu_erf_free_pallas); "erf" =
    # XLA's own erf expansion (round-3 baseline, for perf-ledger A/Bs).
    # Same exact-GELU semantics in all three; docs/PERF_NOTES.md round 5.
    gelu_impl: str = "xla"
    freeze_stages: int = 0              # reference `V3.1/...:399-403`
    ensemble_models: tuple[str, ...] = ()  # reference `previous/V2-convbase/config.py:46-51`
    ensemble_weights: tuple[float, ...] = ()

    # ------------------------------------------------------------- training
    batch_size: int = 32
    # The reference validates at 2x the train batch (`train_advanced_v4.py:618`,
    # a GPU-memory bound). Batch size is semantics-free for validation (masked
    # sums); 4x measured +66% eval throughput on TPU (tools/bench_eval.py:
    # 1568 vs 943 img/s), so the TPU default is 4. TTA-ensemble inference is
    # the opposite: its 4-view stack already multiplies the forward batch, and
    # 4x there measured SLOWER (186.5 vs 202.9 img/s) — it keeps its own 2x.
    val_batch_multiplier: int = 4
    infer_batch_multiplier: int = 2
    epochs: int = 20
    # "kfold": stratified K-fold CV (`train_advanced_v4.py:572-575`).
    # "holdout": ONE stratified train/val split of `val_fraction` — the V3.1
    # single-split trainer (`V3.1/train_advanced_v3.2.py:539-544`), with its
    # pre-split oversampling of ultra-rare classes to >=2 samples
    # (`V3.1/...:521-536`).
    split_mode: str = "kfold"
    val_fraction: float = 0.1
    num_folds: int = 3
    fold_seed: int = 42                 # reference `train_advanced_v4.py:572`
    patience: int = 4
    label_smoothing: float = 0.1
    seed: int = 42

    # ------------------------------------------------------------ optimizer
    optimizer: str = "adamw"
    lr: float = 1e-4
    weight_decay: float = 1e-2
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    gradient_accumulation_steps: int = 2
    gradient_clip_val: float = 1.0
    # The reference's AMP path accumulates *unscaled* (summed) microbatch
    # gradients (`train_advanced_v4.py:223-244`), while its non-AMP path
    # divides by the accumulation count. AMP was on in the published runs, so
    # "sum" is the parity default; "mean" is the corrected semantics.
    grad_accum_reduction: str = "sum"

    # -------------------------------------------------------------- schedule
    schedule: str = "warmup_cosine"     # warmup_cosine | plateau | none
    use_cosine_schedule: bool = True
    warmup_ratio: float = 0.1
    min_lr: float = 1e-6  # multiplier floor, see train/schedule.py quirk note
    # The reference sizes the cosine horizon in *microbatches* but advances
    # the schedule only once per optimizer step (every
    # `gradient_accumulation_steps` microbatches), so training ends mid-cosine
    # (`train_advanced_v4.py:628-634` vs `:233-234`). "microbatches" is the
    # parity behavior; "steps" is the corrected one.
    schedule_horizon: str = "microbatches"
    plateau_factor: float = 0.1         # reference `previous/V1-effb0/train.py:203-206`
    plateau_patience: int = 3
    # V1 stepped ReduceLROnPlateau on *train* accuracy
    # (`previous/V1-effb0/train.py:227`); "val_acc" is the saner default.
    plateau_metric: str = "val_acc"

    # --------------------------------------------------------- advanced train
    compute_dtype: str = "bfloat16"     # replaces AMP fp16+GradScaler
    use_ema: bool = True
    ema_decay: float = 0.9997
    # Whether validation / best-checkpoint weights are the EMA shadow (V4
    # semantics: `train_advanced_v4.py:449-462` apply_shadow around validate
    # and save) or the raw online weights. V3.1 maintains an EMA but NEVER
    # applies it — its `ModelEMA.module` is the live model and
    # `apply_shadow` has no call site (`V3.1/utils.py:6-37`,
    # `V3.1/train_advanced_v3.2.py:600,612`) — so the v3_1 preset sets this
    # false to reproduce raw-weight validation.
    ema_eval: bool = True
    use_swa: bool = False               # reference `previous/V3-efb2/...:445-507`
    swa_start_epoch: int = 10
    swa_lr: float = 1e-5

    # ------------------------------------------------------------- imbalance
    use_sampler: bool = False           # reference `V3.1/config.py:50`
    use_weighted_loss: bool = False     # reference `V3.1/config.py:51`
    use_focal_loss: bool = False        # reference `V3.1/config.py:52`
    focal_gamma: float = 2.0
    oversample_min_samples: int = 0     # 0 = off; reference `train_advanced_v4.py:527-560`

    # ------------------------------------------------------------- inference
    tta_transforms: int = 4             # 0 = plain softmax
    tta_mode: str = "scale4"            # scale4 (v4) | flip6 (example.py)
    # Second best-checkpoint tier keyed on lowest val loss, alongside the
    # best-acc tier — the notebook pipeline saved and could ensemble both
    # (`example.py:380-390,452-460`).
    save_best_loss: bool = True

    # ---------------------------------------------------------------- system
    mesh_data: int = -1                 # -1: all remaining devices
    mesh_model: int = 1
    # Train all K folds simultaneously over a leading `fold` mesh axis of
    # size num_folds (train/foldpar.py) — K folds in the wall time of one.
    fold_parallel: bool = False
    prefetch_depth: int = 2
    # HBM-resident image store: upload the decoded uint8 dataset to device
    # once and gather batches on device — per-epoch host->device traffic
    # drops from the full dataset to a few KB of indices. "auto" enables it
    # for single-device runs when the store fits hbm_cache_limit_mb.
    hbm_cache: str = "auto"             # "auto" | "on" | "off"
    hbm_cache_limit_mb: int = 4096
    # Full-TrainState resume checkpoint cadence: every N epochs (always on
    # the fold's final epoch and on early stop). The ~1.4 GB state pull
    # through a slow host link can dominate epoch wall time (PERF_NOTES).
    save_state_every: int = 1           # 0 = never
    # Pull checkpoints device->host and write them on a background thread
    # (the device arrays are snapshotted first, so training continues
    # immediately). Same on-disk format; joined at fold end.
    async_checkpoint: bool = True
    log_interval: int = 100
    model_save_path: str = "models_out"
    output_dir: str = "output"
    profile_dir: str | None = None
    debug_nans: bool = False

    # ------------------------------------------------------------------ api
    def replace(self, **kwargs: Any) -> "Config":
        return dataclasses.replace(self, **kwargs)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Config":
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k not in fields:
                raise KeyError(f"Unknown config key: {k!r}")
            if isinstance(v, list):
                v = tuple(v)
            ftype = str(fields[k].type)
            # coerce JSON ints to the declared float fields (a CLI override
            # like distortion_prob=0 must not become an int downstream)
            if ftype.startswith("float") and isinstance(v, int) and not isinstance(v, bool):
                v = float(v)
            if ftype.startswith("int") and isinstance(v, float) and v.is_integer():
                v = int(v)
            kwargs[k] = v
        return cls(**kwargs)

    def validate(self) -> "Config":
        if self.num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        if self.batch_size % self.gradient_accumulation_steps != 0:
            raise ValueError(
                "batch_size must be divisible by gradient_accumulation_steps"
            )
        if self.grad_accum_reduction not in ("sum", "mean"):
            raise ValueError("grad_accum_reduction must be 'sum' or 'mean'")
        if self.schedule_horizon not in ("microbatches", "steps"):
            raise ValueError("schedule_horizon must be 'microbatches' or 'steps'")
        if self.schedule not in ("warmup_cosine", "plateau", "none"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.dwconv_impl not in ("conv", "shift", "pallas"):
            raise ValueError(f"unknown dwconv_impl {self.dwconv_impl!r}")
        if self.block_mlp_impl not in ("xla", "pallas"):
            raise ValueError(f"unknown block_mlp_impl {self.block_mlp_impl!r}")
        if self.warp_impl not in ("xla", "pallas"):
            raise ValueError(f"unknown warp_impl {self.warp_impl!r}")
        if self.downsample_impl not in ("conv", "matmul"):
            raise ValueError(
                f"unknown downsample_impl {self.downsample_impl!r}"
            )
        if self.gelu_impl not in ("xla", "pallas", "erf"):
            raise ValueError(f"unknown gelu_impl {self.gelu_impl!r}")
        if self.block_remat not in ("none", "dots", "full"):
            raise ValueError(f"unknown block_remat {self.block_remat!r}")
        if self.hbm_cache not in ("auto", "on", "off"):
            raise ValueError(f"unknown hbm_cache {self.hbm_cache!r}")
        if self.norm_stats not in ("imagenet", "dataset"):
            raise ValueError(f"unknown norm_stats {self.norm_stats!r}")
        if self.split_mode not in ("kfold", "holdout"):
            raise ValueError(f"unknown split_mode {self.split_mode!r}")
        if not 0.0 < self.val_fraction < 1.0:
            raise ValueError("val_fraction must be in (0, 1)")
        if self.progressive_resizing:
            scales = tuple(self.progressive_scales)
            if not scales or scales[-1] != 1.0:
                # Eval/TTA always run at full image_size; a final stage below
                # 1.0 would silently train every late epoch at a different
                # resolution than evaluation.
                raise ValueError(
                    "progressive_scales must be non-empty and end with 1.0 "
                    f"(got {scales!r}) so the final stage trains at full size"
                )
        return self


def _parse_value(raw: str) -> Any:
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw


def apply_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    """Apply ``key=value`` CLI overrides. Values are parsed as JSON when
    possible (so ``lr=1e-3``, ``use_ema=false``, ``image_size=[224,224]``
    all work), else kept as strings."""
    updates: dict[str, Any] = {}
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"Override must look like key=value, got {item!r}")
        key, raw = item.split("=", 1)
        val = _parse_value(raw)
        if isinstance(val, list):
            val = tuple(val)
        updates[key.strip()] = val
    return Config.from_dict({**cfg.to_dict(), **updates})


def load_config(
    path: str | None = None, overrides: Sequence[str] = ()
) -> Config:
    """Build a config from an optional JSON file plus CLI overrides."""
    cfg = Config()
    if path is not None:
        with open(path) as f:
            loaded = {k: v for k, v in json.load(f).items()
                      if not k.startswith("_")}  # "_comment" etc.
            cfg = Config.from_dict({**cfg.to_dict(), **loaded})
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg.validate()
