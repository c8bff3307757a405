"""On-card smoke test of the PyTorch port.

The H100 host this script has run on, as probed (g++, ``#include
<jpeglib.h>``, ``ldconfig -p``, ``$CUDA_HOME/include/nvjpeg.h``): g++ 13.3,
no libjpeg header or library, the CUDA toolkit's nvJPEG 12.4. So there the
port's host JPEG library (``data/native.py``) is its nvJPEG build; the data
phase prints the probe again and the library it built.

It builds the port's kernels and
holds each one against its plain PyTorch version on the card (at
ConvNeXt-B's shapes: forward kernels at the predict slice's, backward
kernels at the train step's; at ConvNeXt-L's train shapes, forward and
backward; the augmentation's warp at its own), then runs the slices through
their entry points and checks each against the same work through the plain
versions in f32:

* aug: ``train_augment`` + ``mixup_cutmix_batch`` on 32 uint8 60x80 images,
  at V4's probabilities and with every probability 1, against the same draws
  on the host; then its rate alone;
* train: ``make_train_step`` of ConvNeXt-B with deep supervision, 44
  classes, 260x260, bf16, batch 32 of uint8 60x80 images with the device-side
  augmentation and MixUp/CutMix, gradient accumulation 2, clip, AdamW and EMA
  (``configs/v4.json`` as it is); then, timing only, the same batches
  augmented beforehand through the step with the aug off; then an eval step
  on the EMA weights through the loader, under the profiler, which must see
  no pageable host-to-device copy;
* predict: ``cli predict``, 2 fold models, scale4 TTA;
* train entry: ``cli train`` on ``configs/v4.json`` with
  ``model_name=convnext_large`` (full width and depth), 2 folds of 2 epochs
  over a synthetic 44-class set with a long tail, which writes the
  checkpoints, ``metrics.jsonl`` and the submission; then ``cli predict`` on
  the saved checkpoints, which must reproduce the submission; then the
  ConvNeXt-L train step alone, timed, and one step of it on 4 images against
  the f32 host step;
* V2: ``configs/v2_convbase.json`` with ``ensemble_models=[]`` (ConvNeXt-B
  at the native 60x80, RandAugment, batch 64, flip6 TTA): every kernel at
  its shapes; RandAugment with all 15 ops on the card in f32 and bf16
  against the host in f32; ``cli train`` (2 folds x 2 epochs), ``cli
  predict`` and ``--best-fold``; the step alone; then ``cli train`` with a
  holdout split, dataset channel stats and the stem and stage 0 frozen,
  ``cli predict`` from its ``norm_stats.json``, and one frozen step against
  the f32 host step;
* data: the host JPEG library against the committed JPEG fixture (exact
  with libjpeg-turbo, within a measured bound with nvJPEG), a hard synthetic
  set of 2,048 train and 512 test images written as JPEGs and its decode
  rate, V2 ``cli train`` (2 folds x 1 epoch) straight from the JPEGs
  decoded in memory and then through the decode cache (whose bytes must be
  the in-memory decode's, and which is then reused without the JPEGs),
  ``cli predict``, and V4 ConvNeXt-B ``cli train`` (one holdout fold, 1
  epoch) at ``prefetch_depth`` 0 and 2, with the loop's images/s and duty
  cycle;
* V1: ``configs/v1_effb0.json`` as shipped but ``epochs=2``
  (EfficientNet-B0 at 60x80, batch 64, plateau on train accuracy, the
  weighted sampler, no EMA, no mix):
  ``cli train`` (2 folds x 2 epochs) on the train entry's 44-class set,
  ``cli predict``, which must reproduce the submission, the step alone, and
  one step on 4 images in bf16 and in f32 against the f32 host step, on
  inputs augmented once on the host (the loss and the BatchNorm running
  statistics after it);
* V3.1: ``configs/v3_1.json`` with ``swa_start_epoch=1 epochs=2``
  (EfficientNetV2-S at 224x224, batch 128, dropout 0.2, drop-path 0.1, EMA,
  weighted CE, the sampler, MixUp/CutMix, scale4 TTA), so SWA and its
  BatchNorm update run in each fold: ``cli train`` (2 folds), whose log must
  show each fold's SWA line, ``cli predict``, the step alone, one step with
  the same drop masks and inputs against the f32 host step, and the warp at V3.1's
  (128, 60, 80, 3) -> (128, 224, 224, 3);
* V2 ensemble: ``configs/v2_convbase.json`` as shipped (ConvNeXt-B +
  ViT-B/16 + DeiT-B/16, weights .4/.3/.3, batch 64, RandAugment,
  MixUp/CutMix, flip6) but ``image_size=[224,224] num_folds=2 epochs=1``:
  ``cli train`` on the train entry's set (each member's checkpoints under
  ``<models>/<member>``, its weight in the log, launch counts exact), ``cli
  predict`` of each member alone, the train submission against the
  .4/.3/.3 mix of the members' probabilities; the ViT-B step alone (images/s,
  device time, idle share, the attention core's share, exact launches: GELU
  forward and backward 12 times a microbatch, the warp 1 + 3 times); one
  ViT-B step with dropout, attention dropout and drop-path, and one
  ConvNeXt-B step with drop-path and head dropout, each in bf16 and f32
  against the f32 host step on the same masks and inputs augmented once on
  the host; GELU at ViT-B's (64 x 197, 3072).

EfficientNet's convs, BatchNorms and activations are plain PyTorch (cuDNN),
as they are XLA ops in the JAX package: its steps launch the warp once and
no other kernel of the port.

Every depthwise backward runs as the forward stencil on g with the flipped
filter (dx) plus the wgrad-only kernel (dw). The block tail's bf16 forward
and backward run on one GEMM core (wgmma fed by TMA), which is also held
alone, product by product, against ``torch.matmul``.

* bench: ``image_classification_tpu_torch/bench.py``, the port's ``cli
  bench`` (V4 at accumulation 1, batch 32 at 260): kernels 1-5 (and GELU's
  at stage 3) at its shapes against their plain versions; its train step
  alone (wall, device time, idle share, peak memory); ``bench.main`` in this
  process, whose one line must be finite and positive and whose launch
  counts must be every block's kernels in each of its steps and forwards;
  the aug's device time against its wall (the host's dispatch share).
* remat: ``make_train_step`` on ``configs/v4.json`` (ConvNeXt-B, deep
  supervision, aug and mix, batch 32, accumulation 2) with ``block_remat``
  ``none``, ``none`` again, ``dots`` and ``full``, each one step from the
  same seeded weights, batch and draws, then again with
  ``drop_path_rate=0.1`` (every block but the first on the composed route,
  its masks carried through the recompute): the loss and each
  microbatch's gradients against the first ``none``'s, the exact launch
  counts of each mode (the extra forwards of the tail and the depthwise
  conv predicted by ``tools/parallel_check.py:model_launches``), and at
  rate 0 each mode's step wall, device time and peak memory.

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --only parallel    # the kernels' build and phase parallel
    python3 chip_smoke.py --only bench       # the kernels' build and phase bench
    python3 chip_smoke.py --only remat       # the kernels' build and phase remat

Needs one CUDA card, the CUDA toolkit (nvcc) and Triton; imports no JAX. It
exits non-zero, before printing any result, when there is no card or any
phase fails. It prints ``torch.profiler`` tables of one aug batch and of one
train step. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from image_classification_tpu_torch import bench, cli
from image_classification_tpu_torch.core.config import load_config
from image_classification_tpu_torch.data import (
    ArraySource,
    DataLoader,
    ImageSource,
    Manifest,
    SequentialSampler,
    make_hard_synthetic_dataset,
    native,
)
from image_classification_tpu_torch.data.source import decode_cache_key, save_decode_cache
from image_classification_tpu_torch.data.splits import (
    oversample_minority,
    stratified_kfold,
    stratified_split,
)
from image_classification_tpu_torch.data.stats import NORM_STATS_FILE, compute_channel_stats
from image_classification_tpu_torch.aug.draws import draws_to
from image_classification_tpu_torch.aug.geometry import draw_geometry, source_coords
from image_classification_tpu_torch.aug.pipeline import aug_configs_from, train_augment
from image_classification_tpu_torch.aug.randaug import (
    NUM_OPS,
    affine_coords,
    draw_rand_augment,
    slot_matrix,
)
from image_classification_tpu_torch.infer import predict_ensemble
from image_classification_tpu_torch.models.convnext import (
    BLOCK_REMAT,
    CONVNEXT_CONFIGS,
    ConvNeXtBlock,
)
from image_classification_tpu_torch.models.factory import create_model
from image_classification_tpu_torch.models.layers import drop_sites
from image_classification_tpu_torch.models.vit import VIT_CONFIGS
from image_classification_tpu_torch.ops import (
    _build,
    block_mlp,
    block_mlp_available,
    block_mlp_bwd,
    block_mlp_bwd_reference,
    block_mlp_fwd,
    block_mlp_fwd_reference,
    block_mlp_reference,
    depthwise_conv7x7,
    depthwise_conv7x7_bwd,
    depthwise_conv7x7_bwd_reference,
    depthwise_conv7x7_reference,
    depthwise_conv7x7_wgrad,
    depthwise_conv7x7_wgrad_reference,
    gelu,
    gelu_bwd,
    gelu_grad_reference,
    gelu_reference,
    warp,
    warp_reference,
)
from image_classification_tpu_torch.ops.warp import STAGE_MAX_BYTES, warp_staged
from image_classification_tpu_torch.tools.parallel_check import (
    EFF_STATS_REL_L2,
    NATIVE,
    PAR_BF16_STATS_REL_L2,
    PAR_ENTRY_LOSS_REL_TOL,
    PAR_F32_LOSS_REL_TOL,
    PAR_F32_STATS_REL_L2,
    PAR_LOSS_REL_TOL,
    STEPS_PER_EPOCH,
    TRAIN_LOSS_REL_TOL,
    WRAPPERS,
    check_fold_parallel_run,
    compare_with_sequential,
    expected_launches,
    model_launches,
    par_compare,
    par_job,
    par_spawn,
    par_step,
    read_launches,
    read_submission,
    rel_l2,
    remat_compare,
    require,
    reset_launches,
    seeded_model,
    synthetic_images,
    train_inputs,
    train_model,
)
from image_classification_tpu_torch.train.loop import build_lr_schedule, evaluate
from image_classification_tpu_torch.train.fused import fused_adamw_ema
from image_classification_tpu_torch.train.loss import build_criterion
from image_classification_tpu_torch.train.optim import build_optimizer, is_frozen
from image_classification_tpu_torch.train.step import (
    accumulate_grads,
    draw_train_step,
    make_batch_augment,
    make_eval_step,
    make_train_step,
)
from image_classification_tpu_torch.train.train_state import create_train_state
from image_classification_tpu_torch.utils.checkpoint import select_best_fold
from image_classification_tpu_torch.utils.profiler import device_ms

REPO = os.path.dirname(os.path.abspath(__file__))
MODEL = "convnext_base"
IMAGE = 260
VIEWS_BATCH = 256        # 64 images (batch_size 32 x infer_batch_multiplier 2) x 4 views
N_IMAGES = 100           # 2 batches of 64; the second is padded and masked
# The f32 plain reference runs on the host CPU (the wrappers' path for CPU
# tensors) at ~0.65 s per view-forward, so it scores the first N_REF images.
N_REF = 16
FOLD_SEEDS = (0, 1)
# Stage sizes at 260 px: 65, 33, 17, 9 (flax SAME padding on odd sizes).
STAGE_HW = (65, 33, 17, 9)
DEPTHS, DIMS = CONVNEXT_CONFIGS[MODEL]
MICRO = 16               # train microbatch: batch 32 / gradient accumulation 2
ACCUM = 2
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
REF_BATCH = 4            # images in the train step held against the f32 host step

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its operations
# over the rate of the units that run them.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12

# Tolerances, kernel vs plain version on identical bf16 inputs.
# dwconv, GELU: both compute in f32 and round once to bf16; the f32 results
# differ only in summation order / instruction choice (~1e-7 relative), which
# can move a rounding by at most one bf16 ulp.
ULP_TOL = 1
# block tail: GEMMs with K up to 2048 whose f32 sums run in another order,
# and h (forward) or du, da (backward) are rounded to bf16 between them, so a
# one-ulp flip (2^-8 relative) reaches the next product; bound the error by
# 2% of the largest element of each output.
BLOCK_REL_TOL = 2e-2
# dw of the depthwise conv: f32 sums of B*H*W = up to 67,600 bf16-rounded
# products in another order; f32 rounding then differs by ~sqrt(n) * 2^-24 of
# the terms' scale, far inside 1e-3 of the largest element.
DW_REL_TOL = 1e-3
# Slice: bf16 kernels vs f32 plain versions end to end. bf16 keeps 8 bits, so
# each of the 36 residual blocks adds ~0.4% relative noise to its output and
# the logits move by a few 1e-2. The first full run on an H100 measured
# max |d prob| = 6.5e-4 over 100 images; the bound is 3x that. Argmax must
# agree wherever the plain top-2 margin exceeds 2 * PROB_TOL.
PROB_TOL = 2e-3
# Train step, bf16 kernels vs f32 plain versions on the host, one step on
# fixed seeds (the kernels' sums run in a fixed order, so the numbers repeat
# from run to run). Each parameter's gradient passes back through up to 36
# bf16 blocks, each adding ~0.4% relative noise. The first full run on an
# H100 measured: loss rel err 3.6e-5, smallest per-tensor gradient cosine
# 0.99993 (a LayerNorm scale of stage 0), relative L2 error of the whole
# gradient 0.0074, of the update 0.057. The bounds are ~4x those (cosine:
# 1 - cos 14x). One AdamW step from a fresh state at count c moves each
# parameter by lr * (1-b1) / sqrt((1-b2) / (1-b2^(c+1))) * sign(g) (1.83 lr
# at the checked count) plus the decay: elements whose gradient is near zero
# may step either way, so the update is held in relative L2 and the
# parameters and EMA to 4 lr of each other. Those numbers were taken with
# pre-augmented inputs; with the aug and mix on, the card's inputs are the
# bf16 aug of the host's f32 one (~0.6 grey levels apart on average), and
# the first run measured loss rel err 2.1e-5, cosine 0.99979, gradient rel L2
# 0.0124, update rel L2 0.090: inside the same bounds, by 2.2x or more.
# ConvNeXt-L (36 blocks too, wider), aug and mix on, measured on its first
# run: cosine 0.99978, gradient rel L2 0.0123, update rel L2 0.083, as
# ConvNeXt-B; loss rel err 6.0e-4, 1.7x inside the bound (its seeded
# logits are larger, so the same bf16 noise in them moves the loss more).
# TRAIN_LOSS_REL_TOL (1e-3) is defined in tools/parallel_check.py, which
# the scale-out's checks share.
GRAD_MIN_COS = 0.999
GRAD_REL_L2 = 0.03
UPDATE_REL_L2 = 0.2
# The aug slice: the batch the aug check and the aug rate run on, and every
# probability of the config set to 1, so that each branch of each op runs.
N_AUG = 32
AUG_RATE_ITERS = 50
ALL_ONES = dict(hflip_prob=1.0, vflip_prob=1.0, ssr_prob=1.0,
                distortion_prob=1.0, noise_blur_prob=1.0,
                color_jitter_prob=1.0, color_shift_prob=1.0,
                random_erasing_prob=1.0, mix_prob=1.0)
# Aug in bf16 on the card against f32 on the host, same draws, in grey
# levels (0..255). bf16 keeps 8 bits, so one rounding of a value in
# [128, 256) moves it by up to 0.5, and the chain rounds at every op (~40 of
# them in an HSV round trip); hue in bf16 has steps of 2^-9 of the circle
# near 1, ~3 grey levels of a saturated colour. The first run on an H100
# measured max 12.86 / mean 0.562 at V4's probabilities and max 19.80 / mean
# 0.753 with all of them 1 (fixed seeds and orders: the numbers repeat); the
# bounds are 2x the larger.
AUG_MAX_GREY = 40.0
AUG_MEAN_GREY = 1.5
# Soft labels are f32 on both sides from the same lambdas and boxes.
LABEL_TOL = 1e-6
# warp: ~14 FLOP to fold a pixel's coordinates and build its four hats, and
# 8 per channel (two taps per row, two rows, their weighting).
WARP_FLOPS_PER_PIXEL = 14
WARP_FLOPS_PER_CHANNEL = 8


# The train entry: ConvNeXt-L (full width and depth) through ``cli train``.
ENTRY_MODEL = "convnext_large"
ENTRY_DEPTHS, ENTRY_DIMS = CONVNEXT_CONFIGS[ENTRY_MODEL]
WGRAD_SMALL = (3, 13, 17, 40)
# Where the forward stencil and the wgrad-only kernel can break, beyond the
# main path: V2's stage 0 at 60x80 input (15x20), maps smaller than the
# kernel, an odd small map, a map wider than the wgrad's 65-column strip,
# and a grid that takes the forward's wide launch with an odd C and a map
# wider than its 72-column strip (element copies, two strips, the last one
# partial); each in bf16 and f32. The CPU tests hold the plain versions to
# JAX at the first five.
EDGE_SHAPES = ((2, 15, 20, 128), (2, 3, 5, 40), (2, 1, 1, 40), WGRAD_SMALL,
               (1, 9, 70, 40), (128, 80, 80, 41))
# Block tail backward beyond the main path: one row, a ragged tile of 127
# rows, and C = 40 and 96, which are not multiples of the 64-column boxes.
BLOCK_BWD_EDGES = ((1, 40), (1, 128), (127, 96), (127, 512), (300, 40), (300, 96))
# Block tail forward beyond the main path, the same kinds of edge, and
# ConvNeXt-B's stage-2 rows (a ragged last tile) at C = 192 (N and K not
# multiples of the 128 x 64 tile).
BLOCK_FWD_EDGES = ((1, 40), (1, 96), (127, 40), (127, 96), (300, 512), (4624, 192))
# The GEMM core alone, each of the backward's four products against
# torch.matmul in f32 on the same bf16 operands: every product of two bf16
# values is exact in f32, so the two differ by the f32 rounding of sums in
# another order (~sqrt(K) 2^-24 of the terms' scale), far inside 1e-4 of the
# largest element. At M = 4624 (ConvNeXt-B's stage 2 rows: a ragged last
# tile) and C = 192 (N and K not multiples of the 128 x 64 tile).
GEMM_CHECK_SHAPE = (4624, 192)
GEMM_REL_TOL = 1e-4
# The earlier designs' device times at the main path's shapes (ms a launch,
# bf16, NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's: the
# depthwise forward and wgrad before their redesign (the mean of two runs of
# image_classification_tpu_torch/tools/time_dwconv.py on a checkout of those
# designs); the fused depthwise backward, which the split route replaced (two
# runs of the same script on the checkout that still had it); the block
# tail's WMMA backward and WMMA forward (two runs of tools/time_block_mlp.py
# on those checkouts; "block_mlp" at the predict shapes is the inference
# forward, at the train shapes the training forward); the Triton GELU
# forward and the one-pixel-a-thread warp before their redesign (the mean of
# two runs of tools/time_gelu_warp.py on a checkout of that design, in turns
# with this one; the warp's coordinates drawn as check_warp draws them).
EARLIER_MS = {
    ("gelu", (20736, 4096)): 0.1223, ("gelu", (1296, 4096)): 0.0084,
    ("gelu", (384, 4096)): 0.0041, ("gelu", (4624, 3072)): 0.0236,
    ("gelu", (1296, 6144)): 0.0121, ("gelu", (3136, 4096)): 0.0215,
    ("gelu", (12608, 3072)): 0.0579,
    ("warp", ((32, 60, 80, 3), (32, 260, 260, 2), "geometric")): 0.0180,
    ("warp", ((64, 60, 80, 3), (64, 60, 80, 2), "geometric")): 0.0054,
    ("warp", ((64, 60, 80, 3), (64, 60, 80, 2), "RandAugment")): 0.0051,
    ("warp", ((64, 60, 80, 3), (64, 224, 224, 2), "geometric")): 0.0306,
    ("warp", ((64, 224, 224, 3), (64, 224, 224, 2), "RandAugment")): 0.0333,
    ("warp", ((128, 60, 80, 3), (128, 224, 224, 2), "geometric")): 0.0586,
    ("dwconv", (256, 65, 65, 128)): 1.3439, ("dwconv", (256, 33, 33, 256)): 0.7947,
    ("dwconv", (256, 17, 17, 512)): 0.5380, ("dwconv", (256, 9, 9, 1024)): 0.4266,
    ("dwconv", (16, 65, 65, 192)): 0.1321, ("dwconv", (16, 33, 33, 384)): 0.0755,
    ("dwconv", (16, 17, 17, 768)): 0.0510, ("dwconv", (16, 9, 9, 1536)): 0.0411,
    ("dwconv_wgrad", (16, 65, 65, 192)): 0.2805,
    ("dwconv_bwd", (16, 65, 65, 128)): 0.3301, ("dwconv_bwd", (16, 33, 33, 256)): 0.2066,
    ("dwconv_bwd", (16, 17, 17, 512)): 0.1463, ("dwconv_bwd", (16, 9, 9, 1024)): 0.1268,
    ("dwconv_bwd", (16, 65, 65, 192)): 0.4797, ("dwconv_bwd", (16, 33, 33, 384)): 0.3058,
    ("dwconv_bwd", (16, 17, 17, 768)): 0.2079, ("dwconv_bwd", (16, 9, 9, 1536)): 0.1730,
    ("block_mlp_bwd", (67600, 128)): 1.1839, ("block_mlp_bwd", (17424, 256)): 0.8398,
    ("block_mlp_bwd", (4624, 512)): 0.8718, ("block_mlp_bwd", (67600, 192)): 1.9540,
    ("block_mlp_bwd", (17424, 384)): 1.5631,
    ("block_mlp", (1081600, 128)): 7.6934, ("block_mlp", (278784, 256)): 4.7653,
    ("block_mlp", (73984, 512)): 3.4900, ("block_mlp", (67600, 128)): 0.9031,
    ("block_mlp", (17424, 256)): 0.5944, ("block_mlp", (4624, 512)): 0.4152,
    ("block_mlp", (67600, 192)): 1.4258, ("block_mlp", (17424, 384)): 0.9100,
}
# A synthetic 44-class set with a long tail (class k has 1 + a share
# proportional to 0.9^k of the rest; the last classes have 1 sample, as the
# real data has), 2 folds of 2 epochs: ~128 train images a fold, 4 steps an
# epoch at batch 32.
ENTRY_TRAIN, ENTRY_TEST = 256, 64
ENTRY_FOLDS, ENTRY_EPOCHS = 2, 2
# V2: configs/v2_convbase.json as the JAX package's preset test runs it
# (ensemble_models=[]): ConvNeXt-B (full width and depth) at the native
# 60x80, RandAugment rand-m9-n3-mstd0.5 at p = 0.3, MixUp/CutMix, EMA and
# deep supervision off, batch 64, flip6 TTA; 2 folds of 2 epochs over the
# train entry's set. Its stage maps are 15x20, 8x10, 4x5 and 2x3.
V2_CONFIG = os.path.join(REPO, "configs", "v2_convbase.json")
V2_OVERRIDES = ["ensemble_models=[]", "ensemble_weights=[]"]
V2_MODEL, V2_BATCH = "convnext_base", 64
V2_STAGE_HW = ((15, 20), (8, 10), (4, 5), (2, 3))
V2_FOLDS, V2_EPOCHS = 2, 2
# RandAugment on the card against the host, same draws, grey levels, over
# N_AUG images x 60 x 80 x 3 = 460,800 values. f32 against f32: the ops are
# the same IEEE operations on both sides, except for sums in another order
# (contrast's mean, sharpness's 3x3 blur, the geometric aug's coordinates
# and RandAugment's cos/sin from another libm), which differ by ulps and
# leave the mean difference small; a value that lands within those ulps of
# a threshold (solarize, posterize, equalize's bins) flips on one side only
# and jumps by up to 255, so no maximum holds, but such values are rare.
# bf16 against f32: bf16 steps are 1 grey level in [128, 256), so
# thresholds flip wherever a value lies within ~0.5 of one (posterize at
# 1-2 bits jumps by 64-128, solarize by |255 - 2t|). The first run on an
# H100 measured f32: mean 0.0040, 8.25e-5 of the values beyond 1 level (38),
# max 3.01; bf16: mean 0.755, 3.6e-4 beyond 40 levels, max 255.4 (fixed
# seeds: the numbers repeat). The bounds are ~2x those.
RA_F32_MEAN_GREY = 0.01
RA_F32_SHARE_BEYOND_1 = 2e-4
RA_BF16_MEAN_GREY = 1.5
RA_BF16_SHARE_BEYOND_40 = 1e-3
# The data edge: a hard synthetic set (data/synthetic_hard.py, seed 0, the
# default task) written as JPEGs at 60x80, 2,048 train and 512 test images,
# decoded by the host JPEG library (data/native.py) with DECODE_THREADS.
DATA_TRAIN, DATA_TEST = 2048, 512
DECODE_THREADS = 16
# The JPEG fixture's decode against its committed bytes (libjpeg-turbo's,
# tests/test_torch_data.py). With libjpeg-turbo they must be equal. With the
# nvJPEG build only the IDCT's rounding differs (the chroma upsampling and
# colour conversion are libjpeg's, csrc/jpeg_color.h): its first runs on an
# H100 measured max 2 grey levels and a mean of at most 0.036 an image on
# the fixture, and max 3 on random 60x80 content against PIL's libjpeg-turbo
# (one rounding step of Y plus one of Cb through its 1.772 factor). The
# bounds: max 3, mean 0.1.
FIXTURE_MAX_GREY = 3
FIXTURE_MEAN_GREY = 0.1
# V2 from JPEG files: 2 folds x 1 epoch, first decoding in memory, then
# through the decode cache. V4 (ConvNeXt-B, deep supervision, 260x260): one
# holdout fold of half the set, 1 epoch, at prefetch_depth 0 and then 2.
DATA_V2 = ["num_folds=2", "epochs=1"]
DATA_V4 = ["split_mode=holdout", "val_fraction=0.5", "epochs=1", "save_state_every=0"]
V1_CONFIG = os.path.join(REPO, "configs", "v1_effb0.json")
V31_CONFIG = os.path.join(REPO, "configs", "v3_1.json")
V1_OVERRIDES = ["epochs=2"]
V31_OVERRIDES = ["swa_start_epoch=1", "epochs=2"]
EFF_FOLDS = 2
V31_WARP_BATCH = 128
# EfficientNet's step against the f32 host step, on REF_BATCH images
# augmented once on the host in f32 (the bf16 aug moves pixels by a mean
# 1.5 grey levels, which the first V1 run on the card carried into a 0.19
# move of the statistics). Measured on an H100 80GB HBM3 at 700 W
# (tools/effnet_precision.py and this script's V1 and V3.1 phases, B0 at
# 60x80 / V2-S at 224, seeded init):
# the card in f32 is within 2.4e-7 of the host's loss and 2.6e-6 / 8.0e-6
# (rel. L2) of the running statistics' change over the step, so the card
# computes the host's function. In bf16 the loss moved by 4.8e-3-9.2e-3 /
# 2.6e-4-1.4e-3 and the statistics by 0.058-0.071 / 0.060-0.081: at init,
# with 4 images a BatchNorm, the network amplifies small differences (the
# host's f32 step with its inputs times 1 + 1e-3 N(0, 1) moved the
# statistics by 0.015 / 0.022, and the gradients by 0.09 / 0.24), and
# bf16's rounding of every conv, BatchNorm and silu output acts like such a
# perturbation (with the convs on f32 inputs the statistics still moved by
# 0.053). The bf16 bounds are about twice the largest measured; the f32
# bounds are over 10x theirs.
EFF_LOSS_REL_TOL = 2e-2
# EFF_STATS_REL_L2 (0.15): tools/parallel_check.py, as TRAIN_LOSS_REL_TOL.
EFF_F32_LOSS_REL_TOL = 1e-5
EFF_F32_STATS_REL_L2 = 1e-4
# V2 as shipped: configs/v2_convbase.json's ConvNeXt-B + ViT-B/16 +
# DeiT-B/16 ensemble, weights .4/.3/.3, batch 64, RandAugment, MixUp/CutMix,
# flip6 TTA, through ``cli train`` on the train entry's 44-class set, at
# 224x224 (the size the ViT members are named for: at the shipped 60x80
# their folds fail, in the JAX package as in the port), 2 folds x 1 epoch.
V2E_OVERRIDES = ["image_size=[224,224]", "num_folds=2", "epochs=1"]
V2E_MEMBERS = ("convnext_base", "vit_base_patch16_224", "deit_base_patch16_224")
# Parallel phase: data parallelism on one card, two processes joined by
# gloo (NCCL refuses two ranks on one device), each with half of the global
# batch and its rows of one global set of draws, against one process with
# the whole batch; then NCCL at world 1; then the fold-parallel entry point.
# The steps, the comparison and the PAR_* bounds with their reasons are
# tools/parallel_check.py's, which tools/run_multicard.py runs on four cards.
PAR_WORLD = 2
PAR_ENTRY_FOLDS = 2
V2E_WEIGHTS = (0.4, 0.3, 0.3)
V2E_FOLDS = 2
V2E_STAGE_HW = ((56, 56), (28, 28), (14, 14), (7, 7))   # ConvNeXt-B's maps at 224
VIT_MODEL = "vit_base_patch16_224"
VIT_TOKENS_224 = 197     # 14 x 14 patches of 16 pixels + the cls token
# The train submission against the members' probabilities combined
# .4/.3/.3: rows whose top two are within this are not compared.
V2E_PROB_MARGIN = 1e-3
# The drop-site steps: every kind of site live (ViT: token and attention
# dropout and both DropPaths; ConvNeXt: drop-path on blocks 1-35 and the
# head's dropout).
VIT_DROP = ["drop_rate=0.1", "drop_path_rate=0.1"]
CONVNEXT_DROP = ["drop_path_rate=0.1", "drop_rate=0.2"]
# The drop-site steps against the f32 host step (4 images at 224, inputs
# augmented once on the host in f32, the same masks; loss rel, gradient rel
# L2, update rel L2 after one AdamW step from a fresh state at the end of
# warmup). Measured on an NVIDIA H100 80GB HBM3 at 700 W (fixed seeds: the
# numbers repeat). The card in f32 computes the host's function: ViT-B
# 1.2e-7 / 8.9e-7 / 2.4e-5, ConvNeXt-B 6.4e-8 / 5.0e-7 / 1.4e-5 (the update
# most: AdamW steps by ~lr * sign(g) where |g| is near its eps, and the key
# bias's gradient is zero in exact arithmetic, its rounding noise differing
# between any two sums); its bounds are ~10x those. ViT-B in bf16:
# 2.77e-4 / 9.79e-3 / 0.0985 (12 blocks, each rounding its attention
# weights and MLP to bf16; the update, as for ConvNeXt, is AdamW's sign of
# gradients near zero); its bounds are under twice those. ConvNeXt-B in
# bf16 with drop-path on blocks 1-35: 9.07e-4 / 7.71e-3 / 0.0908 (the
# update as above); its bounds are under twice those, not the ConvNeXt-L
# step's TRAIN_LOSS_REL_TOL, which left that loss 10% of room.
VIT_F32_BOUNDS = (1e-6, 1e-5, 2.5e-4)
VIT_BOUNDS = (5e-4, 0.019, 0.19)
CONVNEXT_F32_BOUNDS = (1e-6, 5e-6, 1.5e-4)
CONVNEXT_BOUNDS = (1.8e-3, 0.015, 0.18)


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


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


class KernelTable:
    """Per kernel: error, kernel / plain / library times and the bound, each
    summed over ``per`` launches at each timed shape. The table that the
    ``kernels`` line prints holds one optimizer step of the train entry's
    model, whose run gives the line its launches. Kernel and library times
    are device times (kernel_and_library_ms) for every row; plain times, of
    tens of PyTorch ops, are CUDA-event means."""

    def __init__(self):
        self.rows = {}

    def add(self, name, shape, per, err, ms, plain_ms, library_ms, nbytes,
            flops, flops_rate):
        bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "operations": flops / flops_rate * 1e3}
        earlier = EARLIER_MS.get((name, shape))
        print(f"kernel {name} {shape} x{per}: max_abs_err={err:.6g} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
              f"{'-' if library_ms is None else f'{library_ms:.4f}'} "
              f"bound_ms={max(bound.values()):.4f} "
              f"({max(bound, key=bound.get)})"
              + ("" if earlier is None else f" earlier_design_ms={earlier}"),
              flush=True)
        row = self.rows.setdefault(name, {
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
            "library_ms": None if library_ms is None else 0.0,
            "bytes_ms": 0.0, "operations_ms": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += per * ms
        row["plain_ms"] += per * plain_ms
        if library_ms is not None:
            row["library_ms"] += per * library_ms
        row["bytes_ms"] += per * bound["bytes"]
        row["operations_ms"] += per * bound["operations"]

    def entries(self, meta: dict) -> list[dict]:
        out = []
        for name, (route, source, replaces) in meta.items():
            r = self.rows[name]
            by = "bytes" if r["bytes_ms"] >= r["operations_ms"] else "operations"
            out.append({
                "name": name, "route": route, "source": source,
                "replaces": replaces, "launches": 0,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"],
                "bound_ms": max(r["bytes_ms"], r["operations_ms"]),
                "bound_by": by, "library_ms": r["library_ms"],
            })
        return out


KERNEL_META = {
    "dwconv": ("cuda", "image_classification_tpu_torch/csrc/dwconv7x7_fwd_wgrad.cu",
               "image_classification_tpu/ops/dwconv.py:205"),
    "block_mlp": ("cuda", "image_classification_tpu_torch/csrc/block_mlp.cu",
                  "image_classification_tpu/ops/block_mlp.py:253"),
    "gelu": ("cuda", "image_classification_tpu_torch/csrc/gelu.cu",
             "image_classification_tpu/ops/gelu.py:74"),
    # the split route: the forward stencil on g (dx) and the wgrad kernel (dw)
    "dwconv_bwd": ("cuda", "image_classification_tpu_torch/csrc/dwconv7x7_fwd_wgrad.cu",
                   "image_classification_tpu/ops/dwconv.py:243"),
    "block_mlp_bwd": ("cuda", "image_classification_tpu_torch/csrc/block_mlp_bwd.cu",
                      "image_classification_tpu/ops/block_mlp.py:305"),
    "gelu_bwd": ("triton", "image_classification_tpu_torch/ops/gelu.py",
                 "image_classification_tpu/ops/gelu.py:109"),
    "warp": ("cuda", "image_classification_tpu_torch/csrc/warp.cu",
             "image_classification_tpu/ops/warp.py:68"),
    "dwconv_wgrad": ("cuda", "image_classification_tpu_torch/csrc/dwconv7x7_fwd_wgrad.cu",
                     "image_classification_tpu/ops/dwconv.py:223"),
}
def check_f32_paths(gen) -> None:
    """Every kernel's f32 path at small odd shapes, and the depthwise
    forward's wide-group launch (a grid of 4,096 warps or more) in f32: the
    same kernels must match their plain versions to f32 noise."""
    x = randn(gen, 128, 9, 9, 1024, dtype=torch.float32)
    w = randn(gen, 7, 7, 1024, dtype=torch.float32)
    rel = max_rel(depthwise_conv7x7(x, w), depthwise_conv7x7_reference(x, w))
    require(rel <= 1e-5, f"dwconv f32 {tuple(x.shape)} rel err {rel}")
    x = randn(gen, 2, 9, 13, 40, dtype=torch.float32)
    w = randn(gen, 7, 7, 40, dtype=torch.float32)
    err = (depthwise_conv7x7(x, w) - depthwise_conv7x7_reference(x, w)).abs().max().item()
    require(err <= 1e-5, f"dwconv f32 err {err}")
    g = randn(gen, 2, 9, 13, 40, dtype=torch.float32)
    for ours, ref in zip(depthwise_conv7x7_bwd(x, g, w),
                         depthwise_conv7x7_bwd_reference(x, g, w)):
        require(max_rel(ours, ref) <= 1e-5, f"dwconv bwd f32 rel err "
                f"{max_rel(ours, ref)}")
    x = randn(gen, *WGRAD_SMALL, dtype=torch.float32)
    g = randn(gen, *WGRAD_SMALL, dtype=torch.float32)
    rel = max_rel(depthwise_conv7x7_wgrad(x, g), depthwise_conv7x7_wgrad_reference(x, g))
    require(rel <= 1e-5, f"dwconv wgrad f32 {WGRAD_SMALL} rel err {rel}")
    x = randn(gen, 37, 129, scale=3.0, dtype=torch.float32)
    dy = randn(gen, 37, 129, dtype=torch.float32)
    err = (gelu(x) - gelu_reference(x)).abs().max().item()
    require(err <= 1e-5, f"gelu f32 err {err}")
    err = (gelu_bwd(x, dy) - gelu_grad_reference(x, dy)).abs().max().item()
    require(err <= 1e-5, f"gelu bwd f32 err {err}")
    args = block_tail_inputs(gen, 77, 40, torch.float32)
    err = (block_mlp(*args) - block_mlp_reference(*args)).abs().max().item()
    require(err <= 1e-4, f"block tail f32 err {err}")
    saved = block_mlp_fwd(*args, 1e-6, save=True)
    for ours, ref in zip(saved, block_mlp_fwd_reference(*args)):
        require(max_rel(ours, ref) <= 1e-5, "block tail training forward f32")
    dy = randn(gen, 77, 40, dtype=torch.float32)
    x, a, u = args[0], saved[1], saved[2]
    for i, (ours, ref) in enumerate(zip(
            block_mlp_bwd(x, a, u, *args[2:], dy),
            block_mlp_bwd_reference(x, a, u, *args[2:], dy))):
        require(max_rel(ours, ref) <= 1e-5, f"block tail bwd f32 output {i}: "
                f"{max_rel(ours, ref)}")
    print("f32 kernel paths agree with their plain versions", flush=True)


def kernel_and_library_ms(what: str, kernel, library=None):
    """Device time a call (``utils.profiler.device_ms``: 20 calls queued
    behind a spin kernel, between CUDA events) of a kernel's wrapper and of
    its library call (None where there is none), printed beside plain
    CUDA-event means of back-to-back calls, which time the wrapper's host
    work too where a kernel of tens of µs does not hide it. Every row of the
    ``kernels`` line takes its ``ms`` and ``library_ms`` from here."""
    ms = device_ms(kernel, 20)
    lib_ms = None if library is None else device_ms(library, 20)
    print(f"{what}: device time a call kernel {ms:.4f} ms, library "
          f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms; CUDA events kernel "
          f"{time_ms(kernel, 10):.4f} ms, library "
          f"{'-' if library is None else f'{time_ms(library, 10):.4f}'} ms", flush=True)
    return ms, lib_ms


def check_edge_shapes(gen) -> None:
    """The forward stencil and the wgrad-only kernel at EDGE_SHAPES in bf16
    (1 ulp; dw within DW_REL_TOL) and f32 (1e-5, as check_f32_paths)."""
    for shape in EDGE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x, g = randn(gen, *shape, dtype=dtype), randn(gen, *shape, dtype=dtype)
            w = randn(gen, 7, 7, shape[-1], scale=0.15, dtype=dtype)
            y, ref = depthwise_conv7x7(x, w), depthwise_conv7x7_reference(x, w)
            dw, dref = depthwise_conv7x7_wgrad(x, g), depthwise_conv7x7_wgrad_reference(x, g)
            rel = max_rel(dw, dref)
            if dtype == torch.bfloat16:
                err, ok = bf16_ulp_distance(y, ref), rel <= DW_REL_TOL
                require(err <= ULP_TOL, f"dwconv {shape} bf16: {err} ulps")
            else:
                err, ok = (y - ref).abs().max().item(), rel <= 1e-5
                require(err <= 1e-5, f"dwconv {shape} f32: err {err}")
            require(ok, f"dwconv wgrad {shape} {dtype}: rel err {rel}")
            print(f"dwconv {shape} {str(dtype)[6:]}: forward "
                  f"{'ulps' if dtype == torch.bfloat16 else 'max abs err'} {err:.3g}, "
                  f"wgrad max rel {rel:.3g}", flush=True)


def library_dwconv(x, w):
    """One cuDNN call, F.conv2d(groups=C) on a channels-last bf16 tensor."""
    xc = x.permute(0, 3, 1, 2)                 # NHWC storage = channels_last
    wc = w.permute(2, 0, 1).unsqueeze(1).contiguous()
    return lambda: torch.nn.functional.conv2d(xc, wc, padding=3, groups=x.shape[-1])


def library_dwconv_bwd(x, g, w):
    xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    wc = w.permute(2, 0, 1).unsqueeze(1).contiguous()
    return lambda: torch.ops.aten.convolution_backward(
        gc, xc, wc, None, [1, 1], [3, 3], [1, 1], False, [0, 0], x.shape[-1],
        [True, True, False])


def library_dwconv_wgrad(x, g, w):
    xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    wc = w.permute(2, 0, 1).unsqueeze(1).contiguous()
    return lambda: torch.ops.aten.convolution_backward(
        gc, xc, wc, None, [1, 1], [3, 3], [1, 1], False, [0, 0], x.shape[-1],
        [False, True, False])


def check_gemm_core(gen) -> None:
    """The block tail backward's GEMM core alone (``ic_block_mlp_gemm``),
    each of its four products in the operands' own layouts, against
    ``torch.matmul`` in f32: dh = du W2 and dxhat = da W1 (A K-major, B the
    (out, in) weight read MN-major), dW1 = da^T xhat and dW2 = du^T h (both
    operands MN-major, K = M)."""
    m, c = GEMM_CHECK_SHAPE
    du, xhat = randn(gen, m, c), randn(gen, m, c)
    da, h = randn(gen, m, 4 * c), randn(gen, m, 4 * c)
    w1 = randn(gen, 4 * c, c, scale=c ** -0.5)
    w2 = randn(gen, c, 4 * c, scale=(4 * c) ** -0.5)
    lib = _build.library()
    for name, a, b, a_kmajor, rows, ref in (
            ("dh = du @ W2", du, w2, True, m, du.float() @ w2.float()),
            ("dxhat = da @ W1", da, w1, True, m, da.float() @ w1.float()),
            ("dW1 = da^T @ xhat", da, xhat, False, 4 * c, da.float().t() @ xhat.float()),
            ("dW2 = du^T @ h", du, h, False, c, du.float().t() @ h.float())):
        out = torch.empty(rows, b.shape[1], dtype=torch.float32, device="cuda")
        k = a.shape[1] if a_kmajor else a.shape[0]
        code = lib.ic_block_mlp_gemm(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                     int(a_kmajor), 0, rows, b.shape[1], k,
                                     torch.cuda.current_stream().cuda_stream)
        _build.check(code, f"GEMM core {name}")
        torch.cuda.synchronize()
        rel = max_rel(out, ref)
        print(f"GEMM core {name} ({rows} x {b.shape[1]}, K = {k}): max rel err "
              f"{rel:.3g} against torch.matmul in f32", flush=True)
        require(bool(torch.isfinite(out).all()) and rel <= GEMM_REL_TOL,
                f"GEMM core {name}: rel err {rel}")


def check_block_bwd_edges(gen) -> None:
    """The bf16 block tail backward at BLOCK_BWD_EDGES against its plain
    version (BLOCK_REL_TOL of each output's largest element), twice for the
    same bits."""
    for m, c in BLOCK_BWD_EDGES:
        args = block_tail_inputs(gen, m, c, torch.bfloat16)
        _, a, u = block_mlp_fwd(*args, 1e-6, save=True)
        bwd_args = (args[0], a, u, *args[2:], randn(gen, m, c))
        ours, ref = block_mlp_bwd(*bwd_args), block_mlp_bwd_reference(*bwd_args)
        rels = [max_rel(o, r) for o, r in zip(ours, ref)]
        print(f"block tail bwd {(m, c)}: max rel err of the nine gradients "
              f"{max(rels):.3g}", flush=True)
        require(max(rels) <= BLOCK_REL_TOL, f"block tail bwd {(m, c)}: rel errs {rels}")
        require(all(torch.equal(p, q) for p, q in zip(ours, block_mlp_bwd(*bwd_args))),
                f"block tail bwd {(m, c)} differs between two runs")


def check_block_fwd_edges(gen) -> None:
    """The bf16 block tail forward at BLOCK_FWD_EDGES against its plain
    version (BLOCK_REL_TOL of each output's largest element), inference
    (``save=False``) and training (``y``, ``a``, ``u``), each twice for the
    same bits."""
    for m, c in BLOCK_FWD_EDGES:
        args = block_tail_inputs(gen, m, c, torch.bfloat16)
        ref = block_mlp_fwd_reference(*args)
        y = block_mlp_fwd(*args, 1e-6, save=False)[0]
        saved = block_mlp_fwd(*args, 1e-6, save=True)
        rels = [max_rel(y, ref[0])] + [max_rel(o, r) for o, r in zip(saved, ref)]
        print(f"block tail fwd {(m, c)}: max rel err of y (inference), y, a, u "
              f"(training) {[f'{r:.2e}' for r in rels]}", flush=True)
        require(max(rels) <= BLOCK_REL_TOL, f"block tail fwd {(m, c)}: rel errs {rels}")
        require(torch.equal(y, block_mlp_fwd(*args, 1e-6, save=False)[0])
                and all(torch.equal(p, q) for p, q in
                        zip(saved, block_mlp_fwd(*args, 1e-6, save=True))),
                f"block tail fwd {(m, c)} differs between two runs")
        require(torch.equal(y, saved[0]),
                f"block tail fwd {(m, c)}: y differs between the two variants")


def check_kernels() -> list[dict]:
    """Phase 2: each kernel against its plain version on the card in bf16,
    timed, at the shapes of both models, and at small shapes in f32.
    ConvNeXt-B: the forward kernels at the predict slice's shapes and the
    backward ones at the train step's (microbatch 16). ConvNeXt-L, the train
    entry's model: forward and backward at its microbatch of 16 (its C = 192
    is not a multiple of the block tail's 128-wide GEMM tile). The
    ``kernels`` line sums ConvNeXt-L's times over one optimizer step."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    check_gemm_core(gen)
    check_f32_paths(gen)
    check_gelu_fwd_edges(gen)
    check_edge_shapes(gen)
    check_block_bwd_edges(gen)
    check_block_fwd_edges(gen)
    for stage, (hw, c, depth) in enumerate(zip(STAGE_HW, DIMS, DEPTHS)):
        print(f"{MODEL} stage {stage}:", flush=True)
        check_stage(KernelTable(), gen, stage, hw, c, VIEWS_BATCH, depth)
    table = KernelTable()
    for stage, (hw, c, depth) in enumerate(zip(STAGE_HW, ENTRY_DIMS, ENTRY_DEPTHS)):
        print(f"{ENTRY_MODEL} stage {stage}:", flush=True)
        check_stage(table, gen, stage, hw, c, MICRO, depth * ACCUM)
    check_warp_edges(gen)
    check_warp(table, gen)
    return table.entries(KERNEL_META)


def check_stage(table: KernelTable, gen, stage: int, hw, c: int,
                fwd_batch: int, per: int, bwd_batch: int = MICRO) -> None:
    """One stage's kernels in bf16 against their plain versions on maps of
    ``hw`` (a side, or (h, w)): the forward ones on ``fwd_batch`` maps, the
    backward ones on ``bwd_batch``; timed and added to ``table`` as ``per``
    launches each. The depthwise backward's
    dx adds ``per`` launches of the forward kernel, counted at the forward's
    shape (the table that is kept has fwd_batch = bwd_batch); its row holds
    the whole route (dx and dw), and the wgrad kernel has its own row too.
    The block tail's forward row holds the training forward at bwd_batch
    (what a train step launches) and, where fwd_batch is the predict batch,
    the inference forward there too."""
    mh, mw = (hw, hw) if isinstance(hw, int) else hw
    x = randn(gen, fwd_batch, mh, mw, c)
    w = randn(gen, 7, 7, c, scale=0.15)
    y, ref = depthwise_conv7x7(x, w), depthwise_conv7x7_reference(x, w)
    ulps = bf16_ulp_distance(y, ref)
    require(ulps <= ULP_TOL, f"dwconv stage {stage} {tuple(x.shape)}: {ulps} ulps")
    n = x.numel()
    ms, lib_ms = kernel_and_library_ms(f"dwconv {tuple(x.shape)}",
                                       lambda: depthwise_conv7x7(x, w),
                                       library_dwconv(x, w))
    table.add("dwconv", tuple(x.shape), per * 2,
              (y.float() - ref.float()).abs().max().item(), ms,
              time_ms(lambda: depthwise_conv7x7_reference(x, w), 5), lib_ms,
              4 * n, 2 * 49 * n, FP32_FLOPS)
    del x, y, ref
    if block_mlp_available(c):
        m = fwd_batch * mh * mw
        args = block_tail_inputs(gen, m, c, torch.bfloat16)
        y, ref = block_mlp(*args), block_mlp_reference(*args)
        err = (y.float() - ref.float()).abs().max().item()
        require(max_rel(y, ref) <= BLOCK_REL_TOL,
                f"block tail stage {stage} {(m, c)}: rel err {max_rel(y, ref)}")
        ms, _ = kernel_and_library_ms(f"block tail {(m, c)}", lambda: block_mlp(*args))
        if fwd_batch != bwd_batch:   # at the microbatch the training forward is kept
            table.add("block_mlp", (m, c), per, err, ms,
                      time_ms(lambda: block_mlp_reference(*args), 2), None,
                      6 * m * c + 16 * c * c, 16 * m * c * c, BF16_TENSOR_FLOPS)
        del args, y, ref
    else:
        check_gelu_fwd(table, gen, fwd_batch * mh * mw, 4 * c, per)
        if fwd_batch != bwd_batch:   # the train step's forward: its plain version's time
            xm = randn(gen, bwd_batch * mh * mw, 4 * c, scale=3.0)
            print(f"gelu {tuple(xm.shape)} (the train forward): plain version "
                  f"{time_ms(lambda: gelu_reference(xm), 5):.4f} ms", flush=True)
            del xm
    torch.cuda.empty_cache()

    x = randn(gen, bwd_batch, mh, mw, c)
    g = randn(gen, bwd_batch, mh, mw, c)
    w = randn(gen, 7, 7, c, scale=0.15)
    (dx, dw), (rdx, rdw) = (depthwise_conv7x7_bwd(x, g, w),
                            depthwise_conv7x7_bwd_reference(x, g, w))
    shape = tuple(x.shape)
    ulps, dw_rel = bf16_ulp_distance(dx, rdx), max_rel(dw, rdw)
    print(f"dwconv bwd {shape} (split route): dx {ulps} ulps, dw max rel "
          f"{dw_rel:.3g} against the plain version", flush=True)
    require(ulps <= ULP_TOL, f"dwconv bwd stage {stage} {shape}: dx {ulps} ulps")
    require(dw_rel <= DW_REL_TOL, f"dwconv bwd stage {stage} {shape}: dw rel err {dw_rel}")
    require(all(torch.equal(p, q) for p, q in zip(depthwise_conv7x7_bwd(x, g, w), (dx, dw))),
            "dwconv bwd differs between two runs")
    n = x.numel()
    ms, lib_ms = kernel_and_library_ms(f"dwconv bwd {shape}",
                                       lambda: depthwise_conv7x7_bwd(x, g, w),
                                       library_dwconv_bwd(x, g, w))
    table.add("dwconv_bwd", shape, per, (dx.float() - rdx.float()).abs().max().item(),
              ms, time_ms(lambda: depthwise_conv7x7_bwd_reference(x, g, w), 3), lib_ms,
              6 * n, 4 * 49 * n, FP32_FLOPS)
    ms, lib_ms = kernel_and_library_ms(f"dwconv wgrad {shape}",
                                       lambda: depthwise_conv7x7_wgrad(x, g),
                                       library_dwconv_wgrad(x, g, w))
    table.add("dwconv_wgrad", shape, per, (dw - rdw).abs().max().item(), ms,
              time_ms(lambda: depthwise_conv7x7_wgrad_reference(x, g), 3), lib_ms,
              4 * n + 4 * dw.numel(), 2 * 49 * n, FP32_FLOPS)
    del x, g, dx, dw, rdx, rdw
    if block_mlp_available(c):
        m = bwd_batch * mh * mw
        args = block_tail_inputs(gen, m, c, torch.bfloat16)
        y, a, u = block_mlp_fwd(*args, 1e-6, save=True)
        fwd_ref = block_mlp_fwd_reference(*args)
        for name, ours, ref in zip("yau", (y, a, u), fwd_ref):
            require(max_rel(ours, ref) <= BLOCK_REL_TOL,
                    f"block tail training forward stage {stage} {(m, c)}: {name}")
        again = block_mlp_fwd(*args, 1e-6, save=True)
        require(all(torch.equal(p, q) for p, q in zip((y, a, u), again)),
                "block tail training forward differs between two runs")
        ms, _ = kernel_and_library_ms(f"block tail training forward {(m, c)}",
                                      lambda: block_mlp_fwd(*args, 1e-6, save=True))
        table.add("block_mlp", (m, c), per,
                  (y.float() - fwd_ref[0].float()).abs().max().item(), ms,
                  time_ms(lambda: block_mlp_fwd_reference(*args), 2), None,
                  16 * m * c + 16 * c * c, 16 * m * c * c, BF16_TENSOR_FLOPS)
        del fwd_ref, again
        dy = randn(gen, m, c)
        bwd_args = (args[0], a, u, *args[2:], dy)
        ours, ref = block_mlp_bwd(*bwd_args), block_mlp_bwd_reference(*bwd_args)
        rels = [max_rel(o, r) for o, r in zip(ours, ref)]
        require(max(rels) <= BLOCK_REL_TOL,
                f"block tail bwd stage {stage} {(m, c)}: rel errs {rels}")
        again = block_mlp_bwd(*bwd_args)
        require(all(torch.equal(p, q) for p, q in zip(ours, again)),
                "block tail bwd differs between two runs")
        print(f"block tail bwd {(m, c)}: max rel err of (dx, dres, ds, dt, dw1, "
              f"db1, dw2, db2, dg) = {[f'{r:.2e}' for r in rels]}", flush=True)
        ms, _ = kernel_and_library_ms(f"block tail bwd {(m, c)}",
                                      lambda: block_mlp_bwd(*bwd_args))
        table.add("block_mlp_bwd", (m, c), per,
                  (ours[0].float() - ref[0].float()).abs().max().item(), ms,
                  time_ms(lambda: block_mlp_bwd_reference(*bwd_args), 2),
                  None, 16 * m * c + 48 * c * c, 32 * m * c * c,
                  BF16_TENSOR_FLOPS)
        del args, y, a, u, dy, bwd_args, ours, ref, again
    else:
        check_gelu_bwd(table, gen, bwd_batch * mh * mw, 4 * c, per)
    torch.cuda.empty_cache()


def check_gelu_fwd(table: KernelTable, gen, rows: int, cols: int, per: int) -> None:
    """The GELU forward kernel on (rows, cols) bf16 against its plain
    version (ULP_TOL), timed beside ``F.gelu``, added to ``table`` as
    ``per`` launches; then in f32 on the same values (1e-5), and, in both
    types, on the flat tensor without its last 3 elements (a scalar tail)
    and from its second element on (a base one element past a 16-byte
    boundary: a scalar head, and the tail)."""
    x = randn(gen, rows, cols, scale=3.0)
    y, ref = gelu(x), gelu_reference(x)
    ulps = bf16_ulp_distance(y, ref)
    require(ulps <= ULP_TOL, f"gelu {tuple(x.shape)}: {ulps} ulps")
    flat = x.reshape(-1)
    for part in (flat[:-3], flat[1:]):
        u = bf16_ulp_distance(gelu(part), gelu_reference(part))
        require(u <= ULP_TOL, f"gelu bf16 n={part.numel()} at +{part.data_ptr() % 16} "
                f"bytes: {u} ulps")
        ulps = max(ulps, u)
    xf = x.float()
    err = 0.0
    for part in (xf, xf.reshape(-1)[:-3], xf.reshape(-1)[1:]):
        err = max(err, (gelu(part) - gelu_reference(part)).abs().max().item())
    require(err <= 1e-5, f"gelu f32 {tuple(x.shape)} (whole, tail, head): err {err}")
    print(f"gelu {tuple(x.shape)}: bf16 {ulps} ulps, f32 max abs err {err:.3g} "
          f"(whole, without the last 3, from the second element)", flush=True)
    del xf
    ms, lib_ms = kernel_and_library_ms(f"gelu {tuple(x.shape)}", lambda: gelu(x),
                                       lambda: torch.nn.functional.gelu(x))
    table.add("gelu", tuple(x.shape), per,
              (y.float() - ref.float()).abs().max().item(), ms,
              time_ms(lambda: gelu_reference(x), 5), lib_ms,
              4 * x.numel(), 20 * x.numel(), FP32_FLOPS)


def check_gelu_fwd_edges(gen) -> None:
    """The GELU forward at small n (1, 7, 8, 9, 4097) from 0 to 3 elements
    past a 16-byte boundary, in bf16 (ULP_TOL) and f32 (1e-5): heads,
    tails, and a launch with no 16-byte vector at all."""
    for dtype in (torch.bfloat16, torch.float32):
        base = randn(gen, 4100, scale=3.0, dtype=dtype)
        for n in (1, 7, 8, 9, 4097):
            for off in range(4):
                x = base[off:off + n]
                y, ref = gelu(x), gelu_reference(x)
                if dtype == torch.bfloat16:
                    err = bf16_ulp_distance(y, ref)
                    require(err <= ULP_TOL, f"gelu bf16 n={n} +{off}: {err} ulps")
                else:
                    err = (y - ref).abs().max().item()
                    require(err <= 1e-5, f"gelu f32 n={n} +{off}: err {err}")
    print("gelu forward at n = 1, 7, 8, 9, 4097 from 0-3 elements past a 16-byte "
          "boundary agrees with its plain version in bf16 and f32", flush=True)


def check_gelu_bwd(table: KernelTable, gen, rows: int, cols: int, per: int) -> None:
    """The GELU backward kernel on (rows, cols) bf16 against its plain
    version (ULP_TOL), timed beside ``aten.gelu_backward``, added to
    ``table`` as ``per`` launches."""
    x = randn(gen, rows, cols, scale=3.0)
    dy = randn(gen, rows, cols)
    dx, ref = gelu_bwd(x, dy), gelu_grad_reference(x, dy)
    ulps = bf16_ulp_distance(dx, ref)
    require(ulps <= ULP_TOL, f"gelu bwd {tuple(x.shape)}: {ulps} ulps")
    ms, lib_ms = kernel_and_library_ms(f"gelu bwd {tuple(x.shape)}",
                                       lambda: gelu_bwd(x, dy),
                                       lambda: torch.ops.aten.gelu_backward(dy, x))
    table.add("gelu_bwd", tuple(x.shape), per,
              (dx.float() - ref.float()).abs().max().item(), ms,
              time_ms(lambda: gelu_grad_reference(x, dy), 5), lib_ms,
              6 * x.numel(), 25 * x.numel(), FP32_FLOPS)


def grid_sample_reflect(img: torch.Tensor, coords: torch.Tensor, dtype):
    """One PyTorch call computing the warp: ``F.grid_sample`` on an NCHW
    view, reflecting about the edge pixels' centres (``align_corners=True``),
    which is reflect-101. Returns the call, on its inputs made beforehand."""
    B, H, W, C = img.shape
    grid = torch.stack([coords[..., 1] / (W - 1) * 2 - 1,
                        coords[..., 0] / (H - 1) * 2 - 1], dim=-1).to(dtype)
    nchw = img.permute(0, 3, 1, 2)
    return lambda: torch.nn.functional.grid_sample(
        nchw, grid, mode="bilinear", padding_mode="reflection",
        align_corners=True).permute(0, 2, 3, 1)


# Each warp launch shape checked in this run, and the kernel's path there
# (ops/warp.py:warp_staged), for the ``kernels`` line.
WARP_PATHS: dict[str, str] = {}


def randaug_coords(gen, batch: int, hw, ra) -> torch.Tensor:
    """(batch, H, W, 2) source coordinates of one RandAugment slot on an
    (H, W) image, its op, magnitude and sign drawn as the aug draws them:
    ops 3 and 11-14 move the grid, the rest sample it where it lies."""
    d = draw_rand_augment(gen, batch, ra)
    frac = d.mags[:, 0] / 10.0
    return affine_coords(slot_matrix(d.op_ids[:, 0], torch.where(d.signs[:, 0], frac, -frac),
                                     hw), hw)


def check_warp(table: KernelTable, gen, config: str = "v4.json", batch: int = N_AUG,
               over: list[str] = ()) -> None:
    """The warp at each of a train step's launch shapes in bf16 (``config``
    with ``over`` applied, ``batch`` images): the geometric warp of 60x80
    images to the output size, one launch a step, its coordinates from the
    port's geometry with every probability 1 (flips, rotations and
    distortions fold through the border); where the config runs
    RandAugment, its affine slots on an image of the output size,
    ``randaugment_num_ops`` launches a step. Each against its plain version
    (ULP_TOL; the largest distance is printed, and the kernel's bits are the
    plain version's), timed beside ``grid_sample``, added to ``table``."""
    cfg = load_config(os.path.join(REPO, "configs", config), list(over)).replace(**ALL_ONES)
    aug = aug_configs_from(cfg)
    g = aug["geometry"]
    out_hw = tuple(cfg.image_size)
    coords = source_coords(draw_geometry(gen, batch, out_hw, g), NATIVE, out_hw, g)
    img = torch.from_numpy(synthetic_images(batch, seed=41)).cuda().to(torch.bfloat16)
    launches = [("geometric", img, coords, 1)]
    if aug["randaugment"] is not None:
        ra = aug["randaugment"]
        src = (torch.rand(batch, *out_hw, 3, generator=gen, device="cuda")
               * 255).to(torch.bfloat16)
        launches.append(("RandAugment", src, randaug_coords(gen, batch, out_hw, ra),
                         ra.num_ops))
    for kind, img, coords, per in launches:
        y, ref = warp(img, coords), warp_reference(img, coords)
        ulps = bf16_ulp_distance(y, ref)
        path = ("staged" if warp_staged(*img.shape[1:], img.dtype, y.numel() // y.shape[-1])
                else "gather")
        what = f"{tuple(img.shape)} -> {tuple(coords.shape[:3])} {kind}"
        WARP_PATHS[what] = path
        print(f"warp {what} x{per}, {path} path: {ulps} ulps from its plain version",
              flush=True)
        require(ulps <= ULP_TOL, f"warp bf16 {what}: {ulps} ulps")
        ms, lib_ms = kernel_and_library_ms(
            f"warp {what}", lambda: warp(img, coords),
            grid_sample_reflect(img, coords, torch.bfloat16))
        c = img.shape[-1]
        table.add("warp", (tuple(img.shape), tuple(coords.shape), kind), per,
                  (y.float() - ref.float()).abs().max().item(), ms,
                  time_ms(lambda: warp_reference(img, coords), 5), lib_ms,
                  img.numel() * 2 + coords.numel() * 4 + y.numel() * 2,
                  coords.numel() // 2 * (WARP_FLOPS_PER_PIXEL + WARP_FLOPS_PER_CHANNEL * c),
                  FP32_FLOPS)


def far_coords(gen, b: int, out_hw, src_hw) -> torch.Tensor:
    """(b, Ho, Wo, 2) coordinates from half an image before each edge to
    half an image past it: most fold through a border, some twice."""
    (ho, wo), (h, w) = out_hw, src_hw
    return torch.stack([torch.rand(b, ho, wo, generator=gen, device="cuda") * 2 * h - h / 2,
                        torch.rand(b, ho, wo, generator=gen, device="cuda") * 2 * w - w / 2],
                       -1)


def warp_on_path(img: torch.Tensor, coords: torch.Tensor, staged: bool) -> torch.Tensor:
    """``ic_warp`` on the path given, not the one ``warp_staged`` picks."""
    B, H, W, C = img.shape
    out = torch.empty(*coords.shape[:3], C, dtype=img.dtype, device="cuda")
    code = _build.library().ic_warp(
        img.data_ptr(), coords.data_ptr(), out.data_ptr(), B, H, W, C,
        coords.shape[1] * coords.shape[2], _build.DTYPE_CODES[img.dtype], int(staged),
        torch.cuda.current_stream().cuda_stream)
    _build.check(code, "warp")
    return out


def check_warp_edges(gen) -> None:
    """The warp where it can break beyond the launch shapes, on both paths
    (staged and gather, whichever ``warp_staged`` would pick), each against
    its plain version (bf16: ULP_TOL; f32: 1e-4) on coordinates far outside
    the image: 3 images of 13x17x3 -> 11x19 in f32 through the wrapper (P =
    209 is odd, so images 1 and 2 start with a head of single pixels); 5
    images of 13x17x3 -> 9x23 (P = 207: heads of 0, 1, 2 and 3 pixels,
    ragged last groups) in bf16 and f32; and sources at the staged path's
    size limit, STAGE_MAX_BYTES (112x128 in bf16, 56x128 in f32), 3 images
    -> 45x47 (odd P), and a column past it through the wrapper (which
    gathers: ``warp_staged`` must put the limit there)."""
    small = 128 + randn(gen, 3, 13, 17, 3, scale=60.0, dtype=torch.float32)
    sc = torch.stack([torch.rand(3, 11, 19, generator=gen, device="cuda") * 60 - 20,
                      torch.rand(3, 11, 19, generator=gen, device="cuda") * 80 - 30], -1)
    err = (warp(small, sc) - warp_reference(small, sc)).abs().max().item()
    lib_err = (grid_sample_reflect(small, sc, torch.float32)()
               - warp_reference(small, sc)).abs().max().item()
    print(f"warp f32 3x13x17x3 -> 11x19: max |kernel - plain| {err:.3g}, "
          f"max |grid_sample - plain| {lib_err:.3g}", flush=True)
    require(err <= 1e-4, f"warp f32 err {err}")
    for dtype in (torch.bfloat16, torch.float32):
        h = STAGE_MAX_BYTES // (4 * dtype.itemsize) // 128
        require(warp_staged(h, 128, 3, dtype, 2 ** 40)
                and not warp_staged(h, 129, 3, dtype, 2 ** 40),
                f"warp_staged's size limit is not at {h}x128 in {dtype}")
        for (b, sh, sw), out_hw, paths in (((5, 13, 17), (9, 23), (True, False)),
                                           ((3, h, 128), (45, 47), (True, False)),
                                           ((3, h, 129), (45, 47), (None,))):
            img = (128 + randn(gen, b, sh, sw, 3, scale=60.0, dtype=torch.float32)).to(dtype)
            coords = far_coords(gen, b, out_hw, (sh, sw))
            ref = warp_reference(img, coords)
            for staged in paths:   # None: the wrapper's (gather: past the limit)
                y = warp(img, coords) if staged is None else warp_on_path(img, coords, staged)
                path = {None: "the wrapper's gather", True: "staged", False: "gather"}[staged]
                if dtype == torch.bfloat16:
                    err = bf16_ulp_distance(y, ref)
                    require(err <= ULP_TOL, f"warp bf16 {tuple(img.shape)}: {err} ulps")
                else:
                    err = (y - ref).abs().max().item()
                    require(err <= 1e-4, f"warp f32 {tuple(img.shape)}: err {err}")
                print(f"warp {str(dtype)[6:]} {tuple(img.shape)} -> {out_hw}, {path} path: "
                      f"{'ulps' if dtype == torch.bfloat16 else 'max abs err'} {err:.3g}",
                      flush=True)


def check_aug(cfg) -> dict:
    """``train_augment`` + ``mixup_cutmix_batch`` on N_AUG images: bf16 with
    the warp kernel on the card against f32 through the plain path on the
    host, from the same draws, at V4's probabilities and with all of them 1.
    Differences are in grey levels (Normalize's output scaled back)."""
    images, labels = train_inputs(cfg, N_AUG, seed=61)
    std = torch.tensor(cfg.std) * 255.0
    stats = {}
    for name, over in (("v4", {}), ("all ones", ALL_ONES)):
        c = cfg.replace(**over)
        gen = torch.Generator(device="cuda").manual_seed(62)
        draws = draw_train_step(gen, tuple(images.shape), c)
        card = make_batch_augment(c)({"image": images.cuda(), "label": labels.cuda()},
                                     draws=draws)
        host = make_batch_augment(c.replace(compute_dtype="float32"))(
            {"image": images, "label": labels}, draws=draws_to(draws, "cpu"))
        require(card[0].dtype == torch.bfloat16 and card[0].shape == host[0].shape,
                f"aug output {card[0].dtype} {tuple(card[0].shape)}")
        d = (card[0].float().cpu() - host[0]).abs() * std
        lab = (card[1].cpu() - host[1]).abs().max().item()
        stats[name] = (d.max().item(), d.mean().item())
        p999 = d.flatten().kthvalue(int(0.999 * d.numel())).values.item()
        print(f"aug + mix, {name} probabilities, bf16 card vs f32 host: max |d| "
              f"{stats[name][0]:.4f} grey levels, mean {stats[name][1]:.5f}, "
              f"99.9th percentile {p999:.4f}; soft labels max |d| {lab:.3g}",
              flush=True)
        require(bool(torch.isfinite(card[0]).all()), "non-finite aug output")
        require(stats[name][0] <= AUG_MAX_GREY and stats[name][1] <= AUG_MEAN_GREY,
                f"aug {name}: max/mean |d| {stats[name]} grey levels")
        require(lab <= LABEL_TOL, f"soft labels differ by {lab}")
    return stats


def aug_rate(cfg) -> float:
    """``train_augment`` alone on N_AUG uint8 images, draws included: host
    clock over AUG_RATE_ITERS batches after one warm batch."""
    aug = aug_configs_from(cfg)
    images = train_inputs(cfg, N_AUG, seed=71)[0].cuda()
    gen = torch.Generator(device="cuda").manual_seed(72)
    train_augment(images, gen, aug)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(AUG_RATE_ITERS):
        train_augment(images, gen, aug)
    torch.cuda.synchronize()
    rate = AUG_RATE_ITERS * N_AUG / (time.perf_counter() - t0)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train_augment(images, gen, aug)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"aug: {rate:.2f} images/s (train_augment, batch {N_AUG}, "
          f"{AUG_RATE_ITERS} batches, {N_AUG * 1e3 / rate:.3f} ms a batch); "
          f"profiled batch: device kernel time {dev_ms:.3f} ms in "
          f"{sum(e.count for e in rows)} device activities", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
              f"{e.key[:100]}", flush=True)
    return rate


def check_train_step(cfg) -> dict:
    """One optimizer step on REF_BATCH uint8 images, aug and mix on, bf16
    kernels on the card against the f32 plain versions on the host, from the
    same state and the same draws (made on the card). With ``freeze_stages``
    the frozen parameters must keep their bits on both sides."""
    cfg32 = cfg.replace(compute_dtype="float32")
    tx = build_optimizer(cfg, build_lr_schedule(cfg, STEPS_PER_EPOCH))
    start = int(STEPS_PER_EPOCH * cfg.epochs * cfg.gradient_accumulation_steps
                * cfg.warmup_ratio)
    images, labels = train_inputs(cfg, REF_BATCH, seed=11)
    draws = draw_train_step(torch.Generator(device="cuda").manual_seed(12),
                            tuple(images.shape), cfg)
    runs = {}
    t0 = time.perf_counter()
    for name, c, device in (("card", cfg, "cuda"), ("host", cfg32, "cpu")):
        bundle = train_model(c, device)
        model = bundle.module
        crit = build_criterion(c)
        batch = {"image": images.to(device), "label": labels.to(device)}
        d = draws_to(draws, device)
        x, targets = make_batch_augment(c)(batch, draws=d)
        grads, m = accumulate_grads(model, c, crit, x, targets, batch["label"])
        state = create_train_state(model)
        state.count = state.step = start
        before = [p.detach().clone() for p in state.params()]
        step = make_train_step(bundle, c, tx, crit)
        state, m2 = step(state, batch, draws=d)
        runs[name] = {
            "loss": float(m["loss"]), "loss2": float(m2["loss"]),
            "grads": [g.float().cpu() for g in grads],
            "update": [(p.detach() - q).cpu() for p, q in zip(state.params(), before)],
            "params": [p.detach().cpu() for p in state.params()],
            "ema": [e.cpu() for e in state.ema or []],
            "names": state.names(),
            "frozen_kept": [torch.equal(p.detach(), q) for n, p, q in zip(
                state.names(), state.params(), before)
                if is_frozen(n, c.freeze_stages)],
        }
        del bundle, model, state, grads, before
        torch.cuda.empty_cache()
    card, host = runs["card"], runs["host"]
    both_s = time.perf_counter() - t0
    lr = tx.schedule(start)
    loss_rel = abs(card["loss"] - host["loss"]) / abs(host["loss"])
    cos = [float(torch.nn.functional.cosine_similarity(a.flatten().double(),
                                                       b.flatten().double(), dim=0))
           for a, b in zip(card["grads"], host["grads"])]
    worst = int(np.argmin(cos))
    grad_rel = rel_l2(card["grads"], host["grads"])
    upd_rel = rel_l2(card["update"], host["update"])
    p_err = max(float((a - b).abs().max()) for a, b in zip(card["params"], host["params"]))
    e_err = max((float((a - b).abs().max()) for a, b in zip(card["ema"], host["ema"])),
                default=0.0)
    frozen = len(card["frozen_kept"])
    print(f"{cfg.model_name} train step vs f32 host step ({REF_BATCH} images, lr "
          f"{lr:.3g}, both in {both_s:.1f} s): loss "
          f"{card['loss']:.6f} vs {host['loss']:.6f} (rel {loss_rel:.3g}); "
          f"gradient cosine min {min(cos):.5f} ({card['names'][worst]}), median "
          f"{float(np.median(cos)):.5f}; gradient rel L2 {grad_rel:.4g}; update "
          f"rel L2 {upd_rel:.4g}; max |d param| {p_err:.3g}, max |d ema| "
          f"{e_err:.3g}"
          + (f"; {sum(card['frozen_kept'])}/{frozen} frozen tensors keep their bits "
             f"on the card, {sum(host['frozen_kept'])}/{frozen} on the host"
             if frozen else ""), flush=True)
    require(all(card["frozen_kept"]) and all(host["frozen_kept"]),
            "a frozen parameter changed")
    for run in (card, host):
        require(abs(run["loss"] - run["loss2"]) <= TRAIN_LOSS_REL_TOL * abs(run["loss"]),
                "the train step's loss differs from its gradient pass")
    require(loss_rel <= TRAIN_LOSS_REL_TOL, f"train loss rel err {loss_rel}")
    require(min(cos) >= GRAD_MIN_COS, f"gradient cosine {min(cos)}")
    require(grad_rel <= GRAD_REL_L2, f"gradient rel L2 {grad_rel}")
    require(upd_rel <= UPDATE_REL_L2, f"update rel L2 {upd_rel}")
    require(p_err <= 4 * lr and e_err <= 4 * lr,
            f"params/EMA differ by {p_err}/{e_err} > 4 lr")
    return {"loss_rel": loss_rel, "grad_min_cos": min(cos), "grad_rel_l2": grad_rel,
            "update_rel_l2": upd_rel, "frozen_tensors_kept": frozen}


def profile_train_step(step, state, batches, step_wall_ms: float,
                       top: int | None = None) -> tuple[float, list]:
    """The last of ``batches``' train steps under torch.profiler (the first
    warms the profiler up): its device time by kernel name, printed. The
    device's idle share is taken against ``step_wall_ms``, the wall time of a
    step in the timed run, since the profiler slows the host. Returns the
    device time of the step in ms and its kernels as (self device ms, count,
    name), the longest first."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for b in batches:   # one profiler per step; the last one is read
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(state, b)
            torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    dev_ms = sum(r[0] for r in rows)
    idle = max(0.0, 1 - dev_ms / step_wall_ms)
    print(f"profile of one train step of {batches[-1]['image'].shape[0]} images: "
          f"device kernel time "
          f"{dev_ms:.3f} ms, wall {step_wall_ms:.3f} ms a step in the timed "
          f"run, device idle {idle:.1%}", flush=True)
    for ms, count, key in rows[:top]:
        print(f"  {ms:9.3f} ms {count:5d}x {key[:100]}", flush=True)
    return dev_ms, rows


def run_train() -> dict:
    """Phase 3: the train slice on the card, then an eval step on the EMA
    weights."""
    cfg = load_config(os.path.join(REPO, "configs", "v4.json"))
    require(cfg.batch_size == MICRO * ACCUM and cfg.gradient_accumulation_steps == ACCUM,
            "configs/v4.json no longer trains in batches of 32 with accumulation 2")
    require(cfg.aug_enabled and cfg.mixup_alpha > 0 and cfg.cutmix_alpha > 0,
            "configs/v4.json no longer trains with aug and MixUp/CutMix")
    check = check_train_step(cfg.replace(batch_size=REF_BATCH))

    bundle = train_model(cfg, "cuda")
    tx = build_optimizer(cfg, build_lr_schedule(cfg, STEPS_PER_EPOCH))
    train_step = make_train_step(bundle, cfg, tx, build_criterion(cfg))
    gen = torch.Generator(device="cuda").manual_seed(22)

    def step(state, batch):
        return train_step(state, batch, generator=gen)

    state = create_train_state(bundle.module)
    n = TRAIN_WARMUP + TRAIN_STEPS + 2
    images, labels = train_inputs(cfg, n * cfg.batch_size, seed=21)
    batches = [{"image": images[i::n].cuda(), "label": labels[i::n].cuda()}
               for i in range(n)]
    del images, labels
    losses = []
    for b in batches[:TRAIN_WARMUP]:
        state, m = step(state, b)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                          # main path: counts from 0
    t0 = time.perf_counter()
    for b in batches[TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_STEPS]:
        state, m = step(state, b)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(v) for v in losses]
    print(f"train: {TRAIN_STEPS * cfg.batch_size / wall:.2f} images/s "
          f"({TRAIN_STEPS} steps of {cfg.batch_size} in {wall:.3f} s), peak memory "
          f"{peak_gib:.3f} GiB, losses {[round(v, 4) for v in losses]}, "
          f"launches {launches}", flush=True)
    require(all(np.isfinite(losses)), "non-finite train loss")
    want = expected_launches(cfg, TRAIN_STEPS, 0)
    for name, n in want.items():
        require(launches[name] == n, f"{name}: {launches[name]} launches "
                f"in {TRAIN_STEPS} steps, expected {n}")
    dev_ms, _ = profile_train_step(step, state, batches[-2:],
                                wall * 1e3 / TRAIN_STEPS)
    aug_off_ips = train_rate_without_aug(bundle, cfg, tx, state,
                                         batches[TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_STEPS])

    # an eval step on the EMA weights: 60 images through the loader in one
    # batch of 64 (4 padding rows), under the profiler, which must see no
    # pageable host-to-device copy (each would wait for the card)
    from torch.profiler import ProfilerActivity, profile

    eval_step = make_eval_step(bundle, cfg)
    n_eval = 60
    ev_loader = DataLoader(
        ArraySource(synthetic_images(n_eval, seed=31)),
        Manifest(np.array([str(i) for i in range(n_eval)], object),
                 np.random.default_rng(32).integers(0, cfg.num_classes, n_eval)),
        batch_size=64, sampler=SequentialSampler(n_eval), device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        metrics = evaluate(eval_step, state, ev_loader)
    pageable = sum(e.count for e in prof.key_averages()
                   if "HtoD (Pageable -> Device)" in e.key)
    print(f"eval on the EMA weights: loss {metrics['loss']:.5f} accuracy "
          f"{metrics['accuracy']:.4f} macro F1 {metrics['macro_f1']:.4f}; "
          f"Memcpy HtoD (Pageable -> Device) in the profiled eval: {pageable}",
          flush=True)
    require(np.isfinite(metrics["loss"]), "non-finite eval loss")
    require(int(metrics["confusion"].sum()) == n_eval, "eval counted padding rows")
    require(pageable == 0, f"{pageable} pageable host-to-device copies in the eval")
    return {"images_per_s": TRAIN_STEPS * cfg.batch_size / wall,
            "aug_off_images_per_s": aug_off_ips, "peak_mem_gib": peak_gib,
            "device_ms": dev_ms, **check}


def time_entry_step(cfg, use_ema: bool = True) -> dict:
    """``make_train_step`` of a train entry's model (ConvNeXt-L on V4,
    ConvNeXt-B on V2, EfficientNet-B0 on V1, V2-S on V3.1 or ViT-B/16 on
    the V2 ensemble; aug and mix on, seeded weights; the EMA update with
    ``use_ema``) alone: the host clock over TRAIN_STEPS steps after
    TRAIN_WARMUP, then one profiled step, without the loop's loader,
    validation and checkpoint writes around it. (``utils/profiler.py:
    device_ms`` cannot time a whole step: its thousands of launches fill
    the card's launch queue behind the spin kernel, and the host blocks.)"""
    bundle = train_model(cfg, "cuda")
    tx = build_optimizer(cfg, build_lr_schedule(cfg, STEPS_PER_EPOCH))
    train_step = make_train_step(bundle, cfg, tx, build_criterion(cfg))
    gen = torch.Generator(device="cuda").manual_seed(24)

    def step(state, batch):
        return train_step(state, batch, generator=gen)

    state = create_train_state(bundle.module, use_ema=use_ema)
    n = TRAIN_WARMUP + TRAIN_STEPS + 2
    images, labels = train_inputs(cfg, n * cfg.batch_size, seed=25)
    batches = [{"image": images[i::n].cuda(), "label": labels[i::n].cuda()}
               for i in range(n)]
    for b in batches[:TRAIN_WARMUP]:
        state, _ = step(state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    for b in batches[TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_STEPS]:
        state, m = step(state, b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    require(np.isfinite(float(m["loss"])), f"non-finite {cfg.model_name} train loss")
    want = expected_launches(cfg, TRAIN_STEPS, 0)
    require(launches == want, f"launches {launches}, expected {want}")
    print(f"{cfg.model_name} train step alone: {TRAIN_STEPS * cfg.batch_size / wall:.2f} "
          f"images/s ({TRAIN_STEPS} steps of {cfg.batch_size} in {wall:.3f} s), peak "
          f"memory {peak_gib:.3f} GiB, launches a step "
          f"{ {k: v / TRAIN_STEPS for k, v in launches.items()} }", flush=True)
    step_ms = wall * 1e3 / TRAIN_STEPS
    dev_ms, rows = profile_train_step(step, state, batches[-2:], step_ms, top=20)
    return {"images_per_s": TRAIN_STEPS * cfg.batch_size / wall, "device_ms": dev_ms,
            "idle": max(0.0, 1 - dev_ms / step_ms), "peak_mem_gib": peak_gib,
            "wall_ms": step_ms, "kernels": rows}


def train_rate_without_aug(bundle, cfg, tx, state, batches) -> float:
    """The timed batches augmented and mixed beforehand, then the same number
    of steps with ``aug_enabled=false`` on them (integer labels): the train
    rate without the aug on the same host in the same run, which the host's
    speed, different from call to call, does not confound. Timing only."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    augment = make_batch_augment(cfg)
    pre = [{"image": augment(b, generator=gen)[0], "label": b["label"]}
           for b in batches]
    off = cfg.replace(aug_enabled=False)
    step = make_train_step(bundle, off, tx, build_criterion(off))
    state, _ = step(state, pre[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in pre:
        state, _ = step(state, b)
    torch.cuda.synchronize()
    rate = len(pre) * cfg.batch_size / (time.perf_counter() - t0)
    print(f"train with the aug off (the same batches augmented beforehand): "
          f"{rate:.2f} images/s", flush=True)
    return rate


def synthetic_test_set(cfg) -> tuple[list[str], np.ndarray]:
    """100 uint8 60x80 images from a numpy seed (a random colour per image
    plus noise), a test CSV with zero-padded numeric ids, and the
    decoded-image cache ``cli predict`` reads."""
    images = synthetic_images(N_IMAGES, seed=0)
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
    return [seeded_model(cfg, seed).module.to(device) for seed in FOLD_SEEDS]


def run_slice() -> dict:
    """Phase 4: the predict slice on the card, then its f32 plain reference."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return _run_slice(tmp)


def _run_slice(tmp: str) -> dict:
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
    reset_launches()
    t0 = time.perf_counter()
    cli.main(["predict", "--config", os.path.join(REPO, "configs", "v4.json"),
              "--folds", "1,2", f"test_csv={cfg.test_csv}",
              f"test_dir={cfg.test_dir}", f"cache_dir={cfg.cache_dir}",
              f"model_save_path={cfg.model_save_path}",
              f"submission_path={cfg.submission_path}"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_launches()
    forwards = len(FOLD_SEEDS) * -(-N_IMAGES // 64)
    per_forward = {"dwconv": sum(DEPTHS), "block_mlp": sum(DEPTHS[:3]),
                   "gelu": DEPTHS[3], "dwconv_bwd": 0, "block_mlp_bwd": 0,
                   "gelu_bwd": 0, "warp": 0, "dwconv_wgrad": 0}
    print(f"cli predict: {cli_s:.3f} s, launches {launches}, "
          f"{forwards} forwards", flush=True)
    for k, n in per_forward.items():
        require(launches[k] == n * forwards, f"{k}: {launches[k]} launches")
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


def entry_labels() -> np.ndarray:
    """ENTRY_TRAIN labels over 44 classes with a long tail, shuffled."""
    k = 44
    share = 0.9 ** np.arange(k)
    counts = 1 + np.floor((ENTRY_TRAIN - k) * share / share.sum()).astype(int)
    counts[0] += ENTRY_TRAIN - counts.sum()
    labels = np.repeat(np.arange(k), counts)
    return labels[np.random.default_rng(81).permutation(ENTRY_TRAIN)]


def write_entry_data(cfg, labels: np.ndarray) -> None:
    """The train and test CSVs (zero-padded numeric ids) and their decode
    caches, uint8 60x80 images from numpy seeds."""
    for path, dir_, n, col, seed in (
            (cfg.train_csv, cfg.train_dir, ENTRY_TRAIN, "target", 82),
            (cfg.test_csv, cfg.test_dir, ENTRY_TEST, "predict", 83)):
        vals = labels if col == "target" else np.zeros(n, int)
        with open(path, "w") as f:
            f.write(f"id,{col}\n" + "".join(f"{i:04d},{v}\n" for i, v in enumerate(vals)))
        ids = Manifest.from_csv(path, is_test=col == "predict").ids
        save_decode_cache(dir_, ids, synthetic_images(n, seed), cfg.cache_dir)


def run_train_entry(kernels: list[dict]) -> dict:
    """Phase 5: ``cli train`` (ConvNeXt-L, 2 folds x 2 epochs), then
    ``cli predict`` on its checkpoints."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_entry_") as tmp:
        return _run_train_entry(tmp, kernels)


def _run_train_entry(tmp: str, kernels: list[dict]) -> dict:
    v4 = os.path.join(REPO, "configs", "v4.json")
    overrides = [
        f"train_csv={tmp}/train.csv", f"train_dir={tmp}/train",
        f"test_csv={tmp}/test.csv", f"test_dir={tmp}/test",
        f"cache_dir={tmp}/cache", f"model_save_path={tmp}/models",
        f"output_dir={tmp}/out", f"submission_path={tmp}/submission.csv",
        f"model_name={ENTRY_MODEL}", f"num_folds={ENTRY_FOLDS}",
        f"epochs={ENTRY_EPOCHS}",
    ]
    cfg = load_config(v4, overrides)
    labels = entry_labels()
    write_entry_data(cfg, labels)
    free_gib = shutil.disk_usage(tmp).free / 2**30
    print(f"train entry: {ENTRY_MODEL}, {ENTRY_TRAIN} train / {ENTRY_TEST} test "
          f"images, {np.bincount(labels, minlength=44).tolist()} a class; "
          f"{free_gib:.1f} GiB free under {tmp}", flush=True)

    # Main path, through the user's entry point. Counters from 0 right before.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    cli.main(["train", "--config", v4, *overrides])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    with open(os.path.join(cfg.output_dir, "train.log")) as f:
        log = f.read()
    require("failed; continuing" not in log, "a fold failed:\n" + log[-4000:])
    with open(os.path.join(cfg.output_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    require(len(records) == ENTRY_FOLDS * ENTRY_EPOCHS,
            f"metrics.jsonl has {len(records)} lines")
    require(all(np.isfinite([r["train_loss"], r["val_loss"]]).all() for r in records),
            "non-finite loss in metrics.jsonl")
    for fold in range(1, ENTRY_FOLDS + 1):
        for name in (f"best_model_fold{fold}.pt", f"best_model_fold{fold}.json",
                     f"best_loss_model_fold{fold}.pt", f"best_loss_model_fold{fold}.json"):
            require(os.path.exists(os.path.join(cfg.model_save_path, name)), f"no {name}")
        require(os.path.exists(os.path.join(cfg.output_dir, f"train_state_fold{fold}.pt")),
                f"no train_state_fold{fold}.pt")
    with open(cfg.submission_path) as f:
        sub = f.read().splitlines()
    require(sub[0] == "id,target" and len(sub) == ENTRY_TEST + 1,
            f"submission has {len(sub)} lines, header {sub[:1]}")

    # Launches: per optimizer step two microbatches forward and backward,
    # each depthwise backward as the forward on g plus the wgrad; per
    # validation batch and per fold model's test batch one forward.
    steps = sum(r["steps"] for r in records)
    val_sizes = [len(v) for _, v in stratified_kfold(labels, ENTRY_FOLDS, cfg.fold_seed)]
    val_batch = cfg.batch_size * cfg.val_batch_multiplier
    forwards = (ENTRY_EPOCHS * sum(-(-n // val_batch) for n in val_sizes)
                + ENTRY_FOLDS * -(-ENTRY_TEST // (cfg.batch_size * cfg.infer_batch_multiplier)))
    want = expected_launches(cfg, steps, forwards)
    print(f"cli train: {train_s:.3f} s, {steps} optimizer steps, {forwards} "
          f"forwards without gradient, launches {launches}; per optimizer step "
          f"the wgrad kernel {launches['dwconv_wgrad'] / steps:g}; peak memory "
          f"{peak_gib:.3f} GiB", flush=True)
    for name, n in want.items():
        require(launches[name] == n, f"{name}: {launches[name]} launches, expected {n}")
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
    for r in records:
        print(f"  fold {r['fold']} epoch {r['epoch'] + 1}: train loss {r['train_loss']:.4f} "
              f"val loss {r['val_loss']:.4f} val acc {r['val_acc']:.4f}; "
              f"{r['images_per_sec']} images/s, duty cycle {r['duty_cycle']}, "
              f"{r['steps']} steps in {r['wall_time_s']} s", flush=True)

    # The saved checkpoints through ``cli predict``: the same predictions.
    t0 = time.perf_counter()
    cli.main(["predict", "--config", v4, "--folds", ",".join(
        str(k) for k in range(1, ENTRY_FOLDS + 1)), *overrides,
        f"submission_path={tmp}/predict.csv"])
    predict_s = time.perf_counter() - t0
    with open(f"{tmp}/predict.csv") as f:
        again = f.read().splitlines()
    require(again[0] == "id,predict" and again[1:] == sub[1:],
            "cli predict on the saved checkpoints differs from the train run's "
            "submission")
    print(f"cli predict on the saved checkpoints: {predict_s:.3f} s, "
          f"{ENTRY_TEST} rows equal to the train run's submission", flush=True)
    step = time_entry_step(cfg)
    check = check_train_step(load_config(v4).replace(model_name=ENTRY_MODEL,
                                                     batch_size=REF_BATCH))
    return {"train_s": train_s, "peak_mem_gib": peak_gib,
            "images_per_s": [r["images_per_sec"] for r in records],
            "duty_cycle": [r["duty_cycle"] for r in records], "step": step,
            "step_check": check}


# ---------------------------------------------------------------- V2
def check_v2_kernels(stage_hw=V2_STAGE_HW, over: list[str] = (), tag: str = "V2",
                     seed: int = 4321) -> None:
    """Every kernel of ConvNeXt-B on the V2 path at its shapes (batch 64 on
    maps of ``stage_hw``, forward and backward; stage 3 on the composed
    route), and the warp at its launch shapes (``check_warp``: the
    geometric warp from 60x80 to ``over``'s image size once a step, then
    RandAugment's 3 slots on an image of that size); printed under ``tag``,
    with the sums of one optimizer step."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = KernelTable()
    depths, dims = CONVNEXT_CONFIGS[V2_MODEL]
    for stage, (hw, c, depth) in enumerate(zip(stage_hw, dims, depths)):
        print(f"{tag} {V2_MODEL} stage {stage} ({hw[0]}x{hw[1]}):", flush=True)
        check_stage(table, gen, stage, hw, c, V2_BATCH, depth, bwd_batch=V2_BATCH)
    check_warp(table, gen, "v2_convbase.json", V2_BATCH, over=over)
    for e in table.entries(KERNEL_META):
        print(f"{tag} per optimizer step: {e['name']} kernel {e['ms']:.4f} ms, plain "
              f"{e['plain_ms']:.4f} ms, library "
              f"{'-' if e['library_ms'] is None else format(e['library_ms'], '.4f')} ms, "
              f"bound {e['bound_ms']:.4f} ms ({e['bound_by']})", flush=True)


def check_randaug(v2) -> dict:
    """V2's aug + mix with ``randaugment_prob=1`` on N_AUG uint8 60x80
    images: the card in f32 and in bf16 against the host in f32, from the
    same draws (made on the card). The drawn op ids are replaced by
    (3 b + slot) mod 15 and every slot applies, so each of the 15 ops runs
    on 6 or 7 of the 96 slots; magnitudes and signs stay as drawn. Each
    card call launches the warp 1 + 3 times."""
    cfg = v2.replace(randaugment_prob=1.0)
    n_ops = cfg.randaugment_num_ops
    images, labels = train_inputs(cfg, N_AUG, seed=91)
    d = draw_train_step(torch.Generator(device="cuda").manual_seed(92),
                        tuple(images.shape), cfg)
    ra = d.aug.randaug
    ids = (torch.arange(N_AUG, device="cuda")[:, None] * n_ops
           + torch.arange(n_ops, device="cuda")) % NUM_OPS
    d = d._replace(aug=d.aug._replace(randaug=ra._replace(
        op_ids=ids, applies=torch.ones_like(ra.applies))))
    require(bool(d.aug.randaug.gate.all()), "randaugment_prob=1 left a gate off")
    host = make_batch_augment(cfg.replace(compute_dtype="float32"))(
        {"image": images, "label": labels}, draws=draws_to(d, "cpu"))
    std = torch.tensor(cfg.std) * 255.0
    stats = {}
    for dtype in ("float32", "bfloat16"):
        reset_launches()
        card = make_batch_augment(cfg.replace(compute_dtype=dtype))(
            {"image": images.cuda(), "label": labels.cuda()}, draws=d)
        torch.cuda.synchronize()
        warps = warp.launches
        require(card[0].dtype == getattr(torch, dtype) and bool(torch.isfinite(card[0]).all()),
                f"RandAugment {dtype}: {card[0].dtype}, finite {torch.isfinite(card[0]).all()}")
        diff = (card[0].float().cpu() - host[0]).abs() * std
        lab = (card[1].cpu() - host[1]).abs().max().item()
        st = {"max": diff.max().item(), "mean": diff.mean().item(),
              "beyond_1": (diff > 1).float().mean().item(),
              "beyond_40": (diff > 40).float().mean().item(), "warps": warps}
        stats[dtype] = st
        print(f"V2 aug + mix with RandAugment (all 15 ops), {dtype} card vs f32 host: "
              f"max |d| {st['max']:.4f} grey levels, mean {st['mean']:.6f}, share "
              f"beyond 1 level {st['beyond_1']:.3g}, beyond 40 {st['beyond_40']:.3g}; "
              f"soft labels max |d| {lab:.3g}; warp launches {warps}", flush=True)
        require(warps == 1 + n_ops, f"{warps} warp launches, expected {1 + n_ops}")
        require(lab <= LABEL_TOL, f"soft labels differ by {lab}")
        if dtype == "float32":
            require(st["mean"] <= RA_F32_MEAN_GREY and st["beyond_1"] <= RA_F32_SHARE_BEYOND_1,
                    f"RandAugment f32 card vs host: {st}")
        else:
            require(st["mean"] <= RA_BF16_MEAN_GREY
                    and st["beyond_40"] <= RA_BF16_SHARE_BEYOND_40,
                    f"RandAugment bf16 card vs f32 host: {st}")
    return stats


def run_v2() -> dict:
    """Phase 6: V2 through ``cli train`` and ``cli predict`` (K-fold, then
    ``--best-fold``), the V2 step alone, then the entry options (holdout,
    dataset stats, freeze_stages=1) and one frozen step against the host."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_v2_") as tmp:
        return _run_v2(tmp)


def _v2_train(tmp: str, tag: str, extra: list[str]) -> tuple[object, list[str], dict, dict]:
    """``cli train`` on V2 with ``extra`` overrides into ``tmp/tag``, the
    counts from 0 right before; returns the config, its overrides, the
    launches and the run's figures."""
    over = [f"train_csv={tmp}/train.csv", f"train_dir={tmp}/train",
            f"test_csv={tmp}/test.csv", f"test_dir={tmp}/test", f"cache_dir={tmp}/cache",
            f"model_save_path={tmp}/{tag}/models", f"output_dir={tmp}/{tag}/out",
            f"submission_path={tmp}/{tag}/submission.csv", *V2_OVERRIDES, *extra]
    cfg = load_config(V2_CONFIG, over)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    cli.main(["train", "--config", V2_CONFIG, *over])
    torch.cuda.synchronize()
    figures = {"train_s": time.perf_counter() - t0,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    launches = read_launches()
    with open(os.path.join(cfg.output_dir, "train.log")) as f:
        log = f.read()
    require("failed; continuing" not in log, "a V2 fold failed:\n" + log[-4000:])
    with open(os.path.join(cfg.output_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    require(all(np.isfinite([r["train_loss"], r["val_loss"]]).all() for r in records),
            "non-finite loss in metrics.jsonl")
    sub = read_submission(cfg.submission_path)
    require(sub[0] == "id,target" and len(sub) == ENTRY_TEST + 1,
            f"submission has {len(sub)} lines, header {sub[:1]}")
    figures.update(records=records, steps=sum(r["steps"] for r in records))
    for r in records:
        print(f"  V2 {tag} fold {r['fold']} epoch {r['epoch'] + 1}: train loss "
              f"{r['train_loss']:.4f} val loss {r['val_loss']:.4f} val acc "
              f"{r['val_acc']:.4f}; {r['images_per_sec']} images/s, duty cycle "
              f"{r['duty_cycle']}, {r['steps']} steps in {r['wall_time_s']} s", flush=True)
    return cfg, over, launches, figures


def _v2_predict(over: list[str], out: str, *flags: str) -> list[str]:
    cli.main(["predict", "--config", V2_CONFIG, *flags, *over, f"submission_path={out}"])
    return read_submission(out)


def _run_v2(tmp: str) -> dict:
    labels = entry_labels()
    cfg = load_config(V2_CONFIG, [f"train_csv={tmp}/train.csv", f"train_dir={tmp}/train",
                                  f"test_csv={tmp}/test.csv", f"test_dir={tmp}/test",
                                  f"cache_dir={tmp}/cache", *V2_OVERRIDES])
    require(cfg.model_name == V2_MODEL and cfg.batch_size == V2_BATCH
            and tuple(cfg.image_size) == NATIVE and cfg.use_randaugment
            and cfg.tta_mode == "flip6" and not cfg.use_ema
            and not cfg.use_deep_supervision and cfg.gradient_accumulation_steps == 1,
            "configs/v2_convbase.json no longer trains ConvNeXt-B at 60x80 with "
            "RandAugment, batch 64, flip6 TTA")
    write_entry_data(cfg, labels)
    val_batch = cfg.batch_size * cfg.val_batch_multiplier
    test_batches = -(-ENTRY_TEST // (cfg.batch_size * cfg.infer_batch_multiplier))

    # 1. K-fold: the main path, through the user's entry points
    cfg, over, launches, run = _v2_train(tmp, "kfold", [f"num_folds={V2_FOLDS}",
                                                         f"epochs={V2_EPOCHS}"])
    require(len(run["records"]) == V2_FOLDS * V2_EPOCHS,
            f"metrics.jsonl has {len(run['records'])} lines")
    val_sizes = [len(v) for _, v in stratified_kfold(labels, V2_FOLDS, cfg.fold_seed)]
    forwards = (V2_EPOCHS * sum(-(-n // val_batch) for n in val_sizes)
                + V2_FOLDS * test_batches)
    want = expected_launches(cfg, run["steps"], forwards)
    print(f"V2 cli train: {run['train_s']:.3f} s, {run['steps']} optimizer steps, "
          f"{forwards} forwards without gradient, peak memory "
          f"{run['peak_mem_gib']:.3f} GiB, launches {launches}", flush=True)
    require(launches == want, f"V2 launches {launches}, expected {want}")
    sub = read_submission(cfg.submission_path)
    folds = ",".join(str(k) for k in range(1, V2_FOLDS + 1))
    again = _v2_predict(over, f"{tmp}/kfold/predict.csv", "--folds", folds)
    require(again[0] == "id,predict" and again[1:] == sub[1:],
            "V2 cli predict (flip6) differs from cli train's submission")
    best, score = select_best_fold(cfg.model_save_path, list(range(1, V2_FOLDS + 1)))
    picked = _v2_predict(over, f"{tmp}/kfold/best.csv", "--folds", folds, "--best-fold")
    alone = _v2_predict(over, f"{tmp}/kfold/alone.csv", "--folds", str(best))
    require(picked == alone, f"--best-fold did not predict with fold {best}")
    print(f"V2 cli predict --folds {folds} (flip6): {ENTRY_TEST} rows equal to the "
          f"train run's submission; --best-fold predicts as --folds {best} "
          f"(val acc {score:.4f})", flush=True)
    step = time_entry_step(cfg)

    # 2. the entry options: holdout, dataset stats, stem and stage 0 frozen.
    # A stratified split needs a val place for each of the 44 classes: 0.2
    # of the ~270 oversampled images (sklearn, and so both packages, refuse
    # the default 0.1 there)
    hcfg, hover, hl, hrun = _v2_train(tmp, "holdout", [
        "split_mode=holdout", "val_fraction=0.2", "norm_stats=dataset",
        "freeze_stages=1", "epochs=1"])
    with open(os.path.join(hcfg.model_save_path, NORM_STATS_FILE)) as f:
        saved = json.load(f)
    mean, std = compute_channel_stats(ArraySource(synthetic_images(ENTRY_TRAIN, seed=82)))
    require(tuple(saved["mean"]) == mean and tuple(saved["std"]) == std,
            f"norm_stats.json {saved} against {mean} {std}")
    base = oversample_minority(labels, 2, seed=hcfg.seed)
    n_val = len(stratified_split(labels[base], hcfg.val_fraction, seed=hcfg.seed)[1])
    forwards = -(-n_val // val_batch) + test_batches
    want = expected_launches(hcfg, hrun["steps"], forwards)
    print(f"V2 holdout, dataset stats {saved}, freeze_stages=1: {hrun['train_s']:.3f} s, "
          f"{hrun['steps']} steps, launches {hl}", flush=True)
    require(len(hrun["records"]) == 1, "holdout trained more than one fold-epoch")
    require(hl == want, f"V2 holdout launches {hl}, expected {want}")
    hsub = read_submission(hcfg.submission_path)
    hagain = _v2_predict(hover, f"{tmp}/holdout/predict.csv")
    require(hagain[1:] == hsub[1:],
            "cli predict with norm_stats.json differs from the holdout run's submission")
    print("V2 holdout: cli predict (norm_stats.json) reproduces the submission", flush=True)
    # RandAugment off in this one step: its threshold ops (solarize,
    # posterize, equalize) flip where a bf16 value lies within half a grey
    # level of a threshold, moving card inputs by up to 255 levels from the
    # host's (check_randaug holds that aug in f32 and in bf16); with it on,
    # the step's loss moved by 1.35e-3, and by 5.57e-4 without it, on the
    # first runs on an H100. Every other V2 setting and the freeze stay.
    check = check_train_step(load_config(V2_CONFIG, V2_OVERRIDES).replace(
        freeze_stages=1, batch_size=REF_BATCH, use_randaugment=False))
    return {"train_s": run["train_s"], "peak_mem_gib": run["peak_mem_gib"],
            "images_per_s": [r["images_per_sec"] for r in run["records"]],
            "launches_per_step": {k: v / run["steps"] for k, v in launches.items()},
            "step": step, "frozen_step_check": check}

# ---------------------------------------------------------------- data edge
def host_probe() -> dict:
    """What the host offers to build a JPEG library on."""
    from torch.utils.cpp_extension import CUDA_HOME

    gxx = subprocess.run([native.CXX, "--version"], capture_output=True, text=True)
    ld = (subprocess.run(["ldconfig", "-p"], capture_output=True, text=True).stdout
          if shutil.which("ldconfig") else "")
    return {"g++": gxx.stdout.splitlines()[0] if gxx.returncode == 0 else None,
            "jpeglib.h": native.has_header("jpeglib.h"),
            "ldconfig jpeg": [line.split(" => ")[0].strip() for line in ld.splitlines()
                              if "jpeg" in line.lower()],
            "nvjpeg.h": bool(CUDA_HOME) and os.path.exists(
                os.path.join(CUDA_HOME, "include", "nvjpeg.h"))}


def check_fixture(version: str) -> dict:
    """The committed JPEG fixture through ``ImageSource``: its bytes exactly
    with libjpeg-turbo, else within the nvJPEG bounds; the corrupt file and
    the missing id take the black fallback; the PNG raises."""
    fixture = os.path.join(os.path.dirname(native.__file__), "fixtures", "jpeg")
    expected = np.load(os.path.join(fixture, "expected.npz"))
    ids = [str(i) for i in expected["ids"]]
    got = ImageSource(fixture, ids, NATIVE).get_batch(np.arange(len(ids)))
    diff = np.abs(got.astype(np.int32) - expected["images"].astype(np.int32))
    means = diff.reshape(len(ids), -1).mean(axis=1)
    stats = {"max": int(diff.max()), "mean_by_image": [round(float(m), 4) for m in means]}
    print(f"data: JPEG fixture ({len(ids)} ids) decoded by {version} against its committed "
          f"libjpeg-turbo bytes: max |d| {stats['max']} grey levels, mean by image "
          f"{stats['mean_by_image']}", flush=True)
    if "libjpeg-turbo" in version:
        require(stats["max"] == 0, f"libjpeg-turbo decode differs from the fixture: {stats}")
    else:
        require(stats["max"] <= FIXTURE_MAX_GREY and means.max() <= FIXTURE_MEAN_GREY,
                f"fixture decode beyond max {FIXTURE_MAX_GREY} / mean {FIXTURE_MEAN_GREY}: "
                f"{stats}")
    for id_ in ("corrupt", "missing"):
        require(not got[ids.index(id_)].any(), f"{id_}: not the black fallback")
    raised = False
    try:
        ImageSource(fixture, [*ids, "pic"], NATIVE)
    except NotImplementedError:
        raised = True
    require(raised, "a PNG did not raise NotImplementedError")
    return stats


def decode_rate(paths: list[str]) -> float:
    """Images/s of ``native.decode_batch`` at DECODE_THREADS, files in the
    page cache: the best of 3 passes after a warm one."""
    out = np.empty((len(paths), *NATIVE, 3), np.uint8)
    require(bool(native.decode_batch(paths, out, DECODE_THREADS).all()), "a JPEG failed")
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        native.decode_batch(paths, out, DECODE_THREADS)
        best = min(best, time.perf_counter() - t0)
    return len(paths) / best


def _data_train(config: str, over: list[str], n_test: int) -> tuple[object, dict, dict]:
    """``cli train`` of ``config`` with ``over``, the counts from 0 right
    before; returns the config, the launches and the run's figures."""
    cfg = load_config(config, over)
    torch.cuda.empty_cache()
    reset_launches()
    t0 = time.perf_counter()
    cli.main(["train", "--config", config, *over])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_launches()
    with open(os.path.join(cfg.output_dir, "train.log")) as f:
        log = f.read()
    require("failed; continuing" not in log, "a fold failed:\n" + log[-4000:])
    with open(os.path.join(cfg.output_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    require(all(np.isfinite([r["train_loss"], r["val_loss"]]).all() for r in records),
            "non-finite loss in metrics.jsonl")
    sub = read_submission(cfg.submission_path)
    require(sub[0] == "id,target" and len(sub) == n_test + 1,
            f"submission has {len(sub)} lines, header {sub[:1]}")
    return cfg, launches, {"train_s": train_s, "records": records, "submission": sub,
                           "steps": sum(r["steps"] for r in records)}


def _forwards(cfg, labels: np.ndarray, n_test: int) -> int:
    """Forwards without gradient of one ``cli train``: per epoch one a
    validation batch, then one a test batch for each fold model."""
    if cfg.split_mode == "holdout":
        base = oversample_minority(labels, 2, seed=cfg.seed)
        val_sizes = [len(stratified_split(labels[base], cfg.val_fraction, seed=cfg.seed)[1])]
    else:
        val_sizes = [len(v) for _, v in stratified_kfold(labels, cfg.num_folds, cfg.fold_seed)]
    val_batch = cfg.batch_size * cfg.val_batch_multiplier
    test_batches = -(-n_test // (cfg.batch_size * cfg.infer_batch_multiplier))
    return (cfg.epochs * sum(-(-n // val_batch) for n in val_sizes)
            + len(val_sizes) * test_batches)


def run_data() -> dict:
    """Phase 7: the data edge. The host probe and the library, the JPEG
    fixture, a hard set rendered and written as JPEGs, the decode rate; then
    V2 ``cli train`` straight from the JPEGs in memory and through the
    decode cache (whose bytes must be the in-memory decode's, and which is
    then reused), ``cli predict``; then V4 ConvNeXt-B ``cli train`` at
    ``prefetch_depth`` 0 and 2."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
        return _run_data(tmp)


def _run_data(tmp: str) -> dict:
    probe = host_probe()
    so, build_s = native.build()
    version = native.lib_version()
    print(f"data: host probe {probe}; JPEG library: the {native.recipe().name} build, "
          f"{version}, built in {build_s:.2f} s -> {os.path.relpath(so, REPO)}", flush=True)
    out = {"probe": probe, "library": version, "fixture": check_fixture(version)}

    root = os.path.join(tmp, "hard")
    t0 = time.perf_counter()
    made = make_hard_synthetic_dataset(root, n_train=DATA_TRAIN, n_test=DATA_TEST,
                                       native_size=NATIVE, seed=0)
    out["write_s"] = time.perf_counter() - t0
    out["render_s"], out["encode_s"] = made["seconds"]["render"], made["seconds"]["encode"]
    train_ids = Manifest.from_csv(made["train_csv"]).ids
    paths = [os.path.join(made["train_dir"], f"{i}.jpg") for i in train_ids]
    out["decode_images_per_s"] = decode_rate(paths)
    print(f"data: hard set of {DATA_TRAIN} train + {DATA_TEST} test JPEGs at 60x80 in "
          f"{out['write_s']:.3f} s (render {out['render_s']:.3f} s, encode "
          f"{out['encode_s']:.3f} s); decode {out['decode_images_per_s']:.1f} images/s "
          f"at {DECODE_THREADS} threads", flush=True)
    labels = np.asarray(made["train_labels"])
    data = [f"train_csv={made['train_csv']}", f"train_dir={made['train_dir']}",
            f"test_csv={made['test_csv']}", f"test_dir={made['test_dir']}",
            f"cache_dir={tmp}/cache"]

    def paths_of(tag):
        return [f"model_save_path={tmp}/{tag}/models", f"output_dir={tmp}/{tag}/out",
                f"submission_path={tmp}/{tag}/submission.csv"]

    # V2 from the JPEGs, decoded in memory, then through the decode cache:
    # the main path of this phase, through the user's entry points.
    runs = {}
    for tag, cached in (("v2_memory", "false"), ("v2_cache", "true")):
        over = [*data, *paths_of(tag), *V2_OVERRIDES, *DATA_V2, f"use_decode_cache={cached}"]
        cfg, launches, run = _data_train(V2_CONFIG, over, DATA_TEST)
        want = expected_launches(cfg, run["steps"], _forwards(cfg, labels, DATA_TEST))
        require(launches == want, f"{tag}: launches {launches}, expected {want}")
        runs[tag] = run
        for r in run["records"]:
            print(f"  {tag} fold {r['fold']}: train loss {r['train_loss']:.4f} val acc "
                  f"{r['val_acc']:.4f}; {r['images_per_sec']} images/s, duty cycle "
                  f"{r['duty_cycle']}", flush=True)
        print(f"data: V2 cli train ({tag}): {run['train_s']:.3f} s, {run['steps']} steps, "
              f"launches as expected {launches}", flush=True)
    key = decode_cache_key(made["train_dir"], train_ids, NATIVE)
    cache_file = os.path.join(tmp, "cache", f"imgs_{key}.u8")
    memory = ImageSource(made["train_dir"], train_ids, NATIVE).images
    cached_bytes = np.fromfile(cache_file, np.uint8).reshape(memory.shape)
    require(np.array_equal(cached_bytes, memory),
            "the decode cache's bytes differ from the in-memory decode")
    os.rename(made["train_dir"], made["train_dir"] + ".away")   # no decoding from here
    reused = ImageSource(made["train_dir"], train_ids, NATIVE, cache_dir=f"{tmp}/cache")
    os.rename(made["train_dir"] + ".away", made["train_dir"])
    require(isinstance(reused.images, np.memmap) and np.array_equal(reused.images, memory),
            "the decode cache was not reused")
    same = runs["v2_memory"]["submission"][1:] == runs["v2_cache"]["submission"][1:]
    over = [*data, *paths_of("v2_cache"), *V2_OVERRIDES, *DATA_V2]
    again = _v2_predict(over, f"{tmp}/v2_cache/predict.csv", "--folds", "1,2")
    require(again[0] == "id,predict" and again[1:] == runs["v2_cache"]["submission"][1:],
            "V2 cli predict from the JPEGs differs from cli train's submission")
    print(f"data: the decode cache ({os.path.getsize(cache_file)} bytes) equals the in-memory "
          f"decode and is reused without the JPEGs; cli predict reproduces the "
          f"submission; the in-memory and the cached runs' submissions are "
          f"{'equal' if same else 'NOT equal'}", flush=True)
    out["v2_train_s"] = {k: v["train_s"] for k, v in runs.items()}

    # V4 ConvNeXt-B from the same JPEGs (the cache reused), prefetch 0 then 2
    v4 = os.path.join(REPO, "configs", "v4.json")
    out["v4_loop"] = {}
    for depth in (0, 2):
        tag = f"v4_prefetch{depth}"
        over = [*data, *paths_of(tag), *DATA_V4, f"prefetch_depth={depth}"]
        cfg, launches, run = _data_train(v4, over, DATA_TEST)
        require(cfg.model_name == MODEL and cfg.use_deep_supervision,
                "configs/v4.json no longer trains ConvNeXt-B with deep supervision")
        want = expected_launches(cfg, run["steps"], _forwards(cfg, labels, DATA_TEST))
        require(launches == want, f"{tag}: launches {launches}, expected {want}")
        r = run["records"][0]
        out["v4_loop"][depth] = {"images_per_s": r["images_per_sec"],
                                 "duty_cycle": r["duty_cycle"], "steps": r["steps"],
                                 "wall_s": r["wall_time_s"], "train_s": run["train_s"]}
        print(f"data: V4 {MODEL} cli train, prefetch_depth={depth}: loop {r['images_per_sec']} "
              f"images/s, duty cycle {r['duty_cycle']}, {r['steps']} steps in "
              f"{r['wall_time_s']} s; val acc {r['val_acc']:.4f}; cli train "
              f"{run['train_s']:.3f} s", flush=True)
    return out


# ---------------------------------------------------------------- EfficientNet
def check_effnet_step(cfg) -> dict:
    """The gradient half of one train step of ``cfg``'s EfficientNet on
    REF_BATCH uint8 images (``train/step.py:accumulate_grads``: train mode,
    the drop masks), on the card in bf16 and in f32 against the host in
    f32, from the same seeded weights and the same inputs: the aug and mix
    run once, on the host in f32, from draws made on the card (the aug is
    held by ``check_aug``). The loss and BatchNorm's running statistics
    after the step (their change from the start, over every BatchNorm) are
    held to their bounds; the gradients' rel. L2 is printed beside them."""
    cfg32 = cfg.replace(compute_dtype="float32")
    images, labels = train_inputs(cfg, REF_BATCH, seed=13)
    draws, x, targets, runs = None, None, None, {}
    for name, c, device in (("card", cfg, "cuda"), ("card_f32", cfg32, "cuda"),
                            ("host", cfg32, "cpu")):
        bundle = train_model(c, device)
        model = bundle.module
        if draws is None:
            draws = draw_train_step(torch.Generator(device="cuda").manual_seed(14),
                                    tuple(images.shape), cfg, drop_sites(model))
            x, targets = make_batch_augment(cfg32)(
                {"image": images, "label": labels}, draws=draws_to(draws, "cpu"))
        stats0 = {k: v.clone() for k, v in model.named_buffers()}
        grads, m = accumulate_grads(model, c, build_criterion(c), x.to(device),
                                    targets.to(device), labels.to(device),
                                    drop=draws_to(draws.drop, device))
        runs[name] = {
            "loss": float(m["loss"]),
            "stats": [(v - stats0[k]).cpu() for k, v in model.named_buffers()],
            "grads": [g.float().cpu() for g in grads],
        }
        del bundle, model, grads
        torch.cuda.empty_cache()
    host = runs["host"]
    out = {}
    for name in ("card", "card_f32"):
        run = runs[name]
        out[name] = {"loss_rel": abs(run["loss"] - host["loss"]) / abs(host["loss"]),
                     "stats_rel_l2": rel_l2(run["stats"], host["stats"]),
                     "grad_rel_l2": rel_l2(run["grads"], host["grads"])}
    masks = sum(int(t.numel()) for mb in draws.drop for t in mb)
    print(f"{cfg.model_name} train step vs f32 host step ({REF_BATCH} images, {masks} "
          f"drop-mask entries): loss {runs['card']['loss']:.6f} (bf16) / "
          f"{runs['card_f32']['loss']:.6f} (f32) on the card vs {host['loss']:.6f}; "
          f"bf16 {out['card']} (bounds {EFF_LOSS_REL_TOL}, {EFF_STATS_REL_L2}); "
          f"f32 {out['card_f32']} (bounds {EFF_F32_LOSS_REL_TOL}, "
          f"{EFF_F32_STATS_REL_L2})", flush=True)
    require(np.isfinite(runs["card"]["loss"]), "non-finite EfficientNet loss on the card")
    for name, loss_tol, stats_tol in (("card", EFF_LOSS_REL_TOL, EFF_STATS_REL_L2),
                                      ("card_f32", EFF_F32_LOSS_REL_TOL,
                                       EFF_F32_STATS_REL_L2)):
        require(out[name]["loss_rel"] <= loss_tol and out[name]["stats_rel_l2"] <= stats_tol,
                f"{cfg.model_name} {name} step vs f32 host: {out[name]}")
    return out


def run_effnet(config: str, extra: list[str]) -> dict:
    """Phases 8 and 9: an EfficientNet preset through ``cli train`` (2
    folds) and ``cli predict``, its step alone and its step against the
    host."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_effnet_") as tmp:
        return _run_effnet(tmp, config, extra)


def _run_effnet(tmp: str, config: str, extra: list[str]) -> dict:
    tag = os.path.splitext(os.path.basename(config))[0]
    over = [f"train_csv={tmp}/train.csv", f"train_dir={tmp}/train",
            f"test_csv={tmp}/test.csv", f"test_dir={tmp}/test", f"cache_dir={tmp}/cache",
            f"model_save_path={tmp}/models", f"output_dir={tmp}/out",
            f"submission_path={tmp}/submission.csv", f"num_folds={EFF_FOLDS}", *extra]
    cfg = load_config(config, over)
    labels = entry_labels()
    write_entry_data(cfg, labels)

    # Main path, through the user's entry point. Counters from 0 right before.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    cli.main(["train", "--config", config, *over])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(cfg.output_dir, "train.log")) as f:
        log = f.read()
    require("failed; continuing" not in log, f"a {tag} fold failed:\n" + log[-4000:])
    with open(os.path.join(cfg.output_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    require(len(records) == EFF_FOLDS * cfg.epochs, f"metrics.jsonl has {len(records)} lines")
    require(all(np.isfinite([r["train_loss"], r["val_loss"]]).all() for r in records),
            "non-finite loss in metrics.jsonl")
    swa = [ln.split(" - ")[-1] for ln in log.splitlines() if " SWA (" in ln]
    if cfg.use_swa:
        for fold in range(1, EFF_FOLDS + 1):
            require(any(ln.startswith(f"fold {fold} SWA ({cfg.epochs - cfg.swa_start_epoch + 1}"
                                      " snapshots)") for ln in swa),
                    f"no SWA line for fold {fold} in train.log: {swa}")
    sub = read_submission(cfg.submission_path)
    require(sub[0] == "id,target" and len(sub) == ENTRY_TEST + 1,
            f"submission has {len(sub)} lines, header {sub[:1]}")
    steps = sum(r["steps"] for r in records)
    want = expected_launches(cfg, steps, 0)
    print(f"{tag} ({cfg.model_name}, {cfg.image_size[0]}x{cfg.image_size[1]}, batch "
          f"{cfg.batch_size}) cli train: {train_s:.3f} s, {steps} optimizer steps, "
          f"peak memory {peak_gib:.3f} GiB, launches {launches}", flush=True)
    require(launches == want, f"{tag} launches {launches}, expected {want}")
    for r in records:
        print(f"  {tag} fold {r['fold']} epoch {r['epoch'] + 1}: train loss "
              f"{r['train_loss']:.4f} val loss {r['val_loss']:.4f} val acc "
              f"{r['val_acc']:.4f}; {r['images_per_sec']} images/s, duty cycle "
              f"{r['duty_cycle']}, {r['steps']} steps in {r['wall_time_s']} s", flush=True)
    for ln in swa:
        print(f"  {tag} {ln}", flush=True)
    folds = ",".join(str(k) for k in range(1, EFF_FOLDS + 1))
    cli.main(["predict", "--config", config, "--folds", folds, *over,
              f"submission_path={tmp}/predict.csv"])
    again = read_submission(f"{tmp}/predict.csv")
    require(again[0] == "id,predict" and again[1:] == sub[1:],
            f"{tag} cli predict ({cfg.tta_mode if cfg.tta_transforms else 'no'} TTA) "
            "differs from cli train's submission")
    print(f"{tag} cli predict --folds {folds}: {ENTRY_TEST} rows equal to the train "
          f"run's submission", flush=True)
    step = time_entry_step(cfg, use_ema=cfg.use_ema)
    check = check_effnet_step(cfg.replace(batch_size=REF_BATCH))
    return {"train_s": train_s, "peak_mem_gib": peak_gib, "steps": steps,
            "images_per_s": [r["images_per_sec"] for r in records], "swa": swa,
            "step": step, "step_check": check}


# ---------------------------------------------------------------- V2 ensemble
def check_drop_step(cfg, bounds: dict) -> dict:
    """One optimizer step of ``cfg``'s model with its drop sites live, on
    REF_BATCH uint8 images: the card in bf16 and in f32 against the host in
    f32, from the same seeded weights, the same inputs (augmented and mixed
    once, on the host in f32, from draws made on the card) and the same
    drop masks; the gradient half (``accumulate_grads``), then the fused
    clip + AdamW update (``fused_adamw_ema``) from a fresh state at the end
    of warmup. Each card run's launches must be ``model_launches``' for one
    microbatch. ``bounds``: run name -> (loss rel, gradient rel L2, update
    rel L2)."""
    cfg32 = cfg.replace(compute_dtype="float32")
    tx = build_optimizer(cfg, build_lr_schedule(cfg, STEPS_PER_EPOCH))
    start = int(STEPS_PER_EPOCH * cfg.epochs * cfg.gradient_accumulation_steps
                * cfg.warmup_ratio)
    images, labels = train_inputs(cfg, REF_BATCH, seed=17)
    draws, x, targets, runs = None, None, None, {}
    for name, c, device in (("card", cfg, "cuda"), ("card_f32", cfg32, "cuda"),
                            ("host", cfg32, "cpu")):
        bundle = train_model(c, device)
        model = bundle.module
        if draws is None:
            draws = draw_train_step(torch.Generator(device="cuda").manual_seed(18),
                                    tuple(images.shape), cfg, drop_sites(model))
            x, targets = make_batch_augment(cfg32)(
                {"image": images, "label": labels}, draws=draws_to(draws, "cpu"))
        state = create_train_state(model, use_ema=c.use_ema)
        state.count = state.step = start
        before = [p.detach().clone() for p in state.params()]
        reset_launches()
        grads, m = accumulate_grads(model, c, build_criterion(c), x.to(device),
                                    targets.to(device), labels.to(device),
                                    drop=draws_to(draws.drop, device))
        fused_adamw_ema(grads, state, tx=tx, cfg=c)
        if device == "cuda":
            torch.cuda.synchronize()
            want = model_launches(c, cfg.gradient_accumulation_steps, 0)
            require(read_launches() == want, f"{c.model_name} {name} step launches "
                    f"{read_launches()}, expected {want}")
        runs[name] = {
            "loss": float(m["loss"]),
            "grads": [g.float().cpu() for g in grads],
            "update": [(p.detach() - q).float().cpu()
                       for p, q in zip(state.params(), before)],
        }
        del bundle, model, state, grads, before
        torch.cuda.empty_cache()
    host, out = runs["host"], {}
    for name in ("card", "card_f32"):
        run = runs[name]
        out[name] = {"loss_rel": abs(run["loss"] - host["loss"]) / abs(host["loss"]),
                     "grad_rel_l2": rel_l2(run["grads"], host["grads"]),
                     "update_rel_l2": rel_l2(run["update"], host["update"])}
    masks = sum(int(t.numel()) for mb in draws.drop for t in mb)
    print(f"{cfg.model_name} step with drop sites vs f32 host step ({REF_BATCH} images, "
          f"{len(draws.drop[0])} sites, {masks} mask entries, lr "
          f"{tx.schedule(start):.3g}): loss {runs['card']['loss']:.6f} (bf16) / "
          f"{runs['card_f32']['loss']:.6f} (f32) on the card vs {host['loss']:.6f}; "
          f"bf16 {out['card']} (bounds {bounds['card']}); f32 {out['card_f32']} "
          f"(bounds {bounds['card_f32']})", flush=True)
    for name in ("card", "card_f32"):
        require(np.isfinite(runs[name]["loss"]), f"non-finite {name} loss")
        got = out[name]
        require(all(v <= b for v, b in zip(
            (got["loss_rel"], got["grad_rel_l2"], got["update_rel_l2"]), bounds[name])),
            f"{cfg.model_name} {name} step vs f32 host: {got}, bounds {bounds[name]}")
    return out


def attention_in_step(step: dict) -> dict:
    """ViT-B's attention core (``models/vit.py:attention_core``) in the
    profiled step's own window (``time_entry_step``): its batched products
    (CUTLASS's ``align1`` GEMMs: 197 tokens are not a multiple of 8, and
    every other product of the step runs on cuBLAS's nvjet kernels) and its
    softmax forward and backward, found by kernel name and dtype (the f32
    head's product and the loss's log-softmax match the names in f32) and
    printed; their sum as a share of the step's device time. The core's
    scale and dropout multiplies run on elementwise kernels that other ops
    share, and are left out."""
    rows = [r for r in step["kernels"] if ("align1" in r[2] and "bf16" in r[2])
            or ("softmax_warp" in r[2] and "BFloat16" in r[2])]
    ms = sum(r[0] for r in rows)
    share = ms / step["device_ms"]
    print(f"{VIT_MODEL} attention core in the profiled step: {ms:.3f} ms of its "
          f"{step['device_ms']:.3f} ms, {share:.1%}:", flush=True)
    for r in rows:
        print(f"  {r[0]:9.3f} ms {r[1]:5d}x {r[2][:100]}", flush=True)
    return {"ms": ms, "share": share}


def run_v2_ensemble() -> dict:
    """Phase 10: V2's ensemble through ``cli train`` and each member through
    ``cli predict``; the ViT-B step alone; the ViT-B and drop-path
    ConvNeXt-B steps against the host; GELU at ViT-B's shape."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_v2e_") as tmp:
        return _run_v2_ensemble(tmp)


def _member_probs(cfg, model_name: str, loader) -> np.ndarray:
    """``predict_ensemble``'s probabilities of one member's saved fold
    checkpoints (as ``cli predict`` loads them)."""
    mcfg = cfg.replace(model_name=model_name, ensemble_models=(), ensemble_weights=(),
                       model_save_path=f"{cfg.model_save_path}/{model_name}")
    models = []
    for fold in range(1, V2E_FOLDS + 1):
        model = create_model(mcfg).module
        model.load_state_dict(torch.load(cli.checkpoint_path(mcfg.model_save_path, fold),
                                         map_location="cpu", weights_only=True))
        models.append(model.to("cuda"))
    probs = predict_ensemble(models, loader, mcfg)[2]
    del models
    torch.cuda.empty_cache()
    return probs


def _run_v2_ensemble(tmp: str) -> dict:
    check_v2_kernels(V2E_STAGE_HW, V2E_OVERRIDES, "V2 ensemble", seed=4324)
    torch.cuda.empty_cache()
    labels = entry_labels()
    over = [f"train_csv={tmp}/train.csv", f"train_dir={tmp}/train",
            f"test_csv={tmp}/test.csv", f"test_dir={tmp}/test", f"cache_dir={tmp}/cache",
            f"model_save_path={tmp}/models", f"output_dir={tmp}/out",
            f"submission_path={tmp}/submission.csv", *V2E_OVERRIDES]
    cfg = load_config(V2_CONFIG, over)
    require(tuple(cfg.ensemble_models) == V2E_MEMBERS
            and tuple(cfg.ensemble_weights) == V2E_WEIGHTS and cfg.batch_size == V2_BATCH
            and cfg.use_randaugment and cfg.tta_mode == "flip6"
            and cfg.mixup_alpha > 0 and cfg.cutmix_alpha > 0,
            "configs/v2_convbase.json no longer ensembles ConvNeXt-B + ViT-B/16 + "
            "DeiT-B/16 at .4/.3/.3 with RandAugment, MixUp/CutMix, batch 64, flip6")
    write_entry_data(cfg, labels)

    # Main path, through the user's entry point. Counters from 0 right before.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    cli.main(["train", "--config", V2_CONFIG, *over])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(cfg.output_dir, "train.log")) as f:
        log = f.read()
    require("failed; continuing" not in log, "a V2 ensemble fold failed:\n" + log[-4000:])
    val_batch = cfg.batch_size * cfg.val_batch_multiplier
    val_sizes = [len(v) for _, v in stratified_kfold(labels, V2E_FOLDS, cfg.fold_seed)]
    test_batches = -(-ENTRY_TEST // (cfg.batch_size * cfg.infer_batch_multiplier))
    want = dict.fromkeys(WRAPPERS, 0)
    members = {}
    for m, w in zip(V2E_MEMBERS, V2E_WEIGHTS):
        require(f"ensemble member: {m} (weight {w:.2f})" in log,
                f"train.log does not name member {m} with weight {w:.2f}")
        for fold in range(1, V2E_FOLDS + 1):
            for fn in (f"best_model_fold{fold}.pt", f"best_loss_model_fold{fold}.pt"):
                require(os.path.exists(f"{cfg.model_save_path}/{m}/{fn}"), f"no {m}/{fn}")
        with open(f"{cfg.output_dir}/{m}/metrics.jsonl") as f:
            records = [json.loads(line) for line in f]
        require(len(records) == V2E_FOLDS and all(
            np.isfinite([r["train_loss"], r["val_loss"]]).all() for r in records),
            f"{m}: metrics.jsonl {records}")
        steps = sum(r["steps"] for r in records)
        forwards = sum(-(-n // val_batch) for n in val_sizes) + V2E_FOLDS * test_batches
        for k, n in expected_launches(cfg.replace(model_name=m), steps, forwards).items():
            want[k] += n
        members[m] = {"steps": steps, "images_per_s": [r["images_per_sec"] for r in records],
                      "val_acc": [r["val_acc"] for r in records]}
        for r in records:
            print(f"  V2 ensemble {m} fold {r['fold']}: train loss {r['train_loss']:.4f} "
                  f"val loss {r['val_loss']:.4f} val acc {r['val_acc']:.4f}; "
                  f"{r['images_per_sec']} images/s, duty cycle {r['duty_cycle']}, "
                  f"{r['steps']} steps in {r['wall_time_s']} s", flush=True)
    print(f"V2 ensemble cli train ({', '.join(V2E_MEMBERS)} at 224x224, {V2E_FOLDS} folds "
          f"x 1 epoch): {train_s:.3f} s, peak memory {peak_gib:.3f} GiB, launches "
          f"{launches}", flush=True)
    require(launches == want, f"V2 ensemble launches {launches}, expected {want}")
    sub = read_submission(cfg.submission_path)
    require(sub[0] == "id,target" and len(sub) == ENTRY_TEST + 1,
            f"submission has {len(sub)} lines, header {sub[:1]}")

    # each member alone through cli predict, and its probabilities
    loader = cli._test_loader(cfg, torch.device("cuda"))
    mixed = 0.0
    for m, w in zip(V2E_MEMBERS, V2E_WEIGHTS):
        out = f"{tmp}/predict_{m}.csv"
        cli.main(["predict", "--config", V2_CONFIG, "--folds", "1,2", *over,
                  f"model_name={m}", f"model_save_path={cfg.model_save_path}/{m}",
                  "ensemble_models=[]", "ensemble_weights=[]", f"submission_path={out}"])
        rows = read_submission(out)
        require(rows[0] == "id,predict" and [r.split(",")[0] for r in rows[1:]]
                == [r.split(",")[0] for r in sub[1:]], f"{m}: cli predict rows {rows[:2]}")
        probs = _member_probs(cfg, m, loader)
        require(probs.shape == (ENTRY_TEST, cfg.num_classes)
                and bool(np.isfinite(probs).all()), f"{m}: probabilities {probs.shape}")
        require([int(r.split(",")[1]) for r in rows[1:]] == probs.argmax(1).tolist(),
                f"{m}: cli predict differs from predict_ensemble of its checkpoints")
        mixed = mixed + w * probs
    top2 = np.sort(mixed, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > V2E_PROB_MARGIN
    ours = np.array([int(r.split(",")[1]) for r in sub[1:]])
    agree = int((ours == mixed.argmax(1))[decided].sum())
    print(f"V2 ensemble: each member's cli predict writes {ENTRY_TEST} rows; the train "
          f"submission is the argmax of .4/.3/.3 x the members' probabilities on "
          f"{agree}/{int(decided.sum())} decided rows ({ENTRY_TEST} in all)", flush=True)
    require(agree == int(decided.sum()), "the train submission is not the weighted "
            "ensemble of its members")

    # the ViT-B step alone, its device time and attention's share
    vcfg = cfg.replace(model_name=VIT_MODEL)
    step = time_entry_step(vcfg, use_ema=vcfg.use_ema)
    attention = attention_in_step(step)
    torch.cuda.empty_cache()
    vit_check = check_drop_step(
        load_config(V2_CONFIG, [*V2E_OVERRIDES, f"model_name={VIT_MODEL}", *VIT_DROP,
                                f"batch_size={REF_BATCH}"]),
        {"card": VIT_BOUNDS, "card_f32": VIT_F32_BOUNDS})
    cnx_check = check_drop_step(
        load_config(V2_CONFIG, [*V2E_OVERRIDES, "model_name=convnext_base", *CONVNEXT_DROP,
                                f"batch_size={REF_BATCH}"]),
        {"card": CONVNEXT_BOUNDS, "card_f32": CONVNEXT_F32_BOUNDS})
    # GELU at ViT-B's MLP: (64 x 197, 3072), 12 launches each a step
    table = KernelTable()
    gen = torch.Generator(device="cuda").manual_seed(4323)
    rows = V2_BATCH * VIT_TOKENS_224
    c = VIT_CONFIGS[VIT_MODEL]
    check_gelu_fwd(table, gen, rows, 4 * c["dim"], c["depth"])
    check_gelu_bwd(table, gen, rows, 4 * c["dim"], c["depth"])
    for e in table.entries({k: KERNEL_META[k] for k in ("gelu", "gelu_bwd")}):
        print(f"{VIT_MODEL} per optimizer step: {e['name']} kernel {e['ms']:.4f} ms, plain "
              f"{e['plain_ms']:.4f} ms, library {e['library_ms']:.4f} ms, bound "
              f"{e['bound_ms']:.4f} ms ({e['bound_by']})", flush=True)
    return {"train_s": train_s, "peak_mem_gib": peak_gib, "members": members,
            "step": {k: v for k, v in step.items() if k != "kernels"},
            "attention": attention, "vit_check": vit_check,
            "convnext_check": cnx_check}


# ------------------------------------------------------------ parallel
def run_parallel() -> dict:
    """Phase ``parallel``: data parallelism on the one card (V4 and V1's
    BatchNorm, 2 gloo ranks against 1 process), tensor parallelism (ViT-B,
    and V4 under each ``block_remat`` mode, on ``mesh_model=2``) with
    kernels 6-7 at V4's split shapes, one V4 step through NCCL at world 1,
    then ``cli train fold_parallel=true`` on 2 ranks, ``cli predict``, and
    the sequential ``cli train`` of the same folds."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        return _run_parallel(tmp)


def _run_parallel(tmp: str) -> dict:
    t_phase = time.perf_counter()
    v4 = os.path.join(REPO, "configs", "v4.json")
    vit = [*V2_OVERRIDES, f"model_name={VIT_MODEL}", "image_size=[224,224]"]
    tp = f"mesh_model={PAR_WORLD}"
    jobs = [par_job(v4, [], 32, seed=61),
            par_job(V1_CONFIG, [], 64, seed=62),
            par_job(V1_CONFIG, ["compute_dtype=float32"], 64, seed=62, timed=0),
            par_job(V2_CONFIG, vit, V2_BATCH, seed=63, spec=(1, PAR_WORLD)),
            par_job(V2_CONFIG, [*vit, "compute_dtype=float32"], V2_BATCH, seed=63,
                     spec=(1, PAR_WORLD), timed=0),
            *(par_job(v4, [tp, f"block_remat={mode}"], 32, seed=61, spec=(1, PAR_WORLD),
                      timed=1, profile=True) for mode in BLOCK_REMAT),
            par_job(v4, [tp, "block_remat=none", "compute_dtype=float32"], 32, seed=61,
                    spec=(1, PAR_WORLD), timed=0)]
    # V4's none and f32 jobs on the mesh; each process runs all but dots and
    # full alone, which are held to none on the same ranks
    tp0, f32 = 5, len(jobs) - 1
    alone = [*range(tp0 + 1), f32]
    v4_cfg = load_config(v4)
    require(v4_cfg.batch_size == 32 and v4_cfg.gradient_accumulation_steps == 2
            and v4_cfg.aug_enabled and v4_cfg.mixup_alpha > 0
            and tuple(v4_cfg.image_size) == (IMAGE, IMAGE),
            "configs/v4.json no longer trains batch 32, accumulation 2, aug and mix at 260")
    split_gelu = check_split_gelu(torch.Generator(device="cuda").manual_seed(4323))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    one = {}
    for i in alone:
        one[i] = par_step(jobs[i])
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ranks = par_spawn(tmp, "dp", PAR_WORLD, "gloo", jobs)
    print(f"parallel: {len(alone)} steps in 1 process {t1 - t0:.1f} s, {len(jobs)} on "
          f"{PAR_WORLD} ranks {time.perf_counter() - t1:.1f} s (process start included)",
          flush=True)
    res = {"v4": par_compare("V4 (ConvNeXt-B, 260, bf16, aug + mix, accum 2)",
                              [r[0] for r in ranks], one[0], PAR_LOSS_REL_TOL, None),
           "v1_bf16": par_compare("V1 (EfficientNet-B0, 60x80, bf16, BatchNorm)",
                                   [r[1] for r in ranks], one[1], PAR_LOSS_REL_TOL,
                                   PAR_BF16_STATS_REL_L2),
           "v1_f32": par_compare("V1 in f32", [r[2] for r in ranks], one[2],
                                  PAR_F32_LOSS_REL_TOL, PAR_F32_STATS_REL_L2),
           "vit_tp": par_compare(f"{VIT_MODEL} (224, batch {V2_BATCH}, bf16) on "
                                  f"mesh_model={PAR_WORLD}", [r[3] for r in ranks],
                                  one[3], PAR_LOSS_REL_TOL, None),
           "vit_tp_f32": par_compare(f"{VIT_MODEL} in f32 on mesh_model={PAR_WORLD}",
                                      [r[4] for r in ranks], one[4],
                                      PAR_F32_LOSS_REL_TOL, None),
           "v4_tp": par_compare(f"V4 (ConvNeXt-B, 260, bf16, aug + mix, accum 2) on {tp}",
                                 [r[tp0] for r in ranks], one[tp0], PAR_LOSS_REL_TOL, None),
           "v4_tp_f32": par_compare(f"V4 in f32 on {tp}", [r[f32] for r in ranks], one[f32],
                                     PAR_F32_LOSS_REL_TOL, None)}
    modes = {mode: [r[tp0 + i] for r in ranks] for i, mode in enumerate(BLOCK_REMAT)}
    for mode, mine in modes.items():
        if mode != "none":
            for r in mine:
                for k, n in r["want"].items():
                    require(r["launches"][k] == n, f"V4 on {tp}, block_remat={mode}: a "
                            f"rank launched {k} {r['launches'][k]} times, expected {n}")
    res["v4_tp_remat"] = {
        "bit_equal": remat_compare(f"V4 on {tp}", modes),
        "ranks": {mode: [{k: r[k] for k in ("loss", "launches", "step_ms", "peak_mem_gib",
                                            "profile")} for r in mine]
                  for mode, mine in modes.items()},
        "one_process": {k: one[tp0][k] for k in ("loss", "step_ms", "peak_mem_gib")}}
    res["split_gelu"] = split_gelu
    t0 = time.perf_counter()
    nccl = par_spawn(tmp, "nccl", 1, "nccl", jobs[:1])[0]
    print(f"parallel: the NCCL process {time.perf_counter() - t0:.1f} s", flush=True)
    res["nccl"] = {"version": nccl[1]["nccl"], "loss": nccl[0]["loss"],
                   "loss_rel": abs(nccl[0]["loss"] - one[0]["loss"]) / abs(one[0]["loss"]),
                   "params_bit_identical": all(torch.equal(a, b) for a, b in zip(
                       nccl[0]["params"], one[0]["params"])),
                   "step_ms": nccl[0]["step_ms"]}
    print(f"parallel NCCL {res['nccl']['version']} at world 1, V4 step through the "
          f"gradient all-reduce: {res['nccl']}", flush=True)
    require(res["nccl"]["loss_rel"] <= PAR_LOSS_REL_TOL, "NCCL step loss differs")
    for k, n in nccl[0]["want"].items():
        require(nccl[0]["launches"][k] == n, f"NCCL step: {k} launches")
    del one, ranks, nccl
    res["entry"] = _par_entry(tmp)
    res["wall_s"] = time.perf_counter() - t_phase
    return res


def _par_entry(tmp: str) -> dict:
    """``cli train fold_parallel=true`` (V4, 2 folds x 1 epoch) on 2 gloo
    ranks, one fold each, on the card; ``cli predict`` on its checkpoints;
    then the sequential ``cli train`` of the same folds."""
    v4 = os.path.join(REPO, "configs", "v4.json")

    def overrides(tag: str) -> list[str]:
        return [f"train_csv={tmp}/train.csv", f"train_dir={tmp}/train",
                f"test_csv={tmp}/test.csv", f"test_dir={tmp}/test",
                f"cache_dir={tmp}/cache", f"model_save_path={tmp}/{tag}/models",
                f"output_dir={tmp}/{tag}/out", f"submission_path={tmp}/{tag}/sub.csv",
                f"num_folds={PAR_ENTRY_FOLDS}", "epochs=1"]

    cfg = load_config(v4, overrides("par"))
    labels = entry_labels()
    write_entry_data(cfg, labels)
    train_sizes = [len(t) for t, _ in stratified_kfold(labels, PAR_ENTRY_FOLDS,
                                                       cfg.fold_seed)]
    require(len({n // cfg.batch_size for n in train_sizes}) == 1,
            f"the folds' train sets {train_sizes} give unequal steps")
    t0 = time.perf_counter()
    par_spawn(tmp, "entry", PAR_ENTRY_FOLDS, "gloo", [],
              ["train", "--config", v4, "--device", "cuda:0", "fold_parallel=true",
               *overrides("par")])
    par_s = time.perf_counter() - t0
    records = check_fold_parallel_run(cfg, PAR_ENTRY_FOLDS, 1, (PAR_ENTRY_FOLDS, 1, 1),
                                      ENTRY_TEST)
    sub = read_submission(cfg.submission_path)
    t0 = time.perf_counter()
    cli.main(["predict", "--config", v4, "--folds", "1,2", *overrides("par"),
              f"submission_path={tmp}/par/predict.csv"])
    predict_s = time.perf_counter() - t0
    require(read_submission(f"{tmp}/par/predict.csv")[1:] == sub[1:],
            "cli predict on the fold-parallel checkpoints differs from its submission")
    t0 = time.perf_counter()
    cli.main(["train", "--config", v4, *overrides("seq")])
    seq_s = time.perf_counter() - t0
    with open(f"{tmp}/seq/out/metrics.jsonl") as f:
        seq = [json.loads(line) for line in f]
    rels = compare_with_sequential(records, seq, PAR_ENTRY_LOSS_REL_TOL)
    return {"fold_parallel_train_s": par_s, "predict_s": predict_s,
            "sequential_train_s": seq_s, "train_loss_rel": rels}


def report_parallel(par: dict, smi: str) -> None:
    tp = par["v4_tp_remat"]
    for mode, ranks in tp["ranks"].items():
        for rank, r in enumerate(ranks):
            prof = r["profile"]
            print(f"V4 on mesh_model={PAR_WORLD}, block_remat={mode}, rank {rank}: step "
                  f"{r['step_ms']:.2f} ms of wall, {prof['device_ms']:.2f} ms of device "
                  f"time (the model group's sums {prof['model_all_reduce_ms']:.2f} ms, over "
                  f"gloo), peak {r['peak_mem_gib']:.3f} GiB; loss {r['loss']!r}; on {smi}",
                  flush=True)
    one = tp["one_process"]
    print(f"V4 in 1 process: step {one['step_ms']:.2f} ms of wall, peak "
          f"{one['peak_mem_gib']:.3f} GiB, loss {one['loss']!r}; on mesh_model={PAR_WORLD} "
          f"loss rel {par['v4_tp']['loss_rel']:.3g} (bf16, bound {PAR_LOSS_REL_TOL}), "
          f"{par['v4_tp_f32']['loss_rel']:.3g} (f32, bound {PAR_F32_LOSS_REL_TOL})", flush=True)
    print(f"parallel phase: {par['wall_s']:.1f} s; step ms (rank 0, rank 1, 1 process): "
          f"V4 {par['v4']['step_ms']}, V1 {par['v1_bf16']['step_ms']}, {VIT_MODEL} on "
          f"mesh_model={PAR_WORLD} {par['vit_tp']['step_ms']}; NCCL "
          f"{par['nccl']['version']} world-1 V4 step {par['nccl']['step_ms']:.1f} ms; "
          f"fold-parallel cli train {par['entry']['fold_parallel_train_s']:.1f} s vs "
          f"sequential {par['entry']['sequential_train_s']:.1f} s; on {smi}", flush=True)


def check_split_gelu(gen) -> list[dict]:
    """Kernels 6-7 where V4's MLPs split over ``mesh_model=PAR_WORLD``:
    every block's hidden layer (MICRO x H x W, 4C / PAR_WORLD), (67600, 256)
    to (1296, 2048), against their plain versions (check_gelu_fwd,
    check_gelu_bwd), timed; ``kernels`` line entries of their own, whose
    launches the phase's ``none`` run on the mesh fills in."""
    table = KernelTable()
    for hw, c, depth in zip(STAGE_HW, DIMS, DEPTHS):
        rows, cols = MICRO * hw * hw, 4 * c // PAR_WORLD
        check_gelu_fwd(table, gen, rows, cols, depth * ACCUM)
        check_gelu_bwd(table, gen, rows, cols, depth * ACCUM)
    entries = table.entries({k: KERNEL_META[k] for k in ("gelu", "gelu_bwd")})
    for e in entries:
        e["name"] = f"{e['name']} (mesh_model={PAR_WORLD})"
    return entries


# ------------------------------------------------------------ bench
BENCH_STEP_TIMED = 10    # the bench's train step alone: timed steps after its warm-up
AUG_PROFILED_CALLS = 5


def run_bench() -> dict:
    """Phase ``bench``: the kernels at the bench's accumulation-1 shapes
    (ConvNeXt-B, batch 32 at 260: block-tail rows M = 135200 / 34848 /
    9248, depthwise maps 32x65²x128 to 32x9²x1024), its train step alone,
    then ``bench.main`` with the launch counts from 0, then the aug's
    device time against the wall the bench read."""
    cfg = bench.bench_config()
    require(cfg.model_name == MODEL and cfg.batch_size == MICRO * ACCUM
            and cfg.gradient_accumulation_steps == 1
            and tuple(cfg.image_size) == (IMAGE, IMAGE),
            "bench_config() no longer trains ConvNeXt-B at 260 in batches of 32, "
            "accumulation 1")
    gen = torch.Generator(device="cuda").manual_seed(4324)
    table = KernelTable()
    for stage, (hw, c, depth) in enumerate(zip(STAGE_HW, DIMS, DEPTHS)):
        print(f"bench: {MODEL} stage {stage}, batch {cfg.batch_size}, accumulation 1:",
              flush=True)
        check_stage(table, gen, stage, hw, c, cfg.batch_size, depth,
                    bwd_batch=cfg.batch_size)
    step = bench_step(cfg)
    torch.cuda.empty_cache()

    reset_launches()                          # main path: counts from 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        line = bench.main("cuda")
    main_s = time.perf_counter() - t0
    launches = read_launches()
    printed = out.getvalue().splitlines()
    require(len(printed) == 1 and json.loads(printed[0]) == line,
            f"bench.main printed {printed!r}")
    values = [line["value"], *line["extra_metrics"].values()]
    require(line["metric"] == bench.METRIC and all(np.isfinite(v) and v > 0
                                                   for v in values),
            f"bench line {line}")
    require(line["vs_baseline"] == round(line["value"] / bench.REFERENCE_IMAGES_PER_SEC, 3),
            "bench vs_baseline")
    # every step and forward of the bench, warm-up and warm batch included
    accum2 = cfg.replace(gradient_accumulation_steps=2)
    want = expected_launches(cfg, bench.WARMUP_STEPS + bench.TRAIN_STEPS, 0)
    for part in (expected_launches(accum2, bench.WARMUP_STEPS + bench.ACCUM2_STEPS, 0),
                 model_launches(cfg, 0, (bench.INFER_BATCHES + 1) * bench.INFER_MODELS)):
        for name, n in part.items():
            want[name] += n
    want["warp"] += 2 * bench.AUG_ITERS
    print(f"bench: launches {launches}, expected {want}", flush=True)
    for name, n in want.items():
        require(launches[name] == n, f"bench: {name} {launches[name]} launches, "
                f"expected {n}")

    # the aug as the bench runs it: its device time against the wall a call
    # took in the bench. utils/profiler.py:device_ms cannot time it: behind
    # its spin kernel the host queued neither 20 calls nor 3 on the H100 (it
    # raised). So: the kernels' own device time under the profiler, over
    # AUG_PROFILED_CALLS calls, with their count a call, and the calls that
    # wait for the card in one aug call (torch's sync debug mode).
    call = bench.aug_setup(cfg, "cuda")
    acc = torch.zeros((), dtype=torch.float32, device="cuda")
    call(acc)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        call(acc)
    torch.cuda.set_sync_debug_mode(0)
    aug_syncs = [str(w.message).splitlines()[0] for w in caught]
    print(f"bench: one aug call waits for the card {len(aug_syncs)} times"
          + (f", first: {aug_syncs[0]}" if aug_syncs else ""), flush=True)
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(AUG_PROFILED_CALLS):
            call(acc)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    aug_dev_ms = sum(e.self_device_time_total for e in rows) / 1e3 / AUG_PROFILED_CALLS
    aug_kernels = sum(e.count for e in rows) / AUG_PROFILED_CALLS
    aug_wall_ms = cfg.batch_size * 1e3 / line["extra_metrics"]["aug_pipeline_images_per_sec"]
    return {"line": line, "main_s": main_s, "step": step, "aug_device_ms": aug_dev_ms,
            "aug_kernels": aug_kernels, "aug_syncs": len(aug_syncs),
            "aug_wall_ms": aug_wall_ms,
            "aug_host_share": 1 - aug_dev_ms / aug_wall_ms}


def bench_step(cfg) -> dict:
    """The bench's train step alone: BENCH_STEP_TIMED steps after its
    warm-up, host clock; the peak memory of those steps; one step under the
    profiler."""
    step, state, batch = bench.train_setup(cfg, "cuda")
    for _ in range(bench.WARMUP_STEPS):
        state, m = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(BENCH_STEP_TIMED):
        state, m = step(state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / BENCH_STEP_TIMED
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    require(np.isfinite(float(m["loss"])), "bench step: non-finite loss")
    dev_ms, _ = profile_train_step(step, state, [batch, batch], wall_ms, top=12)
    res = {"wall_ms": wall_ms, "images_per_s": cfg.batch_size * 1e3 / wall_ms,
           "device_ms": dev_ms, "idle": max(0.0, 1 - dev_ms / wall_ms),
           "peak_mem_gib": peak_gib}
    print(f"bench step alone: {res}", flush=True)
    return res


def report_bench(res: dict, smi: str) -> None:
    st = res["step"]
    print(f"bench line {json.dumps(res['line'])} (bench.main {res['main_s']:.1f} s); "
          f"the accumulation-1 step alone {st['wall_ms']:.2f} ms of wall, "
          f"{st['device_ms']:.2f} ms of device time, idle {st['idle']:.1%}, peak "
          f"memory {st['peak_mem_gib']:.3f} GiB; the aug {res['aug_device_ms']:.4f} ms "
          f"of device time a call ({res['aug_kernels']:.1f} kernels, "
          f"{res['aug_syncs']} waits for the card) in "
          f"{res['aug_wall_ms']:.4f} ms of the bench's wall, "
          f"host dispatch {res['aug_host_share']:.1%}; on {smi}", flush=True)


# ------------------------------------------------------------------ remat
REMAT_RUNS = ("none", "none", "dots", "full")   # the second none: run to run
REMAT_DROP_PATH = 0.1
REMAT_TIMED = 3          # timed steps a mode after the compared one (rate 0 only)
# Bound of dots and full against none: 0 differing bits in the loss and in
# every gradient element. A recompute runs the same kernels on the same
# inputs in the same order; no kernel of the port uses atomics, and a
# cuBLAS product on one stream is deterministic, so nothing may differ. The
# second none step shows whether anything differs run to run.
REMAT_DIFF_BITS = 0


def run_remat() -> dict:
    """Phase ``remat``: one V4 train step a mode from the same weights,
    batch and draws, the launch counts from 0 around each; each
    microbatch's gradient read by a hook on its parameter. The first
    weights and the gradients are kept in host memory, so that the peak
    on the card is the step's own."""
    v4 = load_config(os.path.join(REPO, "configs", "v4.json"))
    require(v4.model_name == MODEL and v4.use_deep_supervision
            and v4.batch_size == MICRO * ACCUM and v4.gradient_accumulation_steps == ACCUM
            and v4.block_remat == "none",
            "configs/v4.json no longer trains ConvNeXt-B with deep supervision in "
            "batches of 32, accumulation 2, without remat")
    out = {}
    t0 = time.perf_counter()
    for rate in (0.0, REMAT_DROP_PATH):
        base = v4.replace(drop_path_rate=rate)
        bundle = train_model(base, "cuda")
        # the factory passes cfg.block_remat to every block
        # (tests/test_torch_remat.py); one model serves every mode here
        blocks = [m for m in bundle.module.modules() if isinstance(m, ConvNeXtBlock)]
        init = [p.detach().to("cpu", copy=True) for p in bundle.module.parameters()]
        images, labels = train_inputs(base, base.batch_size, seed=41)
        batch = {"image": images.cuda(), "label": labels.cuda()}
        draws = draw_train_step(torch.Generator(device="cuda").manual_seed(42),
                                tuple(images.shape), base, drop_sites(bundle.module))
        ref = None
        for run, mode in enumerate(REMAT_RUNS):
            for b in blocks:
                b.block_remat = mode
            with torch.no_grad():
                for p, p0 in zip(bundle.module.parameters(), init):
                    p.copy_(p0)
            res = remat_step(bundle, base.replace(block_remat=mode), batch, draws,
                             timed=rate == 0.0 and run != 1)
            grads = res.pop("grads")
            if ref is None:
                ref = (res["loss"], grads)
            else:
                res.update(remat_diff(ref, res["loss"], grads))
            del grads
            tag = f"remat {mode} (drop-path {rate}{', again' if run == 1 else ''})"
            print(f"{tag}: {res}", flush=True)
            out[tag] = res
        del ref, bundle, init, batch, draws
        torch.cuda.empty_cache()
    print(f"remat phase: {time.perf_counter() - t0:.1f} s", flush=True)
    for tag, res in out.items():
        require(res["launches"] == res["want"], f"{tag}: launches {res['launches']}, "
                f"expected {res['want']}")
        require(res.get("diff_bits", 0) <= REMAT_DIFF_BITS,
                f"{tag}: loss or gradients differ from none's: {res}")
    return out


def remat_step(bundle, cfg, batch, draws, timed: bool) -> dict:
    """One train step of ``cfg`` from the model's weights past warmup, the
    launch counts from 0 just before it and read just after; then, where
    ``timed``, REMAT_TIMED steps on fresh draws (their wall and peak
    memory) and one under the profiler (its device time)."""
    tx = build_optimizer(cfg, build_lr_schedule(cfg, STEPS_PER_EPOCH))
    train_step = make_train_step(bundle, cfg, tx, build_criterion(cfg))
    state = create_train_state(bundle.module, use_ema=cfg.use_ema)
    state.count = state.step = int(STEPS_PER_EPOCH * cfg.epochs
                                   * cfg.gradient_accumulation_steps * cfg.warmup_ratio)
    params = list(bundle.module.parameters())
    grads = [[] for _ in params]
    hooks = [p.register_hook(lambda g, i=i: grads[i].append(g.detach().to("cpu", copy=True)))
             for i, p in enumerate(params)]
    torch.cuda.synchronize()
    reset_launches()
    state, m = train_step(state, batch, draws=draws)
    torch.cuda.synchronize()
    launches = read_launches()
    for h in hooks:
        h.remove()
    res = {"loss": float(m["loss"]), "launches": launches,
           "want": expected_launches(cfg, 1, 0), "grads": grads}
    require(np.isfinite(res["loss"]), f"remat {cfg.block_remat}: non-finite loss")
    if timed:
        gen = torch.Generator(device="cuda").manual_seed(43)

        def step(state, b):
            return train_step(state, b, generator=gen)

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(REMAT_TIMED):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        res["wall_ms"] = (time.perf_counter() - t0) * 1e3 / REMAT_TIMED
        res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        res["device_ms"], _ = profile_train_step(step, state, [batch, batch],
                                                 res["wall_ms"], top=0)
    return res


def remat_diff(ref, loss: float, grads) -> dict:
    """The loss and every microbatch gradient against ``ref``'s (the first
    none's): the bits that differ, and the largest difference."""
    ref_loss, ref_grads = ref
    bits = int(np.float32(loss).view(np.int32) != np.float32(ref_loss).view(np.int32))
    tensors = max_abs = 0
    for mine, theirs in zip(grads, ref_grads):
        require(len(mine) == len(theirs) == ACCUM, "a gradient hook fired "
                f"{len(mine)} times, expected {ACCUM}")
        for a, b in zip(mine, theirs):
            n = int((a.view(torch.int32) != b.view(torch.int32)).sum())
            if n:
                tensors += 1
                bits += n
                max_abs = max(max_abs, float((a - b).abs().max()))
    return {"diff_bits": bits, "diff_tensors": tensors, "max_abs_diff": max_abs,
            "gradients": sum(len(g) for g in grads)}


def report_remat(res: dict, smi: str) -> None:
    parts = []
    for tag, r in res.items():
        timed = ("" if "wall_ms" not in r else
                 f", step {r['wall_ms']:.2f} ms of wall, {r['device_ms']:.2f} ms of "
                 f"device time, peak {r['peak_mem_gib']:.3f} GiB")
        parts.append(f"{tag}: loss {r['loss']!r}, differing bits "
                     f"{r.get('diff_bits', '-')}, block_mlp {r['launches']['block_mlp']}, "
                     f"dwconv {r['launches']['dwconv']}, gelu {r['launches']['gelu']}"
                     + timed)
    print("remat (ConvNeXt-B V4, batch 32, accumulation 2): " + "; ".join(parts)
          + f"; on {smi}", flush=True)


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

    if sys.argv[1:] == ["--only", "parallel"]:
        # the parallel phase alone, on the kernels just built (no result line)
        report_parallel(run_parallel(), smi)
        return 0
    if sys.argv[1:] == ["--only", "bench"]:
        report_bench(run_bench(), smi)
        return 0
    if sys.argv[1:] == ["--only", "remat"]:
        report_remat(run_remat(), smi)
        return 0
    kernels = check_kernels()
    v4 = load_config(os.path.join(REPO, "configs", "v4.json"))
    check_aug(v4)
    aug_ips = aug_rate(v4)
    train = run_train()
    print(f"aug slice: {aug_ips} images/s; train slice (aug and mix on): "
          f"{train['images_per_s']} images/s (aug off, same run: "
          f"{train['aug_off_images_per_s']}), peak memory "
          f"{train['peak_mem_gib']} GiB, on {smi}", flush=True)
    torch.cuda.empty_cache()
    stats = run_slice()
    print(f"slice: {stats['images_per_s']} images/s ({N_IMAGES} images x "
          f"{len(FOLD_SEEDS)} folds x 4 views in {stats['wall_s']} s), peak "
          f"memory {stats['peak_mem_gib']} GiB, on {smi}", flush=True)
    torch.cuda.empty_cache()
    entry = run_train_entry(kernels)
    print(f"train entry ({ENTRY_MODEL}, cli train): {entry['train_s']} s; the "
          f"loop's images/s by epoch {entry['images_per_s']}, duty cycle "
          f"{entry['duty_cycle']}; peak memory {entry['peak_mem_gib']} GiB; the "
          f"step alone {entry['step']['images_per_s']} images/s, "
          f"{entry['step']['device_ms']} ms of device time a step, peak memory "
          f"{entry['step']['peak_mem_gib']} GiB; against the f32 host step "
          f"{entry['step_check']}; on {smi}", flush=True)
    check_v2_kernels()
    v2_aug = check_randaug(load_config(V2_CONFIG, V2_OVERRIDES))
    v2 = run_v2()
    print(f"V2 ({V2_MODEL}, 60x80, RandAugment, batch {V2_BATCH}): cli train "
          f"{v2['train_s']} s, the loop's images/s by epoch {v2['images_per_s']}, "
          f"peak memory {v2['peak_mem_gib']} GiB; launches per optimizer step "
          f"(with validation and test forwards) {v2['launches_per_step']}; the step "
          f"alone {v2['step']['images_per_s']} images/s, {v2['step']['device_ms']} ms "
          f"of device time a step, device idle {v2['step']['idle']:.1%}, peak memory "
          f"{v2['step']['peak_mem_gib']} GiB; RandAugment card vs host {v2_aug}; "
          f"freeze_stages=1 step against the f32 host step "
          f"{v2['frozen_step_check']}; on {smi}", flush=True)
    torch.cuda.empty_cache()
    data = run_data()
    print(f"data edge ({data['library']}): fixture max |d| {data['fixture']['max']}; "
          f"{DATA_TRAIN} + {DATA_TEST} hard JPEGs written in {data['write_s']:.3f} s; "
          f"decode {data['decode_images_per_s']:.1f} images/s at {DECODE_THREADS} threads; "
          f"V2 cli train in memory / through the cache {data['v2_train_s']}; V4 loop by "
          f"prefetch_depth {data['v4_loop']}; on {smi}", flush=True)
    v1_cfg = load_config(V1_CONFIG)
    require(v1_cfg.model_name == "efficientnet_b0" and tuple(v1_cfg.image_size) == NATIVE
            and v1_cfg.batch_size == 64 and v1_cfg.schedule == "plateau"
            and v1_cfg.use_sampler and not v1_cfg.use_ema and v1_cfg.mix_prob == 0.0,
            "configs/v1_effb0.json no longer trains B0 at 60x80, batch 64, plateau, "
            "the sampler, no EMA, no mix")
    v1 = run_effnet(V1_CONFIG, V1_OVERRIDES)
    print(f"V1 (efficientnet_b0, 60x80, batch 64): cli train {v1['train_s']} s, the "
          f"loop's images/s by epoch {v1['images_per_s']}, peak memory "
          f"{v1['peak_mem_gib']} GiB; the step alone {v1['step']['images_per_s']} "
          f"images/s, {v1['step']['device_ms']} ms of device time a step, device idle "
          f"{v1['step']['idle']:.1%}, peak memory {v1['step']['peak_mem_gib']} GiB; "
          f"against the f32 host step {v1['step_check']}; on {smi}", flush=True)
    torch.cuda.empty_cache()
    v31_cfg = load_config(V31_CONFIG, V31_OVERRIDES)
    require(v31_cfg.model_name == "tf_efficientnetv2_s" and v31_cfg.batch_size == 128
            and tuple(v31_cfg.image_size) == (224, 224) and v31_cfg.use_swa
            and v31_cfg.drop_rate > 0 and v31_cfg.drop_path_rate > 0 and v31_cfg.use_ema
            and not v31_cfg.ema_eval and v31_cfg.tta_mode == "scale4",
            "configs/v3_1.json no longer trains V2-S at 224 with SWA, drop rates, "
            "EMA and scale4 TTA")
    warp_table = KernelTable()
    check_warp(warp_table, torch.Generator(device="cuda").manual_seed(4322), "v3_1.json",
               V31_WARP_BATCH)
    v31 = run_effnet(V31_CONFIG, V31_OVERRIDES)
    print(f"V3.1 (tf_efficientnetv2_s, 224x224, batch 128, swa_start_epoch=1 epochs=2): "
          f"cli train {v31['train_s']} s, the loop's images/s by epoch "
          f"{v31['images_per_s']}, peak memory {v31['peak_mem_gib']} GiB, SWA "
          f"{v31['swa']}; the step alone {v31['step']['images_per_s']} images/s, "
          f"{v31['step']['device_ms']} ms of device time a step, device idle "
          f"{v31['step']['idle']:.1%}, peak memory {v31['step']['peak_mem_gib']} GiB; "
          f"against the f32 host step {v31['step_check']}; on {smi}", flush=True)
    torch.cuda.empty_cache()
    v2e = run_v2_ensemble()
    st = v2e["step"]
    print(f"V2 ensemble ({' + '.join(V2E_MEMBERS)}, .4/.3/.3, 224x224, batch "
          f"{V2_BATCH}, RandAugment, MixUp/CutMix, flip6): cli train {v2e['train_s']} s, "
          f"peak memory {v2e['peak_mem_gib']} GiB, members {v2e['members']}; the "
          f"{VIT_MODEL} step alone {st['images_per_s']} images/s, "
          f"{st['device_ms']} ms of device time a step (profiler) in "
          f"{st['wall_ms']} ms of wall, device idle {st['idle']:.1%}, peak memory "
          f"{st['peak_mem_gib']} GiB; attention "
          f"core {v2e['attention']['share']:.1%} of its device time; against the f32 "
          f"host step {v2e['vit_check']}; {V2_MODEL} with drop-path and dropout "
          f"against the f32 host step {v2e['convnext_check']}; on {smi}", flush=True)
    torch.cuda.empty_cache()
    par = run_parallel()
    report_parallel(par, smi)
    # the split shapes' entries take their launches from the mesh's none step
    none = par["v4_tp_remat"]["ranks"]["none"][0]["launches"]
    for e in par["split_gelu"]:
        e["launches"] = none[e["name"].split(" (")[0]]
    kernels.extend(par["split_gelu"])
    torch.cuda.empty_cache()
    report_bench(run_bench(), smi)
    torch.cuda.empty_cache()
    report_remat(run_remat(), smi)
    for e in kernels:
        if e["name"] == "warp":
            e["paths"] = dict(WARP_PATHS)   # every launch shape checked in this run
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
