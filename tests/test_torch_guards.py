"""Guards on the port's boundaries: its Config copy stays the JAX package's,
it imports no JAX, its kernel wrappers take the plain path on the CPU, and
the config keys it does not follow raise or warn."""

import dataclasses
import glob
import importlib
import logging
import os
import pkgutil
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from image_classification_tpu.core.config import Config as JaxConfig
from image_classification_tpu.core.config import load_config as jax_load_config
import image_classification_tpu_torch
from image_classification_tpu_torch.core.config import Config, load_config
from image_classification_tpu_torch.data import DataLoader, Manifest, SequentialSampler
from image_classification_tpu_torch.train import kfold
from image_classification_tpu_torch.train.loop import train_fold
from image_classification_tpu_torch.ops import (
    KERNEL_WRAPPERS,
    block_mlp,
    depthwise_conv7x7,
    gelu,
    warp,
)
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse, module scope)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = sorted(glob.glob(os.path.join(REPO, "configs", "*.json")))


def test_config_fields_and_defaults_match_jax():
    ours = [(f.name, str(f.type)) for f in dataclasses.fields(Config)]
    theirs = [(f.name, str(f.type)) for f in dataclasses.fields(JaxConfig)]
    assert ours == theirs
    assert Config().to_dict() == JaxConfig().to_dict()


@pytest.mark.parametrize("path", PRESETS, ids=os.path.basename)
def test_presets_load_like_jax(path):
    assert load_config(path).to_dict() == jax_load_config(path).to_dict()


@pytest.mark.parametrize("override", [
    "num_classes=1", "batch_size=3", "grad_accum_reduction=avg",
    "schedule_horizon=epochs", "schedule=step", "dwconv_impl=fft",
    "block_mlp_impl=triton", "warp_impl=cuda", "downsample_impl=pool",
    "gelu_impl=tanh", "block_remat=some", "hbm_cache=maybe",
    "norm_stats=custom", "split_mode=loo", "val_fraction=1.5",
    "progressive_resizing=true progressive_scales=[0.5,0.9]",
    "no_such_key=1", "lr",
])
def test_validation_errors_match_jax(override):
    with pytest.raises(Exception) as theirs:
        jax_load_config(None, override.split())
    with pytest.raises(type(theirs.value)) as ours:
        load_config(None, override.split())
    assert str(ours.value) == str(theirs.value)


def test_port_and_chip_smoke_import_without_jax():
    """The machine with the card has no jax, sklearn, orbax, matplotlib,
    pandas or cv2: the port and chip_smoke.py import with each blocked."""
    names = [m.name for m in pkgutil.walk_packages(
        image_classification_tpu_torch.__path__, "image_classification_tpu_torch.")]
    assert "image_classification_tpu_torch.ops.block_mlp" in names
    assert "image_classification_tpu_torch.train.kfold" in names
    code = (
        "import sys\n"
        "for m in ('jax', 'sklearn', 'orbax', 'matplotlib', 'pandas', 'cv2'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "assert not any(m.startswith('image_classification_tpu.') or "
        "m == 'image_classification_tpu' for m in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_take_the_plain_path_on_cpu(dtype):
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    x = torch.randn(2, 9, 9, 16).to(dtype)
    assert depthwise_conv7x7(x, torch.randn(7, 7, 16)).dtype == dtype
    assert gelu(x).dtype == dtype
    c = 16
    rows = x.reshape(-1, c)
    y = block_mlp(rows, rows, torch.ones(c), torch.zeros(c), torch.randn(4 * c, c),
                  torch.zeros(4 * c), torch.randn(c, 4 * c), torch.zeros(c),
                  torch.full((c,), 0.5))
    assert y.shape == rows.shape and y.dtype == dtype
    out = warp(x[..., :3].contiguous(), torch.rand(2, 5, 6, 2) * 9)
    assert out.shape == (2, 5, 6, 3) and out.dtype == dtype
    assert [fn.launches for fn in KERNEL_WRAPPERS] == [0] * len(KERNEL_WRAPPERS)


def _meta_block_args(m, c, dtype=torch.bfloat16, res_rows=None):
    """The block tail's arguments as meta tensors (shapes and dtypes, no
    storage): neither the CPU's plain path nor a card."""
    meta = dict(device="meta")
    f32 = dict(dtype=torch.float32, **meta)
    return (torch.empty(m, c, dtype=dtype, **meta),
            torch.empty(res_rows or m, c, dtype=dtype, **meta),
            torch.empty(c, **f32), torch.empty(c, **f32), torch.empty(4 * c, c, **f32),
            torch.empty(4 * c, **f32), torch.empty(c, 4 * c, **f32), torch.empty(c, **f32),
            torch.empty(c, **f32))


@pytest.mark.parametrize("m,c,dtype,res_rows,match", [
    (64, 12, torch.bfloat16, None, "C % 8 == 0"),
    (64, 520, torch.bfloat16, None, "exceeds 512"),
    (64, 32, torch.float16, None, "unsupported dtype"),
    (64, 32, torch.bfloat16, 63, "res is"),
    (128 * 65535 + 1, 32, torch.bfloat16, None, "launch grid"),
    (64, 32, torch.bfloat16, None, "one CUDA device"),
], ids=["c_not_multiple_of_8", "c_past_cutoff", "float16", "res_shape",
        "rows_past_grid", "accepted_shape_off_the_card"])
def test_block_mlp_fwd_refuses_before_any_device_work(m, c, dtype, res_rows, match,
                                                       monkeypatch):
    """Off the CPU, ``block_mlp_fwd`` checks shape, dtype and device first and
    raises ``ValueError``: a refused shape never reaches the plain version,
    the kernel library (its build included) or the launch counter."""
    from image_classification_tpu_torch.ops import _build

    block_mlp_mod = importlib.import_module("image_classification_tpu_torch.ops.block_mlp")

    def must_not_run(*args, **kwargs):
        raise AssertionError("reached past the checks")

    monkeypatch.setattr(block_mlp_mod, "block_mlp_fwd_reference", must_not_run)
    monkeypatch.setattr(_build, "library", must_not_run)
    block_mlp.launches = 0
    for save in (False, True):
        with pytest.raises(ValueError, match=re.escape(match)):
            block_mlp_mod.block_mlp_fwd(*_meta_block_args(m, c, dtype, res_rows),
                                        save=save)
    assert block_mlp.launches == 0


def _tiny_cfg(tmp_path, **over) -> Config:
    kw = dict(model_name="convnext_atto", num_classes=3, image_size=(32, 32),
              native_size=(32, 32), use_deep_supervision=False,
              aug_enabled=False, mixup_alpha=0.0, cutmix_alpha=0.0,
              compute_dtype="float32", batch_size=4,
              gradient_accumulation_steps=1, epochs=1, use_ema=False,
              model_save_path=str(tmp_path / "models"),
              output_dir=str(tmp_path / "out"))
    kw.update(over)
    return Config(**kw).validate()


class _FloatSource:
    """Pre-augmented f32 images (the train step's input with
    ``aug_enabled=false``); the first image holds a NaN."""

    def __init__(self, n: int):
        self.images = np.random.default_rng(0).normal(size=(n, 32, 32, 3)).astype(np.float32)
        self.images[0, 0, 0, 0] = np.nan

    def get_batch(self, idx):
        return self.images[idx]


@pytest.mark.parametrize("debug_nans", [True, False])
def test_debug_nans_raises_on_a_nan_loss(tmp_path, debug_nans):
    """``debug_nans=true`` stops the fold at the first step whose loss is
    NaN and names the fold and step; without it the step runs on."""
    cfg = _tiny_cfg(tmp_path, debug_nans=debug_nans)
    manifest = Manifest(np.array([str(i) for i in range(4)], object), np.arange(4) % 3)
    loader = DataLoader(_FloatSource(4), manifest, batch_size=4,
                        sampler=SequentialSampler(4), device="cpu")
    if debug_nans:
        with pytest.raises(FloatingPointError, match="fold 2 epoch 1 step 1"):
            train_fold(cfg, loader, loader, fold=2)
    else:
        result = train_fold(cfg, loader, loader, fold=2)
        assert np.isnan(result.history[0]["train_loss"])


def test_use_decode_cache_false_raises(tmp_path):
    """``use_decode_cache=false`` decodes in memory and writes no cache
    (missing files take the black fallback); what the port cannot decode
    still raises: a PNG."""
    cfg = _tiny_cfg(tmp_path, use_decode_cache=False, cache_dir=str(tmp_path / "cache"))
    manifest = Manifest(np.array(["0", "1"], object), np.array([0, 1]))
    images = kfold.build_source(cfg, manifest, str(tmp_path)).get_batch(np.arange(2))
    assert images.shape == (2, 32, 32, 3) and not images.any()
    assert not os.path.exists(tmp_path / "cache")
    (tmp_path / "1.png").write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(8))
    with pytest.raises(NotImplementedError, match="1.png"):
        kfold.build_source(cfg, manifest, str(tmp_path))


def test_prefetch_depth_logs_one_warning(tmp_path, monkeypatch):
    """The default ``prefetch_depth=2`` is followed: both loaders of a fold
    prefetch on a background thread, and ``train_k_fold`` logs no warning
    about it (here each fold stops as soon as its loaders are built)."""
    cfg = _tiny_cfg(tmp_path, use_decode_cache=False, num_folds=2)
    assert cfg.prefetch_depth == 2
    manifest = Manifest(np.array([str(i) for i in range(6)], object), np.arange(6) % 3)
    depths = []

    def loaders_only(cfg, train_loader, val_loader, **kw):
        depths.extend([train_loader.prefetch_depth, val_loader.prefetch_depth])
        return types.SimpleNamespace(best_val_acc=0.0)

    monkeypatch.setattr(kfold, "train_fold", loaders_only)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("ic_tpu_torch")   # propagates nowhere once set up
    logger.addHandler(handler)
    try:
        kfold.train_k_fold(cfg, manifest=manifest, device="cpu")
    finally:
        logger.removeHandler(handler)
    assert depths == [2, 2, 2, 2]
    warned = [r for r in records if "prefetch" in r.getMessage()]
    assert warned == []
