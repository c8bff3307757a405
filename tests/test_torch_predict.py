"""The port's predict path against the JAX package's, on the CPU in f32:
eval preprocessing and TTA views, the manifest and decode-cache readers, the
two-fold TTA ensemble with byte-identical submission CSVs, and the
``cli predict`` entry point."""

import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_classification_tpu.aug.pipeline import eval_preprocess as jax_eval_preprocess
from image_classification_tpu.core.config import Config as JaxConfig
from image_classification_tpu.data import DataLoader as JaxLoader
from image_classification_tpu.data import Manifest as JaxManifest
from image_classification_tpu.data.sampling import SequentialSampler as JaxSampler
from image_classification_tpu.data.source import ArraySource as JaxArraySource
from image_classification_tpu.data.source import ImageSource
from image_classification_tpu.infer import predict_ensemble as jax_predict
from image_classification_tpu.infer import write_submission as jax_write
from image_classification_tpu.infer.tta import get_tta as jax_get_tta
from image_classification_tpu.infer.tta import tta_views_flip6 as jax_flip6
from image_classification_tpu.infer.tta import tta_views_scale4 as jax_scale4
from image_classification_tpu.models.factory import ModelBundle
from image_classification_tpu.train.step import make_predict_step as jax_make_predict_step
from image_classification_tpu_torch import cli
from image_classification_tpu_torch.aug.pipeline import eval_preprocess
from image_classification_tpu_torch.core.config import Config
from image_classification_tpu_torch.data import (
    ArraySource,
    DataLoader,
    Manifest,
    SequentialSampler,
    load_decode_cache,
)
from image_classification_tpu_torch.infer import predict_ensemble, write_submission
from image_classification_tpu_torch.infer.tta import get_tta, tta_views_flip6, tta_views_scale4
from image_classification_tpu_torch.models.factory import create_model
from image_classification_tpu_torch.train.step import make_predict_step

from test_torch_model import jax_model, port_model, randomized_params
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse, module scope)

NATIVE = (24, 32)
SIZE = 32
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def images_u8(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *NATIVE, 3), dtype=np.uint8)


def test_eval_preprocess_matches_jax():
    """Upscale 24x32 -> 32x32, round to uint8 levels, normalize. The float
    resizes agree to ~1e-5 grey levels, so rounding flips only where a value
    sits on a .5 boundary: at most one level (1/(255*std) after Normalize)."""
    x = images_u8(4)
    ref = np.asarray(jax_eval_preprocess(jnp.asarray(x), (SIZE, SIZE), MEAN, STD))
    ours = eval_preprocess(torch.from_numpy(x), (SIZE, SIZE), MEAN, STD).numpy()
    diff = np.abs(ours - ref)
    one_level = 1.0 / (255.0 * min(STD))
    assert diff.max() <= one_level + 1e-5
    assert (diff > 1e-5).mean() < 1e-3
    raw = eval_preprocess(torch.from_numpy(x), (SIZE, SIZE), MEAN, STD,
                          round_uint8=False).numpy()
    raw_ref = np.asarray(jax_eval_preprocess(jnp.asarray(x), (SIZE, SIZE), MEAN,
                                             STD, round_uint8=False))
    np.testing.assert_allclose(raw, raw_ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["scale4", "flip6"])
def test_tta_views_match_jax(mode):
    """scale4 includes the 0.9x view, a shrink that jax.image.resize
    antialiases; the port must too (without antialias it is off by ~1)."""
    x = np.random.default_rng(2).normal(size=(2, 40, 40, 3)).astype(np.float32)
    ours = (tta_views_scale4 if mode == "scale4" else tta_views_flip6)(torch.from_numpy(x))
    ref = (jax_scale4 if mode == "scale4" else jax_flip6)(jnp.asarray(x))
    assert len(ours) == len(ref)
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-5,
                                   err_msg=f"view {i}")


@pytest.mark.parametrize("ids", [
    ["0007", "12", "003"],          # all integers: pandas parses, "0007" -> "7"
    ["a1", "0007", "b"],            # text: kept as written
    ["1.50", "2", "3.25"],          # numbers: floats
], ids=["int", "text", "float"])
def test_manifest_ids_match_pandas(tmp_path, ids):
    path = tmp_path / "test.csv"
    path.write_text("id,target\n" + "".join(f"{i},{k % 3}\n" for k, i in enumerate(ids)))
    ours, ref = Manifest.from_csv(str(path)), JaxManifest.from_csv(str(path))
    assert list(ours.ids) == list(ref.ids)
    np.testing.assert_array_equal(ours.labels, ref.labels)
    np.testing.assert_array_equal(Manifest.from_csv(str(path), is_test=True).labels, -1)


def test_decode_cache_written_by_jax_package_loads(tmp_path):
    img_dir, cache = tmp_path / "imgs", str(tmp_path / "cache")
    img_dir.mkdir()
    imgs = images_u8(3, seed=4)
    ids = np.array(["7", "8", "missing"], dtype=object)
    for id_, im in zip(ids[:2], imgs):  # PNG is lossless
        cv2.imwrite(str(img_dir / f"{id_}.png"), cv2.cvtColor(im, cv2.COLOR_RGB2BGR))
    ref = ImageSource(str(img_dir), ids, native_size=NATIVE, cache_dir=cache)
    ours = load_decode_cache(str(img_dir), ids, NATIVE, cache)
    np.testing.assert_array_equal(ours.get_batch(np.arange(3)),
                                  ref.get_batch(np.arange(3)))
    np.testing.assert_array_equal(ours.get_batch(np.arange(2)), imgs[:2])
    with pytest.raises(FileNotFoundError, match="decode cache"):
        load_decode_cache(str(img_dir), ids[:2], NATIVE, cache)


def _cfgs(**overrides):
    kw = dict(num_classes=7, native_size=NATIVE, image_size=(SIZE, SIZE),
              compute_dtype="float32", batch_size=4, infer_batch_multiplier=1,
              tta_transforms=4, tta_mode="scale4", use_decode_cache=False)
    kw.update(overrides)
    return JaxConfig(**kw), Config(**kw)


@pytest.mark.parametrize("tta", [
    dict(tta_transforms=0),                   # no TTA: one view
    dict(tta_transforms=6, tta_mode="flip6"),
], ids=["no_tta", "flip6"])
def test_predict_step_matches_jax(monkeypatch, tta):
    """Single-model predict step (eval preprocess, views, one forward, f32
    softmax averaged over the views) against the JAX step, in f32."""
    monkeypatch.setenv("IC_TPU_BLOCKMLP_INTERPRET", "1")
    monkeypatch.setenv("IC_TPU_GELU_INTERPRET", "1")
    jcfg, cfg = _cfgs(**tta)
    params = randomized_params(SIZE)
    images = images_u8(3, seed=7)
    bundle = ModelBundle(name="tiny", module=jax_model(), deep_supervised=True,
                         has_batch_stats=False, input_size=(SIZE, SIZE))
    ref = jax.jit(jax_make_predict_step(bundle, jcfg, jax_get_tta(jcfg)))(
        {"params": params}, jnp.asarray(images))
    with torch.no_grad():
        ours = make_predict_step(port_model(params), cfg, get_tta(cfg))(
            torch.from_numpy(images))
    assert ours.shape == (3, 7)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_two_fold_ensemble_matches_jax_and_csv_bytes(tmp_path, monkeypatch):
    """Two folds x scale4 on the same weights; ids all-numeric and
    zero-padded; 10 images in batches of 4, so the last batch is padded."""
    monkeypatch.setenv("IC_TPU_BLOCKMLP_INTERPRET", "1")
    monkeypatch.setenv("IC_TPU_GELU_INTERPRET", "1")
    n = 10
    csv_path = tmp_path / "test.csv"
    csv_path.write_text("id,predict\n" + "".join(f"{i:05d},0\n" for i in range(n)))
    images = images_u8(n, seed=5)
    jcfg, cfg = _cfgs()
    p1, p2 = randomized_params(SIZE), randomized_params(SIZE)
    # a second, different fold: scale fold 2's kernels by a numpy draw
    rng = np.random.default_rng(9)
    p2 =jax.tree.map(lambda a: a * rng.uniform(0.8, 1.2, np.shape(a)).astype(np.float32), p2)

    jm = JaxManifest.from_csv(str(csv_path), is_test=True)
    jloader = JaxLoader(JaxArraySource(images), jm, batch_size=4,
                        sampler=JaxSampler(n), pad_last=True)
    bundle = ModelBundle(name="tiny", module=jax_model(), deep_supervised=True,
                         has_batch_stats=False, input_size=(SIZE, SIZE))
    jids, jpreds, jprobs = jax_predict([bundle, bundle], [{"params": p1}, {"params": p2}],
                                       jloader, jcfg)

    m = Manifest.from_csv(str(csv_path), is_test=True)
    loader = DataLoader(ArraySource(images), m, batch_size=4,
                        sampler=SequentialSampler(n), pad_last=True, device="cpu")
    ids, preds, probs = predict_ensemble([port_model(p1), port_model(p2)], loader, cfg)

    assert ids == list(jids) == [str(i) for i in range(n)]
    assert probs.shape == (n, 7)
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(preds, jpreds)
    ours, theirs = tmp_path / "ours.csv", tmp_path / "theirs.csv"
    write_submission(ids, preds, str(ours))
    jax_write(jids, jpreds, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()


def test_cli_predict_writes_the_ensemble_submission(tmp_path):
    """`cli predict` on the CPU: fold checkpoints and the decode cache from
    disk, the same CSV as predict_ensemble run directly."""
    n = 6
    test_dir, cache = tmp_path / "test", tmp_path / "cache"
    test_dir.mkdir()
    (tmp_path / "test.csv").write_text(
        "id,predict\n" + "".join(f"img{i},0\n" for i in range(n)))
    images = images_u8(n, seed=6)
    ids = np.array([f"img{i}" for i in range(n)], dtype=object)
    for id_, im in zip(ids, images):
        cv2.imwrite(str(test_dir / f"{id_}.png"), cv2.cvtColor(im, cv2.COLOR_RGB2BGR))
    ImageSource(str(test_dir), ids, native_size=NATIVE, cache_dir=str(cache))
    overrides = [
        "model_name=convnext_atto", "num_classes=5", "compute_dtype=float32",
        f"native_size={list(NATIVE)}", f"image_size={[SIZE, SIZE]}",
        "batch_size=4", "infer_batch_multiplier=1",
        f"test_csv={tmp_path / 'test.csv'}", f"test_dir={test_dir}",
        f"cache_dir={cache}", f"model_save_path={tmp_path / 'models'}",
        f"submission_path={tmp_path / 'sub.csv'}",
    ]
    from image_classification_tpu_torch.core.config import load_config

    cfg = load_config(None, overrides)
    os.makedirs(cfg.model_save_path)
    models = []
    for fold in (1, 2):
        model = create_model(cfg, generator=torch.Generator().manual_seed(fold)).module
        torch.save(model.state_dict(), cli.checkpoint_path(cfg.model_save_path, fold))
        models.append(model)
    cli.main(["predict", "--device", "cpu", "--folds", "1,2", *overrides])

    loader = DataLoader(ArraySource(images), Manifest.from_csv(cfg.test_csv, is_test=True),
                        batch_size=4, device="cpu")
    ids_d, preds, _ = predict_ensemble(models, loader, cfg)
    write_submission(ids_d, preds, str(tmp_path / "direct.csv"))
    assert (tmp_path / "sub.csv").read_bytes() == (tmp_path / "direct.csv").read_bytes()
