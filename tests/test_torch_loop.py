"""The port's K-fold training loop and its ``cli train`` against the JAX
package's ``train_k_fold``, on the CPU, at ``convnext_atto`` and 32 px in
f32 with the aug, the mix and deep supervision off (no random draws: both
sides see the same batches in the same order). Both packages start every
fold from one timm-keyed file, written with the JAX package's
``export_convnext`` and loaded through ``pretrained_path``.

Tolerances: f32 on both sides with sums in another order. Over 2 folds of
up to 3 epochs (4 optimizer steps each) the losses agreed to 7.1e-7
relative and the best weights to 1.4e-5 of each tensor's largest element
(Adam's m / sqrt(v) magnifies f32 rounding where v is small:
``test_torch_train.py``); the bounds are 1e-4, 7x the larger.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_classification_tpu.core.config import Config as JaxConfig
from image_classification_tpu.data import DataLoader as JaxLoader
from image_classification_tpu.data import Manifest as JaxManifest
from image_classification_tpu.data.sampling import SequentialSampler as JaxSequential
from image_classification_tpu.data.source import ArraySource as JaxArraySource
from image_classification_tpu.infer import predict_ensemble as jax_predict
from image_classification_tpu.models.factory import create_model as jax_create_model
from image_classification_tpu.models.factory import load_pretrained_into as jax_load_pretrained
from image_classification_tpu.models.pretrained import export_convnext
from image_classification_tpu.train.kfold import make_fold_loaders as jax_make_fold_loaders
from image_classification_tpu.train.kfold import train_k_fold as jax_train_k_fold
from image_classification_tpu.train.loop import train_fold as jax_train_fold
from image_classification_tpu.train.loop import progressive_size as jax_progressive_size
from image_classification_tpu.utils import checkpoint as jax_ckpt
from image_classification_tpu_torch import cli
from image_classification_tpu_torch.core.config import Config, load_config
from image_classification_tpu_torch.data import Manifest, save_decode_cache
from image_classification_tpu_torch.models.convnext import CONVNEXT_CONFIGS
from image_classification_tpu_torch.models.factory import create_model, load_pretrained_into
from image_classification_tpu_torch.models.layers import drop_sites
from image_classification_tpu_torch.models.pretrained import convnext_state_dict_from_jax
from image_classification_tpu_torch.train import kfold
from image_classification_tpu_torch.train.loop import progressive_size, train_fold
from image_classification_tpu_torch.train.train_state import create_train_state
from image_classification_tpu_torch.utils import checkpoint as ckpt
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse, module scope)

NUM_CLASSES, SIZE, N_TRAIN, N_TEST = 6, 32, 64, 12
FOLDS, EPOCHS = 2, 3
REL = 1e-4


def settings(root: str, tag: str, **over) -> dict:
    kw = dict(
        model_name="convnext_atto", num_classes=NUM_CLASSES,
        image_size=(SIZE, SIZE), native_size=(SIZE, SIZE),
        use_deep_supervision=False, aug_enabled=False, mixup_alpha=0.0,
        cutmix_alpha=0.0, compute_dtype="float32", batch_size=8,
        gradient_accumulation_steps=2, epochs=EPOCHS, num_folds=FOLDS,
        patience=1, lr=2e-3, use_ema=True, ema_decay=0.9, pretrained=True,
        pretrained_path=f"{root}/init.pt", train_csv=f"{root}/train.csv",
        test_csv=f"{root}/test.csv", train_dir=f"{root}/train",
        test_dir=f"{root}/test", cache_dir=f"{root}/cache",
        model_save_path=f"{root}/{tag}/models", output_dir=f"{root}/{tag}/out",
        submission_path=f"{root}/{tag}/submission.csv",
    )
    kw.update(over)
    return kw


def overrides(kw: dict) -> list[str]:
    def val(v):
        return json.dumps(list(v)) if isinstance(v, tuple) else (
            json.dumps(v) if isinstance(v, bool) else str(v))
    return [f"{k}={val(v)}" for k, v in kw.items()]


def write_data(root: str) -> dict:
    """CSVs, decode caches and the timm-keyed initial weights."""
    rng = np.random.default_rng(0)
    labels = np.concatenate([np.arange(NUM_CLASSES),
                             rng.integers(0, NUM_CLASSES, N_TRAIN - NUM_CLASSES)])
    images = {"train": rng.integers(0, 256, (N_TRAIN, SIZE, SIZE, 3), dtype=np.uint8),
              "test": rng.integers(0, 256, (N_TEST, SIZE, SIZE, 3), dtype=np.uint8)}
    with open(f"{root}/train.csv", "w") as f:
        f.write("id,target\n" + "".join(f"{i:03d},{v}\n" for i, v in enumerate(labels)))
    with open(f"{root}/test.csv", "w") as f:
        f.write("id,predict\n" + "".join(f"t{i}.x,0\n" for i in range(N_TEST)))
    for split in ("train", "test"):
        ids = Manifest.from_csv(f"{root}/{split}.csv", is_test=split == "test").ids
        save_decode_cache(f"{root}/{split}", ids, images[split], f"{root}/cache")
    # flax's init with the layer scale raised from 1e-6, so every block acts
    jcfg = JaxConfig(**settings(root, "init")).validate()
    params = jax.tree.map(np.asarray, jax_create_model(jcfg).init(jax.random.key(3))["params"])
    for name, sub in params.items():
        if "gamma" in sub:
            sub["gamma"] = np.full_like(sub["gamma"], 0.5)
    depths, dims = CONVNEXT_CONFIGS["convnext_atto"]
    sd = export_convnext(params, depths, dims)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
               f"{root}/init.pt")
    return {"labels": labels, "images": images}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One ``cli train`` of the port (then ``cli predict`` on its
    checkpoints) and one ``train_k_fold`` + ``predict_ensemble`` of the JAX
    package, on the same data and initial weights."""
    root = str(tmp_path_factory.mktemp("loop"))
    data = write_data(root)
    kw = settings(root, "port")
    cli.main(["train", "--device", "cpu", *overrides(kw)])
    cli.main(["predict", "--device", "cpu", "--folds", "1,2", *overrides(kw),
              f"submission_path={root}/port/predict.csv"])

    jkw = settings(root, "jax")
    jcfg = JaxConfig(**jkw).validate()
    manifest = JaxManifest.from_csv(jcfg.train_csv, num_classes=NUM_CLASSES)
    results = jax_train_k_fold(jcfg, manifest=manifest,
                               source=JaxArraySource(data["images"]["train"]))
    test_manifest = JaxManifest.from_csv(jcfg.test_csv, is_test=True)
    loader = JaxLoader(JaxArraySource(data["images"]["test"]), test_manifest,
                       batch_size=16, sampler=JaxSequential(N_TEST), pad_last=True)
    ids, preds, probs = jax_predict([r.bundle for r in results],
                                    [r.best_variables for r in results], loader, jcfg)
    return {"root": root, "kw": kw, "jkw": jkw, "jax": results,
            "jax_ids": ids, "jax_preds": preds, "jax_probs": probs,
            "train_images": data["images"]["train"]}


def read_metrics(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def read_csv(path: str) -> list[list[str]]:
    with open(path) as f:
        return [line.split(",") for line in f.read().splitlines()]


def test_histories_and_early_stop_match_jax(runs):
    ours = read_metrics(f"{runs['kw']['output_dir']}/metrics.jsonl")
    for r in runs["jax"]:
        mine = [m for m in ours if m["fold"] == r.fold]
        assert [m["epoch"] for m in mine] == [h["epoch"] for h in r.history]
        for m, h in zip(mine, r.history):
            for key in ("train_loss", "val_loss"):
                assert m[key] == pytest.approx(h[key], rel=REL), (r.fold, m["epoch"], key)
            # equal counts of correct validation images (and train batches)
            assert m["val_acc"] == h["val_acc"] and m["train_acc"] == h["train_acc"]
            assert set(m) == set(h) | {"fold"} and m["steps"] == h["steps"]
    assert len(ours) == sum(len(r.history) for r in runs["jax"])
    # patience=1 stopped a fold early (an epoch without a better val acc)
    assert len(ours) < FOLDS * EPOCHS


@pytest.mark.parametrize("metric", ["acc", "loss"])
def test_best_weights_and_metadata_match_jax(runs, metric):
    for r in runs["jax"]:
        mine, meta = ckpt.load_best(runs["kw"]["model_save_path"], r.fold, metric)
        path = jax_ckpt.best_path(runs["jkw"]["model_save_path"], r.fold, metric)
        theirs = jax_ckpt.load_metadata(path)
        assert meta["val_acc"] == theirs["val_acc"]
        assert meta["val_loss"] == pytest.approx(theirs["val_loss"], rel=REL)
        assert (meta["fold"], meta["metric"]) == (theirs["fold"], theirs["metric"])
        if metric == "acc":
            ref = convnext_state_dict_from_jax(r.best_variables["params"])
        else:
            template = {"params": r.best_variables["params"]}
            ref = convnext_state_dict_from_jax(
                jax_ckpt.load_best(runs["jkw"]["model_save_path"], r.fold, template,
                                   metric)[0]["params"])
        assert set(mine) == set(ref)
        for k, v in ref.items():
            scale = max(float(v.abs().max()), 1e-3)
            assert float((mine[k] - v).abs().max()) <= REL * scale, k


def test_submission_matches_jax(runs):
    rows = read_csv(runs["kw"]["submission_path"])
    assert rows[0] == ["id", "target"]
    assert [r[0] for r in rows[1:]] == runs["jax_ids"]
    top2 = np.sort(runs["jax_probs"], axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 1e-4
    ours = np.array([int(r[1]) for r in rows[1:]])
    assert decided.sum() >= N_TEST // 2
    np.testing.assert_array_equal(ours[decided], runs["jax_preds"][decided])


def test_cli_predict_reproduces_cli_train(runs):
    root = runs["root"]
    train_rows = read_csv(runs["kw"]["submission_path"])
    predict_rows = read_csv(f"{root}/port/predict.csv")
    assert predict_rows[0] == ["id", "predict"]
    assert predict_rows[1:] == train_rows[1:]
    out = runs["kw"]["output_dir"]
    for fold in (1, 2):
        assert os.path.exists(f"{out}/train_state_fold{fold}.pt")
    with open(f"{out}/train.log") as f:
        assert "failed; continuing" not in f.read()


@pytest.mark.parametrize("metric", ["acc", "loss"])
def test_select_best_fold_matches_jax(runs, metric):
    fold, score = ckpt.select_best_fold(runs["kw"]["model_save_path"], [1, 2], metric)
    jfold, jscore = jax_ckpt.select_best_fold(runs["jkw"]["model_save_path"], [1, 2], metric)
    assert fold == jfold and score == pytest.approx(jscore, rel=REL)
    with pytest.raises(FileNotFoundError):
        ckpt.select_best_fold(runs["kw"]["model_save_path"], [7], metric)


def _fold_loaders(cfg, root):
    manifest = Manifest.from_csv(cfg.train_csv, num_classes=NUM_CLASSES)
    source = kfold.build_source(cfg, manifest, cfg.train_dir)
    train_idx, val_idx = next(kfold.stratified_kfold(manifest.labels, 2, 42))
    return kfold.make_fold_loaders(cfg, source, manifest, train_idx, val_idx,
                                   device="cpu")[:2]


def test_resume_is_bit_identical(runs, tmp_path):
    """One epoch, then ``resume`` to two, against two straight epochs: the
    same parameters, EMA, moments and counters to the bit, and the same
    second epoch. The plateau schedule, whose horizon does not depend on
    ``epochs``, with its state carried in the checkpoint."""
    root = runs["root"]

    def cfg(tag, epochs):
        return Config(**settings(root, "x", model_save_path=f"{tmp_path}/{tag}/m",
                                 output_dir=f"{tmp_path}/{tag}/o", epochs=epochs,
                                 patience=10, schedule="plateau",
                                 plateau_patience=0, plateau_factor=0.5)).validate()

    straight = train_fold(cfg("a", 2), *_fold_loaders(cfg("a", 2), root))
    train_fold(cfg("b", 1), *_fold_loaders(cfg("b", 1), root))
    resumed = train_fold(cfg("b", 2), *_fold_loaders(cfg("b", 2), root), resume=True)
    assert [h["epoch"] for h in resumed.history] == [1]
    for key in ("train_loss", "val_loss", "val_acc"):
        assert resumed.history[0][key] == straight.history[1][key]
    a = torch.load(ckpt.resume_path(f"{tmp_path}/a/o", 1), weights_only=True)
    b = torch.load(ckpt.resume_path(f"{tmp_path}/b/o", 1), weights_only=True)
    assert (a["count"], a["step"], a["epoch"]) == (b["count"], b["step"], b["epoch"]) == (8, 8, 1)
    assert a["host_state"] == b["host_state"]
    for part in ("model", "ema", "mu", "nu"):
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part]), part
    for k, v in straight.best_variables.items():
        assert torch.equal(v, resumed.best_variables[k])


def test_train_state_falls_back_to_prev(tmp_path, runs):
    """A crash between moving the old checkpoint aside and the rename of the
    new one leaves only ``.prev``: the resume reads it."""
    out = runs["kw"]["output_dir"]
    path = ckpt.resume_path(out, 1)
    os.makedirs(tmp_path / "o")
    moved = ckpt.resume_path(str(tmp_path / "o"), 1) + ".prev"
    with open(path, "rb") as src, open(moved, "wb") as dst:
        dst.write(src.read())
    cfg = load_config(None, overrides(runs["kw"]))
    state = create_train_state(create_model(cfg).module)
    restored = ckpt.load_train_state(str(tmp_path / "o"), 1, state)
    assert restored is not None and os.path.exists(ckpt.resume_path(str(tmp_path / "o"), 1))
    saved = torch.load(path, weights_only=True)
    assert restored[1] == saved["epoch"] + 1 and restored[2] == saved["host_state"]
    for name, p in zip(state.names(), state.params()):
        assert torch.equal(p, saved["model"][name])


def test_async_writer_reraises():
    writer = ckpt.AsyncCheckpointWriter()
    box = []
    writer.submit(box.append, 1)
    writer.submit(lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        writer.join()
    writer.join()
    assert box == [1]


def test_load_pretrained_into_matches_jax(runs, caplog):
    """The import keeps the random init without a file, strips the head on
    request and skips tensors of another shape, as the JAX import does."""
    root = runs["root"]
    base = settings(root, "x")
    sd = torch.load(f"{root}/init.pt", weights_only=True)
    sd["head.fc.weight"] = torch.zeros(NUM_CLASSES + 1, sd["head.fc.weight"].shape[1])
    sd["head.fc.bias"] = torch.arange(float(NUM_CLASSES))
    torch.save({"state_dict": sd}, f"{root}/wrapped.pt")
    for over in ({}, {"pretrained_strip_head": True}):
        cfg = Config(**{**base, "pretrained_path": f"{root}/wrapped.pt", **over}).validate()
        model = load_pretrained_into(create_model(cfg).module, cfg)
        jcfg = JaxConfig(**{**base, "pretrained_path": f"{root}/wrapped.pt", **over}).validate()
        bundle = jax_create_model(jcfg)
        ref = convnext_state_dict_from_jax(
            jax_load_pretrained(bundle, bundle.init(jax.random.key(0)), jcfg)["params"])
        got = model.state_dict()
        for k, v in ref.items():
            if k.startswith("head.fc"):   # random init on both sides
                continue
            assert torch.equal(got[k], v), k
        assert torch.equal(got["head.fc.bias"], sd["head.fc.bias"]) != bool(over)
    missing = Config(**{**base, "pretrained_path": f"{root}/none.pt"}).validate()
    model = create_model(missing).module
    before = {k: v.clone() for k, v in model.state_dict().items()}
    logger = logging.getLogger("ic_tpu_torch")   # propagates nowhere once set up
    logger.addHandler(caplog.handler)
    try:
        load_pretrained_into(model, missing)
    finally:
        logger.removeHandler(caplog.handler)
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())
    assert "not found; random init" in caplog.text


@pytest.mark.parametrize("epoch", range(6))
def test_progressive_size_matches_jax(epoch):
    kw = dict(image_size=(260, 260), epochs=6, progressive_resizing=True)
    assert progressive_size(Config(**kw).validate(), epoch) == \
        jax_progressive_size(JaxConfig(**kw).validate(), epoch)


@pytest.mark.parametrize("over", [
    {"fold_parallel": True}, {"gelu_approximate": True},
    {"drop_path_rate": 0.1}, {"ensemble_models": ("convnext_atto",)},
])
def test_what_is_not_ported_raises(runs, over, tmp_path):
    """``fold_parallel`` trains the folds side by side on 2 gloo ranks and
    gives rank 0 one result per fold, each with its history and best
    weights (the rank holding the other fold gets its own). Tanh GELU,
    ConvNeXt's drop-path and
    the ensemble trainer are ported: tanh GELU trains fold 1 as JAX's
    ``train_fold`` does; a drop-path fold trains (finite losses) and draws
    one mask a step for each draw JAX's traced train-mode forward asks
    for, in its shapes; an ensemble of one member trains the K folds of
    ``runs``' JAX ``train_k_fold`` under ``<models>/<member>``, with JAX's
    ``train_ensemble`` weights (1 / the member's result count)."""
    kw = {**settings(runs["root"], "x", epochs=1), **over}
    cfg = Config(**kw).validate()
    if "fold_parallel" in over:
        from torch_spawn import kfold_worker, load_ranks, run_ranks

        run_ranks(kfold_worker, 2, str(tmp_path), str(tmp_path), cfg)
        first, second = load_ranks(str(tmp_path), 2)
        names = set(create_model(cfg).module.state_dict())
        assert [(f, n) for f, n, _ in first] == [(1, 1), (2, 1)]
        assert [(f, n) for f, n, _ in second] == [(2, 1)]
        assert all(set(keys) == names for _, _, keys in first + second)
    elif "gelu_approximate" in over:
        jkw = {**kw, "model_save_path": f"{tmp_path}/jax/m", "output_dir": f"{tmp_path}/jax/o"}
        jcfg = JaxConfig(**jkw).validate()
        ours = train_fold(cfg, *_fold_loaders(cfg, runs["root"]))
        manifest = JaxManifest.from_csv(jcfg.train_csv, num_classes=NUM_CLASSES)
        train_idx, val_idx = next(kfold.stratified_kfold(manifest.labels, 2, 42))
        loaders = jax_make_fold_loaders(jcfg, JaxArraySource(runs["train_images"]),
                                        manifest, train_idx, val_idx)
        theirs = jax_train_fold(jcfg, loaders[0], loaders[1], fold=1)
        assert len(ours.history) == len(theirs.history) == 1
        for key in ("train_loss", "val_loss"):
            assert ours.history[0][key] == pytest.approx(theirs.history[0][key], rel=REL)
        assert ours.best_val_acc == theirs.best_val_acc
    elif "drop_path_rate" in over:
        ours = train_fold(cfg, *_fold_loaders(cfg, runs["root"]))
        assert np.isfinite([ours.history[0]["train_loss"], ours.history[0]["val_loss"]]).all()
        shapes = []

        def record(key, p=0.5, shape=None, **_):
            shapes.append(tuple(shape))
            return jnp.ones(shape, bool)

        jcfg = JaxConfig(**kw).validate()
        bundle = jax_create_model(jcfg)
        micro = cfg.batch_size // cfg.gradient_accumulation_steps
        x = jnp.zeros((micro, SIZE, SIZE, 3))
        real = jax.random.bernoulli
        jax.random.bernoulli = record
        try:
            jax.eval_shape(lambda v: bundle.apply(v, x, deterministic=False,
                                                  rngs={"dropout": jax.random.key(0)}),
                           jax.eval_shape(bundle.init, jax.random.key(0)))
        finally:
            jax.random.bernoulli = real
        sites = drop_sites(ours.bundle.module)
        assert [s.mask_shape(micro) for s in sites] == \
            [(micro,) if len(sh) == 4 else sh for sh in shapes]
    else:
        results, weights = kfold.train_ensemble(cfg.replace(epochs=EPOCHS), device="cpu")
        assert [r.fold for r in results] == [r.fold for r in runs["jax"]]
        assert weights == [1.0 / len(runs["jax"])] * len(runs["jax"])
        for mine, theirs in zip(results, runs["jax"]):
            assert mine.bundle.name == "convnext_atto"
            for m, h in zip(mine.history, theirs.history, strict=True):
                assert m["val_loss"] == pytest.approx(h["val_loss"], rel=REL)
            assert os.path.exists(ckpt.best_path(f"{kw['model_save_path']}/convnext_atto",
                                                 mine.fold))


def _swa_lines(caplog) -> list[tuple[float, float]]:
    out, seen = [], set()
    for rec in caplog.records:   # a record may reach the handler twice
        msg = rec.getMessage()
        if id(rec) in seen:
            continue
        seen.add(id(rec))
        if "SWA (2 snapshots): val " in msg:
            loss, acc = msg.rsplit("val ", 1)[1].split("/")
            out.append((float(loss), float(acc)))
    return out


def test_swa_on_convnext_matches_jax(runs, tmp_path, caplog):
    """SWA on ``convnext_atto`` (no BatchNorm, so no BN update), fold 1 of
    the shared data, 3 epochs with snapshots after epochs 2 and 3: the SWA
    validation, the history, and the best weights and metadata of both
    tiers (SWA competes in each) against JAX's ``train_fold``."""
    root = runs["root"]
    kw = settings(root, "swa", use_swa=True, swa_start_epoch=2, patience=10,
                  model_save_path=f"{tmp_path}/port/m", output_dir=f"{tmp_path}/port/o")
    jkw = {**kw, "model_save_path": f"{tmp_path}/jax/m", "output_dir": f"{tmp_path}/jax/o"}
    cfg, jcfg = Config(**kw).validate(), JaxConfig(**jkw).validate()
    loggers = [logging.getLogger(n) for n in ("ic_tpu_torch", "ic_tpu")]
    for lg in loggers:
        lg.addHandler(caplog.handler)
    try:
        caplog.set_level(logging.INFO)
        ours = train_fold(cfg, *_fold_loaders(cfg, root))
        port_lines = _swa_lines(caplog)
        caplog.clear()
        manifest = JaxManifest.from_csv(jcfg.train_csv, num_classes=NUM_CLASSES)
        train_idx, val_idx = next(kfold.stratified_kfold(manifest.labels, 2, 42))
        loaders = jax_make_fold_loaders(jcfg, JaxArraySource(runs["train_images"]),
                                        manifest, train_idx, val_idx)
        theirs = jax_train_fold(jcfg, loaders[0], loaders[1], fold=1)
        jax_lines = _swa_lines(caplog)
    finally:
        for lg in loggers:
            lg.removeHandler(caplog.handler)
    assert len(port_lines) == len(jax_lines) == 1
    assert port_lines[0] == pytest.approx(jax_lines[0], abs=2e-4)
    assert [h["epoch"] for h in ours.history] == [h["epoch"] for h in theirs.history]
    for m, h in zip(ours.history, theirs.history):
        assert m["val_loss"] == pytest.approx(h["val_loss"], rel=REL)
    assert ours.best_val_acc == theirs.best_val_acc
    for metric in ("acc", "loss"):
        mine, meta = ckpt.load_best(f"{tmp_path}/port/m", 1, metric)
        jmeta = jax_ckpt.load_metadata(jax_ckpt.best_path(f"{tmp_path}/jax/m", 1, metric))
        assert meta["val_acc"] == jmeta["val_acc"]
        assert meta["val_loss"] == pytest.approx(jmeta["val_loss"], rel=REL)
        template = {"params": theirs.best_variables["params"]}
        ref = convnext_state_dict_from_jax(jax_ckpt.load_best(
            f"{tmp_path}/jax/m", 1, template, metric)[0]["params"])
        for k, v in ref.items():
            scale = max(float(v.abs().max()), 1e-3)
            assert float((mine[k] - v).abs().max()) <= REL * scale, (metric, k)
