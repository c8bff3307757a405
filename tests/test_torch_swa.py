"""The EfficientNet train step, the eval step's mode, the BN-update step and
SWA of the port against the JAX package's, in f32 on the CPU, on the small
EfficientNet of ``test_torch_effnet.py`` (every block form, drop-path and
head dropout on) with the same weights, inputs and drop masks; then the
port's ``cli train`` -> ``cli predict`` on ``configs/v1_effb0.json`` and
``configs/v3_1.json`` at a tiny size, and a resumed V3.1 fold.

Both sides get the same drop masks: the port's, drawn on a torch generator,
replace ``jax.random.bernoulli`` in the traced JAX step.

Tolerances: those of ``test_torch_train.py`` (the loss to 1e-5 relative;
parameters and EMA to 1e-3 of lr, as Adam's m / sqrt(v) magnifies f32
rounding where v is small) and of ``test_torch_effnet.py`` (running
statistics to 1e-5 relative).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_classification_tpu.core.config import Config as JaxConfig
from image_classification_tpu.infer.predict import _cast_inference_params as jax_cast
from image_classification_tpu.models.factory import ModelBundle as JaxBundle
from image_classification_tpu.train import loss as jax_loss
from image_classification_tpu.train.loop import evaluate as jax_evaluate
from image_classification_tpu.train.fused import _rebuild_opt_state
from image_classification_tpu.train.optim import build_optimizer as jax_build_opt
from image_classification_tpu.train.step import make_bn_update_step as jax_make_bn
from image_classification_tpu.train.step import make_eval_step as jax_make_eval
from image_classification_tpu.train.step import make_train_step as jax_make_train
from image_classification_tpu.train.train_state import create_train_state as jax_create
from image_classification_tpu.train.train_state import swa_update as jax_swa_update
from image_classification_tpu_torch import cli
from image_classification_tpu_torch.core.config import Config, load_config
from image_classification_tpu_torch.data import Manifest, save_decode_cache
from image_classification_tpu_torch.infer.predict import _cast_inference_params
from image_classification_tpu_torch.models.factory import ModelBundle
from image_classification_tpu_torch.models.layers import draw_drop_masks, drop_sites
from image_classification_tpu_torch.models.pretrained import (
    efficientnet_state_dict_from_jax,
    train_state_from_jax,
)
from image_classification_tpu_torch.train import kfold
from image_classification_tpu_torch.train import loss
from image_classification_tpu_torch.train.loop import finalize_swa, train_fold
from image_classification_tpu_torch.train.optim import build_optimizer
from image_classification_tpu_torch.train.step import (
    StepDraws,
    make_bn_update_step,
    make_eval_step,
    make_forward_views,
    make_train_step,
)
from image_classification_tpu_torch.train.train_state import swa_update
from image_classification_tpu_torch.utils import checkpoint as ckpt
from test_torch_effnet import (
    HW,
    NUM_CLASSES,
    STATS_RTOL,
    inject_bernoulli,
    jax_small,
    jax_stats,
    port_small,
    randomized,
    stats_of,
)
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse, module scope)
from test_torch_train import _tree

B, ACCUM = 8, 2
LR = 1e-3


def cfgs(**over):
    kw = dict(num_classes=NUM_CLASSES, image_size=HW, native_size=(24, 32),
              batch_size=B, gradient_accumulation_steps=ACCUM, aug_enabled=False,
              use_deep_supervision=False, label_smoothing=0.1,
              compute_dtype="float32", lr=LR, weight_decay=1e-2,
              gradient_clip_val=1.0, schedule="none", use_ema=True, ema_decay=0.9)
    kw.update(over)
    return JaxConfig(**kw).validate(), Config(**kw).validate()


@pytest.fixture(scope="module")
def start():
    """The small EfficientNet (drop-path 0.25, dropout 0.3) with randomized
    weights and running statistics, as a JAX train state and a port one."""
    jm = jax_small(0.3, 0.25)
    variables = randomized(jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, *HW, 3))))
    return jm, variables


def fresh(start, jcfg, count=30):
    """Both states at Adam count 30 with random moments, ``nu >= mu^2``
    (as ``test_torch_train.start_states``: from zero moments every
    parameter moves by ~lr whatever its gradient, and where the gradient is
    ~0 that magnifies f32 rounding), and an empty SWA average."""
    jm, variables = start
    params = variables["params"]
    rng = np.random.default_rng(11)
    mu = _tree(rng, params, 1e-3)
    nu = jax.tree.map(lambda m, n: m * m + n, mu, _tree(rng, params, 1e-6, positive=True))
    tx_j = jax_build_opt(jcfg, jcfg.lr)
    jstate = jax_create(variables, tx_j, use_ema=True, use_swa=True)
    jstate = jstate.replace(step=jnp.asarray(count, jnp.int32), opt_state=_rebuild_opt_state(
        jstate.opt_state, jnp.asarray(count, jnp.int32), mu, nu))
    model = port_small(0.3, 0.25)
    zeros = jax.tree.map(np.zeros_like, params)
    state = train_state_from_jax(model, params, params, mu, nu, count, count,
                                 batch_stats=variables["batch_stats"], swa=zeros,
                                 swa_count=0)
    jbundle = JaxBundle(name="tiny", module=jm, deep_supervised=False,
                        has_batch_stats=True, input_size=HW)
    bundle = ModelBundle("tiny", model, False, HW, has_batch_stats=True)
    return tx_j, jstate, jbundle, state, bundle


def port_as_np(model) -> dict:
    return {k: v.numpy() for k, v in model.state_dict().items()}


def jax_as_port(params, batch_stats=None) -> dict:
    return {k: v.numpy() for k, v in efficientnet_state_dict_from_jax(
        jax.tree.map(np.asarray, params),
        None if batch_stats is None else jax.tree.map(np.asarray, batch_stats)).items()}


def assert_close(ours: dict, theirs: dict, atol, what, rtol=0.0):
    assert set(theirs) <= set(ours)
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


def u8_batches(seed, sizes, with_mask=False):
    """uint8 batches at the model's size: ``eval_preprocess`` only
    normalises (the resize, rounded to integers, is held in
    ``test_torch_aug.py``; a rounding flip would move a statistic by ~1e-6
    here)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        b = {"image": rng.integers(0, 256, (n, *HW, 3), dtype=np.uint8),
             "label": rng.integers(0, NUM_CLASSES, n).astype(np.int32)}
        if with_mask:
            b["mask"] = np.arange(n) < n - 1
        out.append(b)
    return out


def as_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def as_port(b):
    return {k: torch.from_numpy(v) if k != "mask" else v for k, v in b.items()}


class Loader(list):
    """A list of batches with the loader's ``set_epoch``."""

    def set_epoch(self, epoch: int) -> None:
        pass


def port_bn_masks(model, rows):
    return draw_drop_masks(torch.Generator().manual_seed(0), drop_sites(model), rows)


# --------------------------------------------------------------- the steps
def test_train_step_then_eval_step_match_jax(start, monkeypatch):
    """One train step (aug off, accumulation 2, drop masks on both
    microbatches, clip, AdamW and EMA): the loss, the parameters, the EMA
    and the running statistics threaded through both microbatches. The
    step must run the model in train mode (batch statistics, masks) and
    leave it there. Then the eval step on the EMA weights with the live
    statistics, in eval mode, which changes no buffer, and the predict
    path's forward, which does not either."""
    jcfg, cfg = cfgs()
    tx_j, jstate, jbundle, state, bundle = fresh(start, jcfg)
    sites = drop_sites(bundle.module)
    gen = torch.Generator().manual_seed(5)
    masks = draw_drop_masks(gen, sites, B // ACCUM)
    assert any(not bool(m.all()) for m in masks)
    calls = inject_bernoulli(monkeypatch, [m.numpy() for m in masks])
    rng = np.random.default_rng(3)
    images = rng.normal(size=(B, *HW, 3)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, B).astype(np.int32)

    jstep = jax.jit(jax_make_train(jbundle, jcfg, tx_j, jax_loss.build_criterion(jcfg)))
    jstate, jm = jstep(jstate, {"image": jnp.asarray(images), "label": jnp.asarray(labels)},
                       jax.random.key(0))
    assert len(calls) % len(sites) == 0 and calls
    step = make_train_step(bundle, cfg, build_optimizer(cfg, cfg.lr),
                           loss.build_criterion(cfg))
    with pytest.raises(ValueError, match="draws"):
        step(state, {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)})
    state, m = step(state, {"image": torch.from_numpy(images),
                            "label": torch.from_numpy(labels).long()},
                    draws=StepDraws(None, None, (masks, masks)))
    assert bundle.module.training
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert float(m["accuracy"]) == float(jm["accuracy"])
    ours = port_as_np(bundle.module)
    assert_close(ours, jax_as_port(jstate.params), 1e-3 * LR, "params")
    assert_close(ours, jax_stats({"params": jstate.params, "batch_stats": jstate.batch_stats}),
                 1e-6, "running stats", rtol=STATS_RTOL)
    assert_close(dict(zip(state.names(), (e.numpy() for e in state.ema))),
                 jax_as_port(jstate.ema_params), 1e-3 * LR, "ema")

    batch = u8_batches(4, [5], with_mask=True)[0]
    jeval = jax.jit(jax_make_eval(jbundle, jcfg))(jstate, as_jax(batch))
    before = {k: v.clone() for k, v in state.buffers().items()}
    got = make_eval_step(bundle, cfg)(state, as_port(batch))
    assert not bundle.module.training
    for k in ("loss_sum", "correct", "count"):
        np.testing.assert_allclose(float(got[k]), float(jeval[k]), rtol=1e-5, err_msg=k)
    bundle.module.train()
    make_forward_views(bundle.module)(torch.zeros(2, *HW, 3))
    assert not bundle.module.training
    assert all(torch.equal(v, before[k]) for k, v in state.buffers().items())


def test_bn_update_step_matches_jax(start, monkeypatch):
    """Three uint8 batches (6, 6 and 4 rows) through ``make_bn_update_step``
    with one set of parameters: the running statistics, updated from the
    live ones with momentum (not reset), drop-path and dropout active with
    the masks of a generator seeded 0 for each batch size (JAX: one fixed
    key). The port's masks replace JAX's."""
    jcfg, cfg = cfgs()
    _, jstate, jbundle, state, bundle = fresh(start, jcfg)
    holder = []
    inject_bernoulli(monkeypatch, holder)
    jbn = jax.jit(jax_make_bn(jbundle, jcfg))
    bn_step = make_bn_update_step(bundle, cfg)
    bs = jstate.batch_stats
    params = state.eval_params(use_ema=False)
    for batch in u8_batches(6, [6, 6, 4]):
        holder[:] = [m.numpy() for m in port_bn_masks(bundle.module, len(batch["label"]))]
        bs = jbn(jstate.params, bs, as_jax(batch))
        bn_step(params, as_port(batch))
    assert_close(stats_of(bundle.module), jax_stats({"params": jstate.params,
                                                     "batch_stats": bs}),
                 1e-6, "running stats", rtol=STATS_RTOL)


def test_swa_update_and_finalisation_match_jax(start, monkeypatch):
    """Three snapshots into SWA's average, ``(a n + p) / (n + 1)``; then
    the finalisation on them: the average as the weights with EMA off, the
    BN update over two train batches, validation on two eval batches. The
    JAX side is the sequence of its ``train_fold``'s SWA block."""
    jcfg, cfg = cfgs()
    _, jstate, jbundle, state, bundle = fresh(start, jcfg)
    rng = np.random.default_rng(7)
    for _ in range(3):
        noise = jax.tree.map(lambda p: (0.05 * rng.normal(size=p.shape)).astype(np.float32),
                             jstate.params)
        new = jax.tree.map(lambda p, n: np.asarray(p) + n, jstate.params, noise)
        jstate = jax_swa_update(jstate.replace(params=new))
        bundle.module.load_state_dict(efficientnet_state_dict_from_jax(new), strict=False)
        swa_update(state)
    assert state.swa_count == int(jstate.swa_count) == 3
    assert_close(dict(zip(state.names(), (a.numpy() for a in state.swa))),
                 jax_as_port(jstate.swa_params), 1e-7, "swa")

    holder = []
    inject_bernoulli(monkeypatch, holder)
    train = u8_batches(8, [6, 6])
    evals = u8_batches(9, [5, 5], with_mask=True)
    holder[:] = [m.numpy() for m in port_bn_masks(bundle.module, 6)]
    swa_j = jstate.replace(params=jstate.swa_params, ema_params=None)
    jbn = jax.jit(jax_make_bn(jbundle, jcfg))
    bs = jstate.batch_stats
    for b in train:
        bs = jbn(swa_j.params, bs, as_jax(b))
    swa_j = swa_j.replace(batch_stats=bs)
    theirs = jax_evaluate(jax.jit(jax_make_eval(jbundle, jcfg)), swa_j,
                          [as_jax(b) for b in evals])
    swa_state, ours = finalize_swa(bundle, cfg, state, Loader(as_port(b) for b in train),
                                   Loader(as_port(b) for b in evals),
                                   make_eval_step(bundle, cfg))
    assert swa_state.ema is None and state.ema is not None
    for k in ("loss", "accuracy"):
        assert ours[k] == pytest.approx(theirs[k], rel=1e-5), k
    assert_close(port_as_np(bundle.module), jax_as_port(swa_j.params, bs), 1e-6,
                 "swa weights and statistics", rtol=STATS_RTOL)


def test_inference_cast_matches_jax_rule(start):
    """``infer_cast_params``: the port casts what the JAX rule casts, the
    EfficientNet classifier's weight included; BN buffers stay f32."""
    jcfg, cfg = cfgs(compute_dtype="bfloat16")
    _, variables = start
    cast = jax_cast({"params": variables["params"]}, jcfg)["params"]
    # 1 where JAX cast the leaf to bf16, through the carrier to port names
    flags = efficientnet_state_dict_from_jax(jax.tree.map(
        lambda a: np.full(np.shape(a), float(a.dtype == jnp.bfloat16), np.float32), cast))
    theirs = {k for k, v in flags.items() if bool((v == 1).all())}
    model = _cast_inference_params(port_small(0.3, 0.25), cfg)
    ours = {k for k, p in model.named_parameters() if p.dtype == torch.bfloat16}
    assert ours == theirs and "classifier.weight" in ours and "classifier.bias" not in ours
    assert all(b.dtype == torch.float32 for b in model.buffers())


# ------------------------------------------------------ the presets, tiny
SIZE, N_TRAIN, N_TEST, CLASSES = 32, 48, 8, 4


def preset_overrides(root: str, tag: str) -> list[str]:
    return [f"train_csv={root}/train.csv", f"test_csv={root}/test.csv",
            f"train_dir={root}/train", f"test_dir={root}/test",
            f"cache_dir={root}/cache", f"model_save_path={root}/{tag}/models",
            f"output_dir={root}/{tag}/out", f"submission_path={root}/{tag}/submission.csv",
            f"num_classes={CLASSES}", f"native_size=[{SIZE},{SIZE}]",
            f"image_size=[{SIZE},{SIZE}]", "batch_size=8", "epochs=2", "num_folds=2",
            "compute_dtype=float32", "aug_enabled=false", "mixup_alpha=0.0",
            "cutmix_alpha=0.0"]


PRESETS = {"v1_effb0": [], "v3_1": ["model_name=efficientnet_b0", "swa_start_epoch=1"]}


@pytest.fixture(scope="module")
def presets(tmp_path_factory):
    """Tiny CSVs and decode caches; ``cli train`` then ``cli predict`` on
    each preset (the train-side aug off: its draws are tested elsewhere)."""
    root = str(tmp_path_factory.mktemp("effnet_presets"))
    rng = np.random.default_rng(0)
    labels = np.concatenate([np.arange(CLASSES), rng.integers(0, CLASSES, N_TRAIN - CLASSES)])
    images = {"train": rng.integers(0, 256, (N_TRAIN, SIZE, SIZE, 3), dtype=np.uint8),
              "test": rng.integers(0, 256, (N_TEST, SIZE, SIZE, 3), dtype=np.uint8)}
    with open(f"{root}/train.csv", "w") as f:
        f.write("id,target\n" + "".join(f"{i:03d},{v}\n" for i, v in enumerate(labels)))
    with open(f"{root}/test.csv", "w") as f:
        f.write("id,predict\n" + "".join(f"t{i}.x,0\n" for i in range(N_TEST)))
    for split in ("train", "test"):
        ids = Manifest.from_csv(f"{root}/{split}.csv", is_test=split == "test").ids
        save_decode_cache(f"{root}/{split}", ids, images[split], f"{root}/cache")
    for name, extra in PRESETS.items():
        config = os.path.join(os.path.dirname(__file__), "..", "configs", f"{name}.json")
        over = preset_overrides(root, name) + extra
        cli.main(["train", "--config", config, "--device", "cpu", *over])
        cli.main(["predict", "--config", config, "--device", "cpu", "--folds", "1,2",
                  *over, f"submission_path={root}/{name}/predict.csv"])
    return root


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_cli_predict_reproduces_cli_train(presets, name):
    """The saved best weights carry the running statistics, so ``cli
    predict`` (eval mode, strict load) writes ``cli train``'s submission;
    V3.1 logs its SWA line for each fold."""
    with open(f"{presets}/{name}/submission.csv") as f:
        train_rows = f.read().splitlines()
    with open(f"{presets}/{name}/predict.csv") as f:
        predict_rows = f.read().splitlines()
    assert len(train_rows) == N_TEST + 1 and predict_rows[1:] == train_rows[1:]
    best, _ = ckpt.load_best(f"{presets}/{name}/models", 1)
    assert any(k.endswith("running_var") for k in best)
    with open(f"{presets}/{name}/out/train.log") as f:
        log = f.read()
    swa_lines = [ln for ln in log.splitlines() if "SWA (2 snapshots)" in ln]
    assert len(swa_lines) == (2 if name == "v3_1" else 0), swa_lines
    with open(f"{presets}/{name}/out/metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert all(np.isfinite(r["train_loss"]) for r in records)


def test_resumed_v3_1_fold_continues_exactly(presets, tmp_path):
    """V3.1 (EMA, drop rates, SWA from epoch 1, the BN update) on
    ``efficientnet_b0``, with the plateau schedule (the cosine's horizon
    depends on ``epochs``): one epoch, then ``resume`` to two, against two
    straight epochs: the same parameters, buffers, EMA, moments, SWA
    average and counters to the bit, and the same second epoch. (The best
    weights may differ: the one-epoch run's SWA finalisation may have
    replaced its best checkpoint, as in the JAX package.)"""
    config = os.path.join(os.path.dirname(__file__), "..", "configs", "v3_1.json")

    def run(tag, epochs, resume=False):
        over = preset_overrides(presets, "r") + PRESETS["v3_1"] + [
            f"model_save_path={tmp_path}/{tag}/m", f"output_dir={tmp_path}/{tag}/o",
            f"epochs={epochs}", "patience=10", "schedule=plateau"]
        cfg = load_config(config, over)
        manifest = Manifest.from_csv(cfg.train_csv, num_classes=CLASSES)
        source = kfold.build_source(cfg, manifest, cfg.train_dir)
        train_idx, val_idx = next(kfold.stratified_kfold(manifest.labels, 2, 42))
        loaders = kfold.make_fold_loaders(cfg, source, manifest, train_idx, val_idx,
                                          device="cpu")
        return train_fold(cfg, loaders[0], loaders[1], class_counts=np.bincount(
            loaders[2], minlength=CLASSES), resume=resume)

    straight = run("a", 2)
    run("b", 1)
    resumed = run("b", 2, resume=True)
    assert [h["epoch"] for h in resumed.history] == [1]
    a = torch.load(ckpt.resume_path(f"{tmp_path}/a/o", 1), weights_only=True)
    b = torch.load(ckpt.resume_path(f"{tmp_path}/b/o", 1), weights_only=True)
    assert (a["count"], a["step"], a["swa_count"]) == (b["count"], b["step"], b["swa_count"])
    assert a["swa_count"] == 2 and a["buffers"]
    for part in ("model", "buffers", "ema", "swa", "mu", "nu"):
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part]), part
    for key in ("train_loss", "val_loss", "val_acc"):
        assert resumed.history[0][key] == straight.history[1][key], key
