"""The port's multi-architecture ensemble (``train_ensemble`` and the
``cli train`` branch that uses it) against the JAX package's
``train_ensemble`` + ``predict_ensemble``, on the CPU in f32 with the aug,
the mix and deep supervision off, on one tiny synthetic set.

The members are V2's kinds at a small size: ``convnext_atto`` and two ViTs
named into both packages' ``VIT_CONFIGS`` for the module (patch 8, dim 32,
depth 2, 4 heads), weighted .4 / .3 / .3. Both packages start every member
from one timm-keyed file holding ConvNeXt-atto's keys and the ViT's (their
key sets are disjoint; each importer takes its own), loaded through
``pretrained_path``. A second set at 28x28 holds the failing-member case:
a patch-8 ViT (28 is not a multiple of 8) fails every fold in both
packages beside a patch-4 ViT that trains.

Tolerances: f32 on both sides with sums in another order. Losses agree to
1e-4 relative, as in ``test_torch_loop.py``; predictions wherever the top
two probabilities are more than 1e-4 apart. The best weights (raw AdamW
weights: V2 trains without EMA) are held in units of the learning rate:
AdamW's first steps move an element by lr·g/(|g| + eps), so where |g| is
near eps (1e-8) f32 rounding of g moves the step by a share of lr. Measured:
at most 0.055 lr (ConvNeXt-atto's fc2, 2 steps a fold); the bound is 0.1
lr. The key third of ``attn.qkv.bias`` is left out: adding the key bias
shifts each query's scores by one constant along the keys, which the
softmax removes, so its gradient is zero in exact arithmetic and AdamW steps
on rounding noise (0.07-0.13 lr apart between the packages).
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

import jax

from image_classification_tpu.core.config import Config as JaxConfig
from image_classification_tpu.data import DataLoader as JaxLoader
from image_classification_tpu.data import Manifest as JaxManifest
from image_classification_tpu.data.sampling import SequentialSampler as JaxSequential
from image_classification_tpu.data.source import ArraySource as JaxArraySource
from image_classification_tpu.infer import predict_ensemble as jax_predict
from image_classification_tpu.models import vit as jax_vit_module
from image_classification_tpu.models.factory import create_model as jax_create_model
from image_classification_tpu.models.pretrained import export_convnext
from image_classification_tpu.train.kfold import train_ensemble as jax_train_ensemble
from image_classification_tpu.utils import checkpoint as jax_ckpt
from image_classification_tpu_torch import cli
from image_classification_tpu_torch.core.config import Config
from image_classification_tpu_torch.data import Manifest, save_decode_cache
from image_classification_tpu_torch.models import vit as port_vit_module
from image_classification_tpu_torch.models.convnext import CONVNEXT_CONFIGS
from image_classification_tpu_torch.models.pretrained import state_dict_from_jax
from image_classification_tpu_torch.train import kfold
from image_classification_tpu_torch.utils import checkpoint as ckpt
from test_torch_loop import overrides, read_csv
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse, module scope)

NUM_CLASSES, N_TRAIN, N_TEST, FOLDS = 4, 40, 10, 2
REL = 1e-4
WEIGHT_LR_TOL = 0.1
MICRO_VITS = {"vit_micro_patch8": dict(patch=8, dim=32, depth=2, heads=4),
              "deit_micro_patch8": dict(patch=8, dim=32, depth=2, heads=4),
              "vit_micro_patch4": dict(patch=4, dim=32, depth=2, heads=4)}
MEMBERS = ("convnext_atto", "vit_micro_patch8", "deit_micro_patch8")
WEIGHTS = (0.4, 0.3, 0.3)


def settings(root: str, tag: str, size: int, **over) -> dict:
    kw = dict(
        model_name=MEMBERS[0], ensemble_models=MEMBERS, ensemble_weights=WEIGHTS,
        num_classes=NUM_CLASSES, image_size=(size, size), native_size=(size, size),
        use_deep_supervision=False, aug_enabled=False, mixup_alpha=0.0,
        cutmix_alpha=0.0, compute_dtype="float32", batch_size=8,
        gradient_accumulation_steps=1, epochs=1, num_folds=FOLDS, patience=2,
        lr=2e-3, use_ema=False, save_state_every=0, pretrained=True,
        pretrained_path=f"{root}/init.pt",
        train_csv=f"{root}/train.csv", test_csv=f"{root}/test.csv",
        train_dir=f"{root}/train", test_dir=f"{root}/test", cache_dir=f"{root}/cache",
        model_save_path=f"{root}/{tag}/models", output_dir=f"{root}/{tag}/out",
        submission_path=f"{root}/{tag}/submission.csv",
    )
    kw.update(over)
    return kw


def write_data(root: str, size: int, vit: str) -> dict:
    """CSVs, decode caches and one timm-keyed file with ConvNeXt-atto's
    initial weights (layer scale 0.5) and ``vit``'s."""
    rng = np.random.default_rng(size)
    labels = np.concatenate([np.arange(NUM_CLASSES),
                             rng.integers(0, NUM_CLASSES, N_TRAIN - NUM_CLASSES)])
    images = {"train": rng.integers(0, 256, (N_TRAIN, size, size, 3), dtype=np.uint8),
              "test": rng.integers(0, 256, (N_TEST, size, size, 3), dtype=np.uint8)}
    with open(f"{root}/train.csv", "w") as f:
        f.write("id,target\n" + "".join(f"{i:03d},{v}\n" for i, v in enumerate(labels)))
    with open(f"{root}/test.csv", "w") as f:
        f.write("id,predict\n" + "".join(f"t{i}.x,0\n" for i in range(N_TEST)))
    for split in ("train", "test"):
        ids = Manifest.from_csv(f"{root}/{split}.csv", is_test=split == "test").ids
        save_decode_cache(f"{root}/{split}", ids, images[split], f"{root}/cache")
    sd = {}
    for i, name in enumerate(("convnext_atto", vit)):
        jcfg = JaxConfig(**settings(root, "init", size, model_name=name)).validate()
        params = jax.tree.map(np.asarray, jax.jit(jax_create_model(jcfg).init)(
            jax.random.key(3 + i))["params"])
        if name == "convnext_atto":
            for sub in params.values():
                if "gamma" in sub:
                    sub["gamma"] = np.full_like(sub["gamma"], 0.5)
            sd.update(export_convnext(params, *CONVNEXT_CONFIGS[name]))
        else:
            sd.update({k: v.numpy() for k, v in state_dict_from_jax(params).items()})
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
               f"{root}/init.pt")
    return {"labels": labels, "images": images}


@pytest.fixture(scope="module")
def micro_vits():
    """Tiny ViT entries in both packages' ``VIT_CONFIGS`` for the module."""
    with pytest.MonkeyPatch.context() as mp:
        for name, c in MICRO_VITS.items():
            mp.setitem(jax_vit_module.VIT_CONFIGS, name, c)
            mp.setitem(port_vit_module.VIT_CONFIGS, name, c)
        yield


def jax_loader(images, jcfg):
    manifest = JaxManifest.from_csv(jcfg.test_csv, is_test=True)
    return JaxLoader(JaxArraySource(images), manifest, batch_size=16,
                     sampler=JaxSequential(N_TEST), pad_last=True)


@pytest.fixture(scope="module")
def ens(tmp_path_factory, micro_vits):
    """The port's ``cli train`` on V2's three kinds of member (its
    ``train_ensemble`` result recorded), ``cli predict`` of each member;
    JAX's ``train_ensemble`` and ``predict_ensemble`` of each member on the
    same data and initial weights."""
    root = str(tmp_path_factory.mktemp("ensemble"))
    data = write_data(root, 32, "vit_micro_patch8")
    kw = settings(root, "port", 32)
    seen = {}
    real = kfold.train_ensemble

    def recorded(*args, **kwargs):
        seen["out"] = real(*args, **kwargs)
        return seen["out"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kfold, "train_ensemble", recorded)
        cli.main(["train", "--device", "cpu", *overrides(kw)])
    for m in MEMBERS:
        cli.main(["predict", "--device", "cpu", "--folds", "1,2", *overrides(kw),
                  f"model_name={m}", f"model_save_path={kw['model_save_path']}/{m}",
                  "ensemble_models=[]", "ensemble_weights=[]",
                  f"submission_path={root}/port/predict_{m}.csv"])
    with open(f"{kw['output_dir']}/train.log") as f:
        log = f.read()

    jkw = settings(root, "jax", 32)
    jcfg = JaxConfig(**jkw).validate()
    manifest = JaxManifest.from_csv(jcfg.train_csv, num_classes=NUM_CLASSES)
    results, weights = jax_train_ensemble(jcfg, manifest=manifest,
                                          source=JaxArraySource(data["images"]["train"]))
    loader = jax_loader(data["images"]["test"], jcfg)
    member_probs = {}
    for m in MEMBERS:
        mine = [r for r in results if r.bundle.name == m]
        ids, _, member_probs[m] = jax_predict([r.bundle for r in mine],
                                              [r.best_variables for r in mine], loader, jcfg)
    return {"root": root, "kw": kw, "jkw": jkw, "port": seen["out"], "log": log,
            "jax": results, "jax_weights": weights, "jax_ids": ids,
            "member_probs": member_probs}


def decided(probs: np.ndarray, margin: float = 1e-4) -> np.ndarray:
    top2 = np.sort(probs, axis=1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > margin


def test_members_and_weights_match_jax(ens):
    results, weights = ens["port"]
    assert [(r.bundle.name, r.fold) for r in results] == \
        [(r.bundle.name, r.fold) for r in ens["jax"]] == \
        [(m, k) for m in MEMBERS for k in range(1, FOLDS + 1)]
    assert weights == ens["jax_weights"] == [w / FOLDS for w in WEIGHTS for _ in range(FOLDS)]
    for m, w in zip(MEMBERS, WEIGHTS):
        assert f"ensemble member: {m} (weight {w:.2f})" in ens["log"]
    assert "failed; continuing" not in ens["log"]


def test_member_histories_and_checkpoints_match_jax(ens):
    """Each member's folds under ``<models>/<member>`` and
    ``<out>/<member>``: the histories, and the best weights on disk."""
    results, _ = ens["port"]
    for mine, theirs in zip(results, ens["jax"]):
        m, k = mine.bundle.name, mine.fold
        for a, b in zip(mine.history, theirs.history, strict=True):
            for key in ("train_loss", "val_loss"):
                assert a[key] == pytest.approx(b[key], rel=REL), (m, k, key)
            assert a["val_acc"] == b["val_acc"]
        saved, meta = ckpt.load_best(f"{ens['kw']['model_save_path']}/{m}", k)
        jmeta = jax_ckpt.load_metadata(
            jax_ckpt.best_path(f"{ens['jkw']['model_save_path']}/{m}", k))
        assert meta["val_acc"] == jmeta["val_acc"]
        ref = state_dict_from_jax(theirs.best_variables["params"])
        assert set(saved) == set(ref)
        for key, v in ref.items():
            d = (saved[key] - v).abs()
            if key.endswith("attn.qkv.bias"):   # q and v only (docstring)
                n = d.numel() // 3
                d = torch.cat([d[:n], d[2 * n:]])
            assert float(d.max()) <= WEIGHT_LR_TOL * ens["kw"]["lr"], (m, k, key)
        with open(f"{ens['kw']['output_dir']}/{m}/metrics.jsonl") as f:
            assert {json.loads(line)["fold"] for line in f} == {1, 2}


def test_submission_is_the_weighted_ensemble(ens):
    """The train submission is the argmax of 0.4 / 0.3 / 0.3 times the
    members' probabilities (JAX's ``predict_ensemble`` of each member's
    folds: JAX's weighted ensemble, whose per-result weights sum to 1),
    wherever the top two are more than 1e-4 apart."""
    rows = read_csv(ens["kw"]["submission_path"])
    assert rows[0] == ["id", "target"] and [r[0] for r in rows[1:]] == ens["jax_ids"]
    ours = np.array([int(r[1]) for r in rows[1:]])
    mixed = sum(w * ens["member_probs"][m] for m, w in zip(MEMBERS, WEIGHTS))
    ok = decided(mixed)
    assert ok.sum() >= N_TEST // 2
    np.testing.assert_array_equal(ours[ok], mixed.argmax(axis=1)[ok])


@pytest.mark.parametrize("member", MEMBERS)
def test_cli_predict_scores_each_member(ens, member):
    """``cli predict model_name=<m> model_save_path=<models>/<m>
    ensemble_models=[]`` writes every test id, with JAX's per-member
    prediction wherever it is decided."""
    rows = read_csv(f"{ens['root']}/port/predict_{member}.csv")
    assert rows[0] == ["id", "predict"] and [r[0] for r in rows[1:]] == ens["jax_ids"]
    probs = ens["member_probs"][member]
    ok = decided(probs)
    assert ok.sum() >= N_TEST // 2
    ours = np.array([int(r[1]) for r in rows[1:]])
    np.testing.assert_array_equal(ours[ok], probs.argmax(axis=1)[ok])


def test_failing_member_matches_jax(tmp_path, micro_vits, caplog):
    """At 28x28 a patch-8 ViT fails every fold in both packages (ValueError
    in the port, TypeError in JAX), each logged and skipped; the patch-4
    ViT beside it trains the same folds, with the same weights."""
    root = str(tmp_path)
    data = write_data(root, 28, "vit_micro_patch4")
    members, ws = ("vit_micro_patch8", "vit_micro_patch4"), (0.6, 0.4)
    kw = settings(root, "port", 28, model_name=members[0], ensemble_models=members,
                  ensemble_weights=ws)
    jkw = settings(root, "jax", 28, model_name=members[0], ensemble_models=members,
                   ensemble_weights=ws)
    logger = logging.getLogger("ic_tpu_torch")   # propagates nowhere once set up
    logger.addHandler(caplog.handler)
    try:
        results, weights = kfold.train_ensemble(Config(**kw).validate(), device="cpu")
    finally:
        logger.removeHandler(caplog.handler)
    failed = [r for r in caplog.records if "failed; continuing" in r.getMessage()]
    assert len(failed) == FOLDS
    assert all(r.exc_info[0] is ValueError and "28x28" in str(r.exc_info[1]) for r in failed)
    jcfg = JaxConfig(**jkw).validate()
    manifest = JaxManifest.from_csv(jcfg.train_csv, num_classes=NUM_CLASSES)
    jresults, jweights = jax_train_ensemble(jcfg, manifest=manifest,
                                            source=JaxArraySource(data["images"]["train"]))
    assert [(r.bundle.name, r.fold) for r in results] == \
        [(r.bundle.name, r.fold) for r in jresults] == \
        [("vit_micro_patch4", k) for k in range(1, FOLDS + 1)]
    assert weights == jweights == [0.4 / FOLDS] * FOLDS
    for mine, theirs in zip(results, jresults):
        assert mine.best_val_acc == theirs.best_val_acc
        for a, b in zip(mine.history, theirs.history, strict=True):
            assert a["val_loss"] == pytest.approx(b["val_loss"], rel=REL)
    assert not os.path.exists(f"{kw['model_save_path']}/vit_micro_patch8/best_model_fold1.pt")


def test_mismatched_weights_raise_as_jax(tmp_path):
    kw = settings(str(tmp_path), "x", 32, ensemble_weights=(0.5, 0.5))
    with pytest.raises(ValueError, match="ensemble_weights"):
        kfold.train_ensemble(Config(**kw).validate(), device="cpu")
    with pytest.raises(ValueError, match="ensemble_weights"):
        jax_train_ensemble(JaxConfig(**kw).validate())
