"""The port's fold-parallel ``cli train`` on 2 gloo ranks (one fold each)
against the JAX package's ``train_k_fold_parallel`` on a (fold=2, data=1,
model=1) mesh of 2 virtual CPU devices, at ``convnext_atto`` and 32 px in
f32 with the aug off (``test_torch_loop.py``'s settings; initial weights
made by the port, loaded by both). The folds are unequal (a class of one image, oversampled to 4 in
the one train split that holds it: 4 steps an epoch against 3) and the
patience is 1, so JAX's two departures from the sequential loop show: every
fold runs the folds' least steps an epoch, and a fold past its patience
trains on until both are. With class-weighted CE (each fold's own counts)
and SWA from epoch 2 (which the early stop leaves with 2 snapshots). Then resume: 2 epochs, then ``--resume`` to 3 with
the plateau schedule, against 3 straight, to the bit.

Tolerances: ``test_torch_loop.py``'s ``REL`` = 1e-4 for losses and weights
(f32 on both sides, sums in another order); validation accuracies and step
counts exactly, train accuracies to 1e-6 (JAX's stacked loop averages them
in f32).
"""

import json
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
from image_classification_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from image_classification_tpu.parallel.mesh import build_mesh as jax_build_mesh
from image_classification_tpu.train.kfold import train_k_fold as jax_train_k_fold
from image_classification_tpu.utils import checkpoint as jax_ckpt
from image_classification_tpu_torch import cli
from image_classification_tpu_torch.core.config import Config
from image_classification_tpu_torch.models.factory import create_model
from image_classification_tpu_torch.data import Manifest, load_decode_cache, save_decode_cache
from image_classification_tpu_torch.models.pretrained import convnext_state_dict_from_jax
from image_classification_tpu_torch.train.foldpar import FOLDPAR_DIR, SIDECAR
from image_classification_tpu_torch.utils import checkpoint as ckpt

from test_torch_loop import REL, overrides, read_csv, read_metrics, settings
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse, module scope)
from torch_spawn import cli_worker, run_ranks

COUNTS = (14, 14, 12, 10, 5, 1)
N_TEST = 12
EPOCHS = 4
DATA_SEED = 12   # a seed whose folds stop at different epochs


def write_folds_data(root: str, seed: int = DATA_SEED) -> np.ndarray:
    """CSVs and decode caches of a train set of ``COUNTS`` images per class
    and of ``N_TEST`` test images, and the initial weights: the port's
    flax-style init of ``convnext_atto`` with the layer scale raised to 0.5,
    so that every block acts (both packages load it as ``pretrained_path``)."""
    rng = np.random.default_rng(seed)
    labels = rng.permutation(np.concatenate([np.full(c, i) for i, c in enumerate(COUNTS)]))
    images = {"train": rng.integers(0, 256, (len(labels), 32, 32, 3), dtype=np.uint8),
              "test": rng.integers(0, 256, (N_TEST, 32, 32, 3), dtype=np.uint8)}
    with open(f"{root}/train.csv", "w") as f:
        f.write("id,target\n" + "".join(f"f{i:03d},{v}\n" for i, v in enumerate(labels)))
    with open(f"{root}/test.csv", "w") as f:
        f.write("id,predict\n" + "".join(f"t{i}.x,0\n" for i in range(N_TEST)))
    for split in ("train", "test"):
        ids = Manifest.from_csv(f"{root}/{split}.csv", is_test=split == "test").ids
        save_decode_cache(f"{root}/{split}", ids, images[split], f"{root}/cache")
    model = create_model(Config(**settings(root, "init")).validate(),
                         generator=torch.Generator().manual_seed(3)).module
    sd = {k: torch.full_like(v, 0.5) if k.endswith(".gamma") else v
          for k, v in model.state_dict().items()}
    torch.save(sd, f"{root}/init.pt")
    return images["train"]


def foldpar_settings(root, tag, **over):
    kw = dict(fold_parallel=True, oversample_min_samples=4, use_weighted_loss=True,
              use_swa=True, swa_start_epoch=2, epochs=EPOCHS)
    return settings(root, tag, **{**kw, **over})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("foldpar"))
    images = write_folds_data(root)
    kw = foldpar_settings(root, "port")
    run_ranks(cli_worker, 2, f"{root}/spawn", ["train", "--device", "cpu", *overrides(kw)])
    cli.main(["predict", "--device", "cpu", "--folds", "1,2", *overrides(kw),
              f"submission_path={root}/port/predict.csv"])

    jkw = foldpar_settings(root, "jax")
    jcfg = JaxConfig(**jkw).validate()
    manifest = JaxManifest.from_csv(jcfg.train_csv, num_classes=6)
    mesh = jax_build_mesh(JaxMeshSpec(data=1, model=1, fold=2), jax.devices()[:2])
    results = jax_train_k_fold(jcfg, manifest=manifest, source=JaxArraySource(images),
                               mesh=mesh)
    return {"root": root, "kw": kw, "jkw": jkw, "jax": results, "jcfg": jcfg}


def test_histories_match_jax_with_least_steps_and_joint_stop(runs):
    ours = read_metrics(f"{runs['kw']['output_dir']}/metrics.jsonl")
    assert len(ours) == sum(len(r.history) for r in runs["jax"])
    for r in runs["jax"]:
        mine = [m for m in ours if m["fold"] == r.fold]
        assert [m["epoch"] for m in mine] == [h["epoch"] for h in r.history]
        for m, h in zip(mine, r.history):
            for key in ("train_loss", "val_loss"):
                assert m[key] == pytest.approx(h[key], rel=REL), (r.fold, m["epoch"], key)
            assert m["val_acc"] == h["val_acc"]
            # the same counts (JAX's foldpar averages the steps' accuracies in f32)
            assert m["train_acc"] == pytest.approx(h["train_acc"], rel=1e-6)
            # the folds' least steps: 3, where fold 1's loader has 4 batches
            assert m["steps"] == h["steps"] == 3
    # patience=1: each fold's count of epochs without a better val acc
    runs_out = {}
    for r in runs["jax"]:
        best, bad, stopped = -1.0, 0, None
        for h in r.history:
            bad = 0 if h["val_acc"] > best else bad + 1
            best = max(best, h["val_acc"])
            if bad >= 1 and stopped is None:
                stopped = h["epoch"]
        runs_out[r.fold] = stopped
    last = max(h["epoch"] for r in runs["jax"] for h in r.history)
    # a fold past its patience trained on until the other was past its own
    assert any(s is not None and s < last for s in runs_out.values()), runs_out
    assert last < EPOCHS - 1 and all(len(r.history) == last + 1 for r in runs["jax"])


@pytest.mark.parametrize("metric", ["acc", "loss"])
def test_best_checkpoints_match_jax(runs, metric):
    for r in runs["jax"]:
        mine, meta = ckpt.load_best(runs["kw"]["model_save_path"], r.fold, metric)
        path = jax_ckpt.best_path(runs["jkw"]["model_save_path"], r.fold, metric)
        theirs = jax_ckpt.load_metadata(path)
        assert meta["val_acc"] == theirs["val_acc"]
        assert meta["val_loss"] == pytest.approx(theirs["val_loss"], rel=REL)
        template = {"params": r.best_variables["params"]}
        ref = convnext_state_dict_from_jax(jax_ckpt.load_best(
            runs["jkw"]["model_save_path"], r.fold, template, metric)[0]["params"])
        assert set(mine) == set(ref)
        for k, v in ref.items():
            scale = max(float(v.abs().max()), 1e-3)
            assert float((mine[k] - v).abs().max()) <= REL * scale, k


def test_submission_matches_jax_and_cli_predict(runs):
    root = runs["root"]
    jcfg = runs["jcfg"]
    test_manifest = JaxManifest.from_csv(jcfg.test_csv, is_test=True)
    images = load_decode_cache(f"{root}/test", test_manifest.ids, (32, 32),
                               f"{root}/cache").images
    loader = JaxLoader(JaxArraySource(np.asarray(images)), test_manifest, batch_size=16,
                       sampler=JaxSequential(N_TEST), pad_last=True)
    ids, preds, probs = jax_predict([r.bundle for r in runs["jax"]],
                                    [r.best_variables for r in runs["jax"]], loader, jcfg)
    rows = read_csv(runs["kw"]["submission_path"])
    assert [r[0] for r in rows[1:]] == ids
    top2 = np.sort(probs, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 1e-4
    ours = np.array([int(r[1]) for r in rows[1:]])
    assert decided.sum() >= N_TEST // 2
    np.testing.assert_array_equal(ours[decided], preds[decided])
    assert read_csv(f"{root}/port/predict.csv")[1:] == rows[1:]


def test_each_file_written_once(runs):
    out = runs["kw"]["output_dir"]
    state_dir = os.path.join(out, FOLDPAR_DIR)
    assert sorted(os.listdir(state_dir)) == [SIDECAR, "train_state_fold1.pt",
                                             "train_state_fold2.pt"]
    with open(os.path.join(state_dir, SIDECAR)) as f:
        side = json.load(f)
    assert len(side["folds"]) == 2
    for fold in (1, 2):
        saved = torch.load(ckpt.resume_path(state_dir, fold), weights_only=True)
        assert saved["epoch"] == side["epoch"] and saved["host_state"] == side["folds"][fold - 1]
    with open(f"{out}/train.log") as f:
        log = f.read()
    assert "mesh (fold, data, model) (2, 1, 1)" in log and "failed" not in log


def test_resume_continues_exactly(runs):
    """1 epoch, then ``--resume`` to 2, against 2 straight, with the plateau
    schedule (its LR and internals ride the sidecar): the second epoch's
    records, each fold's state and the sidecar to the bit."""
    root = runs["root"]

    def kw(tag: str, epochs: int) -> dict:
        return foldpar_settings(root, tag, epochs=epochs, patience=10, schedule="plateau",
                                plateau_patience=0, plateau_factor=0.5, use_swa=False)

    straight, first, resumed = kw("straight", 2), kw("resumed", 1), kw("resumed", 2)
    # one pair of processes runs the three in turn
    run_ranks(cli_worker, 2, f"{root}/spawn_resume",
              ["train", "--device", "cpu", *overrides(straight)],
              ["train", "--device", "cpu", *overrides(first)],
              ["train", "--device", "cpu", "--resume", *overrides(resumed)])
    a = read_metrics(f"{straight['output_dir']}/metrics.jsonl")
    b = read_metrics(f"{resumed['output_dir']}/metrics.jsonl")
    assert [(m["fold"], m["epoch"]) for m in b] == [(1, 0), (2, 0), (1, 1), (2, 1)]
    for x, y in zip(a, b):
        assert {k: x[k] for k in ("train_loss", "val_loss", "val_acc")} == \
            {k: y[k] for k in ("train_loss", "val_loss", "val_acc")}
    dirs = [os.path.join(kw["output_dir"], FOLDPAR_DIR) for kw in (straight, resumed)]
    sides = []
    for d in dirs:
        with open(os.path.join(d, SIDECAR)) as f:
            sides.append(json.load(f))
    assert sides[0] == sides[1] and sides[0]["epoch"] == 1
    assert sides[0]["folds"][0]["plateau"]["lr"] < 2e-3
    for fold in (1, 2):
        x, y = (torch.load(ckpt.resume_path(d, fold), weights_only=True) for d in dirs)
        assert (x["count"], x["step"], x["epoch"]) == (y["count"], y["step"], y["epoch"])
        for part in ("model", "ema", "mu", "nu"):
            assert all(torch.equal(x[part][k], y[part][k]) for k in x[part]), (fold, part)
