"""Command-line entry point of the PyTorch port:

    python -m image_classification_tpu_torch.cli train [--config cfg.json] \
        [--resume] [--device cuda] [key=value ...]
    python -m image_classification_tpu_torch.cli predict [--config cfg.json] \
        [--folds 1,2] [--best-fold] [--metric acc|loss] [--device cuda] \
        [key=value ...]
    python -m image_classification_tpu_torch.cli bench [--device cuda]

``train`` mirrors the JAX package's ``cli train``: stratified K-fold
training (``train/kfold.py``), or with ``ensemble_models`` the K-fold per
member (``train_ensemble``, each member under
``{model_save_path}/{name}`` and ``{output_dir}/{name}``), which writes per
fold the best-acc and
best-loss weights (``best_model_fold{k}.pt``, ``best_loss_model_fold{k}.pt``,
each with a JSON of its metadata) to ``model_save_path`` and
``train_state_fold{k}.pt`` plus ``metrics.jsonl`` and ``train.log`` to
``output_dir``; then the TTA-ensemble of the folds' best weights on the test
set, each fold weighted by its member's weight split over the member's
folds, written as ``id,target`` to ``submission_path``. ``--resume`` continues
each fold from its ``train_state_fold{k}.pt``.

``predict`` mirrors the JAX package's ``cli predict``: it loads one state
dict per fold from ``{model_save_path}/best_model_fold{k}.pt`` (or
``best_loss_model_fold{k}.pt`` with ``--metric loss``), runs the
TTA-ensemble over the test set and writes ``id,predict`` to
``submission_path``. ``--best-fold`` keeps only the fold of ``--folds``
whose stored metric is best (``utils/checkpoint.py:select_best_fold``).
As in the JAX package it loads ``model_name`` from ``model_save_path``, so
an ensemble member is scored alone with ``model_name=<name>
model_save_path=<models>/<name> ensemble_models=[]``.

``train`` runs on N GPUs under torchrun, one process each
(``parallel/distributed.py``):

    torchrun --nproc_per_node=N -m image_classification_tpu_torch.cli train ...

The ranks form the mesh ``(fold, data, model)`` of ``mesh_data``,
``mesh_model`` and, with ``fold_parallel=true``, ``num_folds`` folds side
by side (``train/foldpar.py``); each rank trains on ``cuda:LOCAL_RANK``
(or the CPU with ``--device cpu``, over gloo), the primary ranks write the
files, and rank 0 predicts the submission. A caller that has initialised
the process group itself (gloo, for two ranks on one card) keeps it.

With ``norm_stats=dataset`` both normalize with the train set's channel
stats (``data/stats.py``): ``train`` resolves them once and saves
``{model_save_path}/norm_stats.json``, and its submission uses them too;
``predict`` reads that file, or else computes them from the train set.

Images are the JPEG files under ``train_dir`` and ``test_dir``, decoded
once by ``data/source.py:ImageSource`` into the decode cache under
``cache_dir`` (or in memory with ``use_decode_cache=false``). The device
defaults to ``cuda``; ``--device cpu`` runs the kernels' plain versions.

``bench`` runs ``bench.py:main``, the counterpart of the JAX package's
``cli bench``: V4 train images/s at accumulation 1 and 2, the aug's and the
TTA ensemble's images/s, one JSON line. It takes ``--device`` only (the JAX
parser accepts and then ignores ``--config``, ``--resume``, ``--folds`` and
overrides; here they are refused), and with no CUDA card it raises before
any work.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import torch

from image_classification_tpu_torch.core.config import load_config
from image_classification_tpu_torch.data.stats import (
    NORM_STATS_FILE,
    load_saved_norm_stats,
    resolve_norm_stats,
)
from image_classification_tpu_torch.utils.checkpoint import best_path as checkpoint_path
from image_classification_tpu_torch.utils.checkpoint import select_best_fold


def _test_loader(cfg, device):
    from image_classification_tpu_torch.data import DataLoader, Manifest, SequentialSampler
    from image_classification_tpu_torch.train.kfold import build_source

    manifest = Manifest.from_csv(cfg.test_csv, is_test=True)
    return DataLoader(build_source(cfg, manifest, cfg.test_dir), manifest,
                      batch_size=cfg.batch_size * cfg.infer_batch_multiplier,
                      sampler=SequentialSampler(len(manifest)), pad_last=True,
                      device=device)


def cmd_train(args) -> None:
    from image_classification_tpu_torch.infer import predict_ensemble, write_submission
    from image_classification_tpu_torch.parallel import distributed
    from image_classification_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from image_classification_tpu_torch.parallel.shardings import unshard_model
    from image_classification_tpu_torch.train.kfold import train_ensemble, train_k_fold
    from image_classification_tpu_torch.utils.logging import setup_logging

    cfg = load_config(args.config, args.overrides)
    device = distributed.local_device(args.device)
    distributed.initialize(device)
    primary = distributed.is_primary()
    # each run logs to its own output_dir, also when one process trains twice
    logger = setup_logging(os.path.join(cfg.output_dir, "train.log") if primary else None,
                           force=True)
    os.makedirs(cfg.model_save_path, exist_ok=True)
    os.makedirs(cfg.output_dir, exist_ok=True)
    mesh = build_mesh(MeshSpec(cfg.mesh_data, cfg.mesh_model,
                               fold=cfg.num_folds if cfg.fold_parallel else 1))
    logger.info("device: %s%s, mesh (fold, data, model) %s", device,
                f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda"
                else "", mesh.shape)
    if cfg.ensemble_models:
        results, ens_weights = train_ensemble(cfg, resume=args.resume, device=device,
                                              mesh=mesh)
    else:
        results = train_k_fold(cfg, resume=args.resume, device=device, mesh=mesh)
        ens_weights = None
    distributed.barrier()
    if not primary:
        return
    if not results:
        logger.error("training produced no models")
        sys.exit(1)
    for r in results:
        logger.info("%s fold %d best val acc: %.4f", r.bundle.name, r.fold,
                    r.best_val_acc)

    if cfg.norm_stats == "dataset":
        # the stats the folds trained with (the JAX package's train entry
        # predicts its test set with ImageNet's instead); every ensemble
        # member saved the same ones in its own directory
        stats_dir = os.path.join(cfg.model_save_path, *cfg.ensemble_models[:1])
        cfg = load_saved_norm_stats(cfg, os.path.join(stats_dir, NORM_STATS_FILE))
    # test-set ensemble of the folds' best weights -> submission; each
    # result's module (its member's architecture) takes its own weights
    models = []
    for r in results:
        # a module split over the model axis takes its whole shapes back
        module = unshard_model(r.bundle.module)
        module.load_state_dict(r.best_variables, strict=True)
        models.append(module)
    ids, preds, _ = predict_ensemble(models, _test_loader(cfg, device), cfg,
                                     weights=ens_weights)
    write_submission(ids, preds, cfg.submission_path, column="target")


def cmd_predict(args) -> None:
    from image_classification_tpu_torch.infer import predict_ensemble, write_submission
    from image_classification_tpu_torch.models.factory import create_model

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    logger = logging.getLogger("ic_tpu_torch")
    cfg = load_config(args.config, args.overrides)
    if cfg.norm_stats == "dataset":
        from image_classification_tpu_torch.data import Manifest
        from image_classification_tpu_torch.train.kfold import build_source

        resolved = load_saved_norm_stats(cfg, os.path.join(cfg.model_save_path,
                                                           NORM_STATS_FILE))
        if resolved is None:
            manifest = Manifest.from_csv(cfg.train_csv, num_classes=cfg.num_classes)
            resolved = resolve_norm_stats(cfg, build_source(cfg, manifest, cfg.train_dir))
        cfg = resolved
    device = torch.device(args.device)
    folds = args.folds or [1]
    if args.best_fold:
        best, score = select_best_fold(cfg.model_save_path, folds, args.metric)
        logger.info("best fold by stored val_%s: %d (%.4f)", args.metric, best, score)
        folds = [best]
    models = []
    for fold in folds:
        model = create_model(cfg).module
        sd = torch.load(checkpoint_path(cfg.model_save_path, fold, args.metric),
                        map_location="cpu", weights_only=True)
        model.load_state_dict(sd, strict=True)
        models.append(model.to(device))
    ids, preds, _ = predict_ensemble(models, _test_loader(cfg, device), cfg)
    write_submission(ids, preds, cfg.submission_path, column="predict")


def cmd_bench(args) -> None:
    from image_classification_tpu_torch import bench

    bench.main(args.device)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(prog="image_classification_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    tp = sub.add_parser("train")
    tp.add_argument("--config", default=None, help="JSON config file")
    tp.add_argument("--resume", action="store_true",
                    help="continue each fold from its train_state_fold{k}.pt")
    tp.add_argument("--device", default="cuda", help="torch device")
    tp.add_argument("overrides", nargs="*", help="key=value overrides")
    tp.set_defaults(fn=cmd_train)
    sp = sub.add_parser("predict")
    sp.add_argument("--config", default=None, help="JSON config file")
    sp.add_argument("--folds", type=lambda s: [int(x) for x in s.split(",")],
                    default=None, help="fold checkpoints to ensemble, e.g. 1,2,3")
    sp.add_argument("--best-fold", action="store_true",
                    help="use only the fold with the best stored metric")
    sp.add_argument("--metric", choices=("acc", "loss"), default="acc",
                    help="checkpoint tier: best-val-acc or best-val-loss")
    sp.add_argument("--device", default="cuda", help="torch device")
    sp.add_argument("overrides", nargs="*", help="key=value overrides")
    sp.set_defaults(fn=cmd_predict)
    bp = sub.add_parser("bench")
    bp.add_argument("--device", default="cuda", help="torch device")
    bp.set_defaults(fn=cmd_bench)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
