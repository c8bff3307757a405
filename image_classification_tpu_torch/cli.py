"""Command-line entry point of the PyTorch port:

    python -m image_classification_tpu_torch.cli train [--config cfg.json] \
        [--resume] [--device cuda] [key=value ...]
    python -m image_classification_tpu_torch.cli predict [--config cfg.json] \
        [--folds 1,2] [--metric acc|loss] [--device cuda] [key=value ...]

``train`` mirrors the JAX package's ``cli train``: stratified K-fold
training (``train/kfold.py``), which writes per fold the best-acc and
best-loss weights (``best_model_fold{k}.pt``, ``best_loss_model_fold{k}.pt``,
each with a JSON of its metadata) to ``model_save_path`` and
``train_state_fold{k}.pt`` plus ``metrics.jsonl`` and ``train.log`` to
``output_dir``; then the TTA-ensemble of the folds' best weights on the test
set, written as ``id,target`` to ``submission_path``. ``--resume`` continues
each fold from its ``train_state_fold{k}.pt``.

``predict`` mirrors the JAX package's ``cli predict``: it loads one state
dict per fold from ``{model_save_path}/best_model_fold{k}.pt`` (or
``best_loss_model_fold{k}.pt`` with ``--metric loss``), runs the
TTA-ensemble over the test set and writes ``id,predict`` to
``submission_path``.

Images come from the decoded-image cache under ``cache_dir`` (see
``data/source.py:load_decode_cache``). The device defaults to ``cuda``;
``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import torch

from image_classification_tpu_torch.core.config import load_config
from image_classification_tpu_torch.utils.checkpoint import best_path as checkpoint_path


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
    from image_classification_tpu_torch.train.kfold import train_ensemble, train_k_fold
    from image_classification_tpu_torch.utils.logging import setup_logging

    cfg = load_config(args.config, args.overrides)
    logger = setup_logging(os.path.join(cfg.output_dir, "train.log"))
    os.makedirs(cfg.model_save_path, exist_ok=True)
    os.makedirs(cfg.output_dir, exist_ok=True)
    device = torch.device(args.device)
    logger.info("device: %s%s", device, f" ({torch.cuda.get_device_name(device)})"
                if device.type == "cuda" else "")
    if cfg.ensemble_models:
        train_ensemble(cfg)
    results = train_k_fold(cfg, resume=args.resume, device=device)
    if not results:
        logger.error("training produced no models")
        sys.exit(1)
    for r in results:
        logger.info("%s fold %d best val acc: %.4f", r.bundle.name, r.fold,
                    r.best_val_acc)

    # test-set ensemble of the folds' best weights -> submission
    models = []
    for r in results:
        r.bundle.module.load_state_dict(r.best_variables, strict=True)
        models.append(r.bundle.module)
    ids, preds, _ = predict_ensemble(models, _test_loader(cfg, device), cfg)
    write_submission(ids, preds, cfg.submission_path, column="target")


def cmd_predict(args) -> None:
    from image_classification_tpu_torch.infer import predict_ensemble, write_submission
    from image_classification_tpu_torch.models.factory import create_model

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = load_config(args.config, args.overrides)
    if cfg.norm_stats == "dataset":
        raise NotImplementedError("norm_stats=dataset is not ported yet")
    device = torch.device(args.device)
    models = []
    for fold in args.folds or [1]:
        model = create_model(cfg).module
        sd = torch.load(checkpoint_path(cfg.model_save_path, fold, args.metric),
                        map_location="cpu", weights_only=True)
        model.load_state_dict(sd, strict=True)
        models.append(model.to(device))
    ids, preds, _ = predict_ensemble(models, _test_loader(cfg, device), cfg)
    write_submission(ids, preds, cfg.submission_path, column="predict")


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
    sp.add_argument("--metric", choices=("acc", "loss"), default="acc",
                    help="checkpoint tier: best-val-acc or best-val-loss")
    sp.add_argument("--device", default="cuda", help="torch device")
    sp.add_argument("overrides", nargs="*", help="key=value overrides")
    sp.set_defaults(fn=cmd_predict)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
