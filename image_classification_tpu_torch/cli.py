"""Command-line entry point of the PyTorch port:

    python -m image_classification_tpu_torch.cli predict [--config cfg.json] \
        [--folds 1,2] [--metric acc|loss] [--device cuda] [key=value ...]

``predict`` mirrors the JAX package's ``cli predict``: it loads one state
dict per fold from ``{model_save_path}/best_model_fold{k}.pt`` (or
``best_loss_model_fold{k}.pt`` with ``--metric loss``), runs the
TTA-ensemble over the test set and writes ``id,predict`` to
``submission_path``. Test images come from the decoded-image cache under
``cache_dir`` (see ``data/source.py:load_decode_cache``). The device defaults
to ``cuda``; ``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from image_classification_tpu_torch.core.config import load_config


def checkpoint_path(save_dir: str, fold: int, metric: str = "acc") -> str:
    prefix = "best_model" if metric == "acc" else "best_loss_model"
    return os.path.join(save_dir, f"{prefix}_fold{fold}.pt")


def cmd_predict(args) -> None:
    from image_classification_tpu_torch.data import (
        DataLoader,
        Manifest,
        SequentialSampler,
        load_decode_cache,
    )
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
    manifest = Manifest.from_csv(cfg.test_csv, is_test=True)
    source = load_decode_cache(cfg.test_dir, manifest.ids, tuple(cfg.native_size),
                               cfg.cache_dir)
    loader = DataLoader(source, manifest,
                        batch_size=cfg.batch_size * cfg.infer_batch_multiplier,
                        sampler=SequentialSampler(len(manifest)), pad_last=True,
                        device=device)
    ids, preds, _ = predict_ensemble(models, loader, cfg)
    write_submission(ids, preds, cfg.submission_path, column="predict")


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(prog="image_classification_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
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
