"""Ensemble inference and submission writing, port of
``image_classification_tpu/infer/predict.py``.

Every fold model predicts each batch (softmax averaged over the TTA views);
the ensemble is the weighted sum of the models' probabilities, argmaxed and
written as ``id,predict`` or ``id,target``.
"""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np
import torch

from image_classification_tpu_torch.data.manifest import write_csv
from image_classification_tpu_torch.infer.tta import get_tta
from image_classification_tpu_torch.train.step import (
    make_eval_views,
    make_forward_views,
    tta_num_views,
)
from image_classification_tpu_torch.utils.profiler import span

logger = logging.getLogger("ic_tpu_torch")


def _cast_inference_params(model: torch.nn.Module, cfg) -> torch.nn.Module:
    """Cast the model's f32 parameters of two or more dims to bf16, in place
    (the f32 copies are not kept: prediction needs none), and return it.

    Only with ``compute_dtype=bfloat16`` and ``infer_cast_params``. The
    forward casts every weight to bf16 at use anyway, so the math is
    unchanged; the cast halves the weight bytes each forward reads. Kept in
    f32: 1-D vectors (LN and BN scale and bias, biases, gamma), the
    BatchNorm buffers (not parameters), and ConvNeXt's classifier heads
    ``head.fc`` and ``aux_head*``, which compute in f32. EfficientNet's
    ``classifier`` weight and ViT's ``head.weight`` are cast, as the JAX
    rule (which spares ``head_fc`` and ``aux_head*`` only) casts their
    kernels; they still compute in f32, on the bf16-rounded weight. ViT's
    ``cls_token`` and ``pos_embed`` (3-D) are cast, as in JAX."""
    if cfg.compute_dtype != "bfloat16" or not cfg.infer_cast_params:
        return model
    for name, p in model.named_parameters():
        if "head.fc" in name or "aux_head" in name:
            continue
        if p.dtype == torch.float32 and p.dim() >= 2:
            p.data = p.data.to(torch.bfloat16)
    return model


def predict_ensemble(
    models: Sequence[torch.nn.Module],
    test_loader,
    cfg,
    weights: Sequence[float] | None = None,
) -> tuple[list[str], np.ndarray, np.ndarray]:
    """Returns (image ids, predictions, mean probabilities). The models must
    already sit on the loader's device; their parameters are cast in place
    (see :func:`_cast_inference_params`). While a profiler records, the call
    is the span ``predict_ensemble``, and each batch ``b`` the spans
    ``predict.views``, ``predict.forward`` and ``predict.pull`` with step
    ``b`` (``utils/profiler.py:span``)."""
    if not models:
        logger.error("no models available for prediction")
        return [], np.array([]), np.array([])
    with span("predict_ensemble"), torch.no_grad():
        models = [_cast_inference_params(m.eval(), cfg) for m in models]
        tta = get_tta(cfg)
        n_views = tta_num_views(cfg, tta)
        # The views are built once per batch and shared by every fold model;
        # each model runs one forward over all views stacked along the batch.
        views_fn = make_eval_views(cfg, tta)
        if weights is None:
            w = np.ones(len(models)) / len(models)
        else:
            w = np.asarray(weights, dtype=np.float64)
            w = w / w.sum()
        runs = [(float(wi), make_forward_views(m, n_views)) for wi, m in zip(w, models)]
        ids: list[str] = []
        all_probs: list[np.ndarray] = []
        for b, (batch, batch_ids) in enumerate(zip(test_loader, test_loader.batch_ids())):
            with span("predict.views", step=b, rows=batch["image"].shape[0]):
                xb = views_fn(batch["image"])
            with span("predict.forward", step=b):
                total = None
                for wi, fwd in runs:
                    p = fwd(xb) * wi
                    total = p if total is None else total + p
            with span("predict.pull", step=b):
                probs = total.cpu().numpy()  # one device->host pull per batch
                all_probs.append(probs[batch["mask"].cpu().numpy()])
            ids.extend(str(i) for i in batch_ids)
    probs = np.concatenate(all_probs) if all_probs else np.zeros((0, cfg.num_classes))
    return ids, probs.argmax(axis=1), probs


def write_submission(ids: Sequence[str], preds: np.ndarray, path: str,
                     column: str = "predict") -> None:
    """``id,<column>`` CSV, byte-identical to pandas'
    ``DataFrame.to_csv(index=False)`` (minimal quoting, ``os.linesep``)."""
    write_csv(path, {"id": list(ids), column: np.asarray(preds, dtype=int).tolist()})
    logger.info("wrote %d predictions -> %s", len(ids), path)
