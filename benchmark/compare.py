"""The numbers that decide ``correct``, each against the limit of its cell
(``benchmark/limits/<workload>.json``).

Training, from the program's first three steps and the reference's:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the first step's clipped gradient as AdamW got it (the
  program's worked out from its first moment after one step, ``mu /
  (1 - b1)``), by the worst leaf: the gap between the program's norm of the
  leaf and the reference's, over the larger of the reference's norm of that
  leaf and of the median leaf;
- ``change_gap`` and ``ema_change_gap``: the same of the parameters' and
  the EMA's change over the three steps, over the leaves whose reference
  gradient is at least a thousandth of the median leaf's (the others move
  under Adam by round-off alone).

Prediction: ``logprob_gap``, the widest gap between the program's and the
reference's log-probability of any class of a sampled test image."""

from __future__ import annotations

import statistics

import torch

KEEP_SHARE = 1e-3


def leaf_norms(tensors: dict) -> dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def worst_gap(prog: dict[str, float], ref: dict[str, float], names=None) -> tuple[float, str]:
    names = list(ref) if names is None else list(names)
    med = statistics.median(ref[n] for n in names)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` hold ``loss`` (a list), ``grad1``, ``change``
    and ``ema_change`` (tensors by name)."""
    g_ref = leaf_norms(ref["grad1"])
    med = statistics.median(g_ref.values())
    keep = [n for n, v in g_ref.items() if v >= KEEP_SHARE * med]
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    out = {"loss_gap": (loss, "steps 1-3")}
    out["grad_gap"] = worst_gap(leaf_norms(prog["grad1"]), g_ref)
    out["change_gap"] = worst_gap(leaf_norms(prog["change"]), leaf_norms(ref["change"]), keep)
    out["ema_change_gap"] = worst_gap(leaf_norms(prog["ema_change"]),
                                      leaf_norms(ref["ema_change"]), keep)
    return out


def predict_numbers(prog_probs: torch.Tensor, ref_probs: torch.Tensor) -> dict:
    gap = (torch.log(prog_probs.double().clamp(min=1e-30))
           - torch.log(ref_probs.double().clamp(min=1e-30))).abs()
    row = int(gap.amax(dim=1).argmax())
    return {"logprob_gap": (float(gap.max()), f"sampled row {row}")}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, the numbers beside their limits)."""
    checks, ok = {}, True
    for name, (value, where) in numbers.items():
        limit = limits[name]
        ok = ok and value <= limit
        checks[name] = {"value": value, "limit": limit, "at": where}
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"limits without a number: {sorted(missing)}")
    return ok, checks
