"""The comparison catches the faults the cells can have, run through the
rest of a tiny CPU run with the timed path broken underneath: a step that
returns its state unchanged, half of each batch left out (the mean taken
over the rest), an answer altered where it is produced; and the control,
the reference in fp8 put in the program's place. (No cell has an exchange
between chips inside its step: the fold-parallel ranks train apart.)"""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark import compare
from benchmark.check import half_batch
from benchmark.run import run_cell
from benchmark.spec import Spec
from benchmark.tests.conftest import TINY_LIMITS, TINY_TRAFFIC, tiny_doc

SEED = 77


def unchanged_state(step):
    """A fault: the step runs, then its state is put back as it was."""
    def faulty(state, batch, generator=None, draws=None):
        saved = [[t.detach().clone() for t in ts]
                 for ts in (state.params(), state.mu, state.nu, state.ema)]
        count = state.count
        state, metrics = step(state, batch, generator=generator, draws=draws)
        with torch.no_grad():
            for ts, old in zip((state.params(), state.mu, state.nu, state.ema), saved):
                for t, o in zip(ts, old):
                    t.copy_(o)
        state.count = count
        return state, metrics
    return faulty


def altered_answers(predict_ensemble):
    """A fault: every image's probabilities moved one class along."""
    def faulty(models, loader, cfg, weights=None):
        ids, preds, probs = predict_ensemble(models, loader, cfg, weights)
        return ids, preds, probs[:, list(range(1, probs.shape[1])) + [0]]
    return faulty


@pytest.mark.parametrize("cell,wrap", [("tiny_train", unchanged_state),
                                       ("tiny_train", half_batch),
                                       ("tiny_predict", altered_answers)])
def test_fault_comes_out_not_correct(tiny_root, cell, wrap):
    line, _ = run_cell(Spec(tiny_root), cell, SEED, 0.5, False, 0.0, device="cpu", wrap=wrap)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_unchanged_state_reads_one():
    from benchmark.entries import train as te
    from benchmark.inputs import dataset
    from benchmark.timing import Spans

    doc, traffic = tiny_doc(), TINY_TRAFFIC["tiny_train"]
    dev = torch.device("cpu")
    data = dataset(traffic, doc["config"], SEED, dev)
    t = te.Trainer(doc, traffic, SEED, dev, data, Spans(), wrap_step=unchanged_state)
    first = t.first_steps()
    nums = te.reference_numbers(first, doc, data, t.weights_seed, t.steps_per_epoch, dev)
    assert nums["grad_gap"][0] == pytest.approx(1.0)
    assert nums["change_gap"][0] == pytest.approx(1.0)


@pytest.mark.parametrize("entry", ["train", "predict"])
def test_control_fails_the_limits(entry):
    """The control at a CPU's size against the tiny cells' limits (the V4
    cells' own: ``test_bench_card.py``)."""
    from benchmark.entries import predict as pe
    from benchmark.entries import train as te
    from benchmark.inputs import dataset, derive_seed
    from benchmark.timing import Spans

    doc = tiny_doc()
    dev = torch.device("cpu")
    limits = TINY_LIMITS[entry]
    traffic = copy.deepcopy(TINY_TRAFFIC[f"tiny_{entry}"])
    data = dataset(traffic, doc["config"], SEED, dev)
    if entry == "train":
        t = te.Trainer(doc, traffic, SEED, dev, data, Spans())
        first = t.first_steps()
        nums = te.control_numbers(first, doc, data, t.weights_seed, t.steps_per_epoch, dev)
    else:
        seeds = [derive_seed(SEED, "weights", m) for m in range(traffic["models"])]
        rows = pe.sample_rows(SEED, traffic["n_test"], traffic["check_images"])
        nums = pe.control_numbers(doc, data, seeds, rows, dev)
    ok, checks = compare.judge(nums, limits)
    assert not ok, checks
