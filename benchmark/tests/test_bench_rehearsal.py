"""Tiny CPU rehearsals of each entry, run through ``run.run_cell`` on a
copy of the benchmark to which the tiny cells were added as new files:
each comes out correct, holds its numbers beside their limits, and prints
no metric (every metric is the card's). No file that was there changes."""

from __future__ import annotations

import hashlib

import pytest

from benchmark.run import run_cell
from benchmark.spec import Spec

SEED = 2**31 + 12345     # larger than 32 signed bits hold


def _hashes(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


@pytest.mark.parametrize("cell,trace", [("tiny_train", True), ("tiny_predict", True),
                                        ("tiny_foldpar", False), ("tiny_v31", False)])
def test_rehearsal(tiny_root, cell, trace):
    before = _hashes(tiny_root)
    line, host = run_cell(Spec(tiny_root), cell, SEED, 1.0, trace, 0.0, device="cpu")
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert line["metrics"] == {}                       # no device metric from a CPU
    assert line["device"]["platform"] == "cpu"
    assert "busy_s" not in line["device"] and "breakdown" not in line
    assert list(line)[-1] == "checks"
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
    assert _hashes(tiny_root) == before
    assert "cores" in host


def test_the_same_seed_gives_the_same_inputs():
    import torch

    from benchmark.inputs import dataset, make_weights
    from benchmark.reference.train import param_spec
    from benchmark.tests.conftest import TINY_TRAFFIC, tiny_doc

    cfg = tiny_doc()["config"]
    a = dataset(TINY_TRAFFIC["tiny_train"], cfg, SEED, torch.device("cpu"))
    b = dataset(TINY_TRAFFIC["tiny_train"], cfg, SEED, torch.device("cpu"))
    assert (a["train"]["images"] == b["train"]["images"]).all()
    assert (a["train"]["labels"] == b["train"]["labels"]).all()
    spec = param_spec(cfg)
    wa, wb = (make_weights(spec, SEED, torch.device("cpu")) for _ in range(2))
    assert all(torch.equal(wa[k], wb[k]) for k in wa)


@pytest.mark.parametrize("config", ["convnext_b_v4", "effnetv2_s_v31"])
def test_reference_names_load_strictly_into_the_program(config):
    import torch

    from benchmark.entries.common import program_config
    from benchmark.inputs import make_weights
    from benchmark.reference.train import param_spec
    from benchmark.tests.conftest import tiny_doc
    from image_classification_tpu_torch.models.factory import create_model

    doc = tiny_doc(config)
    module = create_model(program_config(doc, 1)).module
    w = make_weights(param_spec(doc["config"]), 1, torch.device("cpu"))
    module.load_state_dict(w, strict=True)
    assert sorted(module.state_dict()) == sorted(w)
