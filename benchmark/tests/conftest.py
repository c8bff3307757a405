"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the root of the checkout. Those that need the card carry the ``card``
marker and skip inside the ``card`` fixture where there is none."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's numbers come only from the card")
    return torch.device("cuda", 0)


def tiny_doc(config: str = "convnext_b_v4") -> dict:
    """A configuration file cut to a CPU's size: 32 px from 12x16 images,
    batch 8; V4's ConvNeXt-B becomes convnext_atto."""
    doc = copy.deepcopy(json.loads((ROOT / f"benchmark/configs/{config}.json").read_text()))
    doc["config"].update(image_size=[32, 32], native_size=[12, 16], batch_size=8)
    if config == "convnext_b_v4":
        doc["config"]["model_name"] = "convnext_atto"
    else:
        # BatchNorm over 8 rows of 1x1 maps makes bf16's rounding the whole
        # gap (grad 0.59-0.72 against 8.6e-5 in f32): the tiny cell runs f32
        doc["config"]["compute_dtype"] = "float32"
    return doc


TINY_TRAFFIC = {
    "tiny_train": {"entry": "train", "n_train": 64, "n_test": 0, "trace_steps": 2},
    "tiny_foldpar": {"entry": "foldpar", "n_train": 160, "n_test": 0, "trace_steps": 2,
                     "config": {"num_folds": 4, "fold_parallel": True}},
    "tiny_predict": {"entry": "predict", "n_train": 0, "n_test": 20, "models": 2,
                     "batch": 8, "warm_batches": 1, "trace_batches": 2,
                     "check_images": 6, "check_batches": 2},
    "tiny_v31": {"entry": "train", "n_train": 64, "n_test": 0, "trace_steps": 2},
}
TINY_CONFIGS = {"tiny_v31": "tiny_effnet"}


# The tiny cells' limits, set as the cells' are (between the most that
# sound runs read and the least that the control or a fault reads), from
# CPU readings at this size: the program on 8 seeds read loss 7.3e-4 to
# 1.9e-3, grad 3.9e-3 to 1.1e-2, change 3.6e-3 to 8.9e-3, EMA change 4.8e-3
# to 6.5e-2, log-probability 1.8e-2 to 2.5e-2; the control on 3 seeds at
# least 4.7e-3, 3.6e-2, 2.5e-2, 6.0e-2 and 0.142; half of each batch at
# least 0.104, 0.239, 0.119, 0.115.
TINY_LIMITS = {"train": {"loss_gap": 0.003, "grad_gap": 0.02, "change_gap": 0.02,
                         "ema_change_gap": 0.1},
               "predict": {"logprob_gap": 0.06}}


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A copy of the benchmark with a tiny configuration and three tiny
    cells added as new files and entries, nothing that was there edited."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    doc = json.loads((root / "BENCHMARK.json").read_text())
    for name, config in (("tiny_atto", "convnext_b_v4"), ("tiny_effnet", "effnetv2_s_v31")):
        (root / f"benchmark/configs/{name}.json").write_text(json.dumps(tiny_doc(config)))
        doc["configs"].append({"name": name, "source": "a CPU's size",
                               "file": f"benchmark/configs/{name}.json", "reduced": [],
                               "why": "tests"})
    for name, traffic in TINY_TRAFFIC.items():
        (root / f"benchmark/traffic/{name}.json").write_text(json.dumps(traffic))
        lim = TINY_LIMITS["predict" if traffic["entry"] == "predict" else "train"]
        (root / f"benchmark/limits/{name}.json").write_text(json.dumps(lim))
        chips = 4 if traffic["entry"] == "foldpar" else 1
        doc["workloads"].append({"name": name, "config": TINY_CONFIGS.get(name, "tiny_atto"),
                                 "traffic": name, "chips": chips, "why": "tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return root
