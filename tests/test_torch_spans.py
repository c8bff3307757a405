"""The port's spans (``utils/profiler.py:span``) on the CPU: they record only
while a ``torch.profiler`` session records (its active phase, not a
schedule's warm-up), name their parent and share the step's id across the
train step and the predict loop, change nothing the step or the predict
loop computes, and make no CUDA event when off. Also ``host.gc``, the
operator's ``trace`` export, ``StepTimer.step`` and the module's load by
path alone, as the kernel timing tools load it."""

import ast
import contextlib
import gc
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from image_classification_tpu_torch.core.config import load_config
from image_classification_tpu_torch.data.loader import DataLoader
from image_classification_tpu_torch.data.manifest import Manifest
from image_classification_tpu_torch.data.source import ArraySource
from image_classification_tpu_torch.infer.predict import predict_ensemble
from image_classification_tpu_torch.models.factory import create_model
from image_classification_tpu_torch.train.loop import build_lr_schedule
from image_classification_tpu_torch.train.loss import build_criterion
from image_classification_tpu_torch.train.optim import build_optimizer
from image_classification_tpu_torch.train.step import make_train_step
from image_classification_tpu_torch.train.train_state import create_train_state
from image_classification_tpu_torch.utils import profiler

from test_torch_ops import one_torch_thread  # noqa: F401  (autouse, module scope)

REPO = Path(__file__).resolve().parents[1]
PROFILER_PY = REPO / "image_classification_tpu_torch" / "utils" / "profiler.py"
TRAIN_SPANS = ["train_step", "train_step.augment", "train_step.forward",
               "train_step.backward", "train_step.forward", "train_step.backward",
               "train_step.update"]


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiler.clear()
    yield
    profiler.clear()


def recording():
    """A profiler session in its recording phase from entry (CPU only)."""
    return profile(activities=[ProfilerActivity.CPU])


def tiny_cfg(**over):
    """V4's recipe (aug, mix, deep supervision, EMA) on ConvNeXt-atto at 32 px,
    two microbatches of two."""
    kw = dict(model_name="convnext_atto", num_classes=5, native_size=[24, 32],
              image_size=[32, 32], batch_size=4, gradient_accumulation_steps=2,
              compute_dtype="float32", tta_mode="flip", infer_cast_params=False)
    kw.update(over)
    return load_config(str(REPO / "configs" / "v4.json"),
                       [f"{k}={json.dumps(v)}" for k, v in kw.items()])


def tiny_train(cfg):
    """``(step, state, batch)`` of a seeded tiny model; ``step(state, batch,
    seed)`` draws from a generator seeded ``seed``."""
    bundle = create_model(cfg, generator=torch.Generator().manual_seed(0))
    tx = build_optimizer(cfg, build_lr_schedule(cfg, 10))
    state = create_train_state(bundle.module, use_ema=True)
    train_step = make_train_step(bundle, cfg, tx, build_criterion(cfg))
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.integers(0, 256, (4, 24, 32, 3), dtype=np.uint8)),
             "label": torch.from_numpy(rng.integers(0, cfg.num_classes, 4))}

    def step(state, batch, seed):
        return train_step(state, batch, generator=torch.Generator().manual_seed(seed))

    return step, state, batch


def test_nothing_is_recorded_and_no_event_made_when_off(monkeypatch):
    """The CUDA branch with the card faked: off (no profiler, then a
    schedule's warm-up as the benchmark's stretch has) makes no event and
    records nothing; the recording phase makes a pair a span."""
    made = []

    class Event:
        def __init__(self, enable_timing=False):
            made.append(self)

        def record(self):
            pass

        def elapsed_time(self, other):
            return 1.5

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    with profiler.span("off"):
        pass
    assert profiler.recorded() == [] and made == []
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        with profiler.span("warm-up"):
            pass
        assert profiler.recorded() == [] and made == []
        prof.step()
        with profiler.span("active", step=7, rows=3):
            pass
        prof.step()
        with profiler.span("stopped"):
            pass
    spans = profiler.recorded()
    assert [(s["name"], s["step"], s["rows"], s["parent"]) for s in spans] == \
        [("active", 7, 3, None)]
    assert len(made) == 2 and spans[0]["device_ms"] == 1.5


def test_spans_record_in_the_active_phase_with_parents_and_host_times():
    with recording():
        with profiler.span("outer", step=3):
            with profiler.span("inner", rows=2):
                pass
            with profiler.span("second", step=4):
                pass
    outer, inner, second = profiler.recorded()
    assert [s["name"] for s in (outer, inner, second)] == ["outer", "inner", "second"]
    assert (outer["parent"], inner["parent"], second["parent"]) == (None, 0, 0)
    assert (outer["step"], inner["step"], second["step"]) == (3, 3, 4)
    assert inner["rows"] == 2 and outer["rows"] is None
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= second["start_ns"]
    assert second["end_ns"] <= outer["end_ns"]
    assert all(s["device_ms"] is None for s in (outer, inner, second))   # no CUDA here


def test_train_step_spans_parents_and_step_id():
    step, state, batch = tiny_train(tiny_cfg())
    state, _ = step(state, batch, 1)        # state.step 0 -> 1, unrecorded
    with recording():
        for seed in (2, 3):
            state, _ = step(state, batch, seed)
    spans = profiler.recorded()
    assert [s["name"] for s in spans] == TRAIN_SPANS * 2
    for k, first in enumerate((0, len(TRAIN_SPANS))):
        top = spans[first]
        assert top["parent"] is None and top["step"] == 1 + k and top["rows"] == 4
        for s in spans[first + 1:first + len(TRAIN_SPANS)]:
            assert s["parent"] == first and s["step"] == 1 + k
            assert top["start_ns"] <= s["start_ns"] <= s["end_ns"] <= top["end_ns"]
    assert [s["rows"] for s in spans if s["name"] == "train_step.forward"] == [2] * 4


def _flat(state):
    return [t.clone() for t in (*state.params(), *state.mu, *state.nu, *state.ema)]


def test_train_step_is_bit_identical_with_spans_on_and_off():
    cfg = tiny_cfg()
    results = []
    for on in (False, True):
        step, state, batch = tiny_train(cfg)
        with recording() if on else contextlib.nullcontext():
            for seed in (1, 2):
                state, metrics = step(state, batch, seed)
        results.append((_flat(state), {k: v.clone() for k, v in metrics.items()}, state.step))
    (off, m_off, n_off), (on, m_on, n_on) = results
    assert n_off == n_on == 2 and m_off.keys() == m_on.keys()
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    assert all(torch.equal(m_off[k], m_on[k]) for k in m_off)
    assert len(profiler.recorded()) == 2 * len(TRAIN_SPANS)


def test_predict_ensemble_spans_and_bit_identical_results():
    cfg = tiny_cfg(num_classes=6)
    models = [create_model(cfg, generator=torch.Generator().manual_seed(s)).module
              for s in (0, 1)]
    images = np.random.default_rng(1).integers(0, 256, (10, 24, 32, 3), dtype=np.uint8)
    manifest = Manifest(np.array([f"t{i}" for i in range(10)], dtype=object),
                        np.full(10, -1), is_test=True)
    loader = DataLoader(ArraySource(images), manifest, batch_size=4, pad_last=True,
                        device="cpu", prefetch_depth=0)
    ids_off, _, probs_off = predict_ensemble(models, loader, cfg)
    assert profiler.recorded() == []
    with recording():
        ids_on, _, probs_on = predict_ensemble(models, loader, cfg)
    assert ids_on == ids_off and np.array_equal(probs_on, probs_off)
    spans = profiler.recorded()
    per_batch = ["loader.next", "predict.views", "predict.forward", "predict.pull"]
    assert [s["name"] for s in spans] == \
        ["predict_ensemble"] + per_batch * 3 + ["loader.next"]
    assert all(s["parent"] == 0 for s in spans[1:]) and spans[0]["parent"] is None
    steps = [s["step"] for s in spans if s["name"].startswith("predict.")]
    assert steps == [0, 0, 0, 1, 1, 1, 2, 2, 2]
    assert [s["rows"] for s in spans if s["name"] == "predict.views"] == [4, 4, 4]


def test_a_generation_2_collection_is_host_gc_only_when_on():
    gc.collect(2)
    assert profiler.recorded() == []
    with recording():
        with profiler.span("outer"):
            gc.collect(1)                   # not generation 2: nothing
            gc.collect(2)
    outer, collection = profiler.recorded()
    assert collection["name"] == "host.gc" and collection["parent"] == 0
    assert outer["start_ns"] <= collection["start_ns"] <= collection["end_ns"] <= outer["end_ns"]
    assert collection["device_ms"] is None
    gc.collect(2)
    assert len(profiler.recorded()) == 2


def test_trace_clears_then_writes_the_region_s_spans(tmp_path):
    with recording():
        with profiler.span("before the region"):
            pass
    with profiler.trace(str(tmp_path), "epoch"):
        with profiler.span("in the region", step=5):
            pass
    assert (tmp_path / "epoch.json").is_file()
    spans = json.loads((tmp_path / "epoch.spans.json").read_text())
    assert [(s["name"], s["step"]) for s in spans] == [("in the region", 5)]
    with profiler.trace(None):
        with profiler.span("no directory"):
            pass
    assert len(profiler.recorded()) == 1


def test_step_timer_counts_steps_and_images():
    timer = profiler.StepTimer()
    with timer.data_wait():
        pass
    timer.step(n_images=8)
    timer.step(n_images=4)
    summary = timer.summary()
    assert (timer.n_steps, timer.n_images, summary["steps"]) == (2, 12, 2)
    assert not hasattr(timer, "compute_time")
    assert set(summary) == {"steps", "images_per_sec", "duty_cycle", "data_time_s",
                            "wall_time_s"}


def test_profiler_flag_is_where_torch_sets_it():
    """The gate reads torch's private ``_is_profiler_enabled``: a torch that
    moves it fails here, and not by recording nothing."""
    from torch.autograd import profiler as autograd_profiler

    assert autograd_profiler._is_profiler_enabled is False
    with recording():
        assert autograd_profiler._is_profiler_enabled is True
    assert autograd_profiler._is_profiler_enabled is False


def test_profiler_module_loads_by_path_alone():
    """Only torch and the standard library, loaded from its file under
    another name (``tools/time_block_mlp.py:_timer``)."""
    tree = ast.parse(PROFILER_PY.read_text())
    tops = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    tops |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module and n.level == 0}
    assert tops - {"__future__", "torch"} <= set(sys.stdlib_module_names)
    spec = importlib.util.spec_from_file_location("_ic_spans_by_path", PROFILER_PY)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    try:
        spec.loader.exec_module(module)
        assert callable(module.device_ms) and callable(module.span)
        with module.span("off"):
            pass
        assert module.recorded() == []
    finally:
        gc.callbacks.remove(module._on_collection)
        del sys.modules[spec.name]
