"""``benchmark/program_spans.py`` and the readers of the metrics whose source
is ``program_span``, on a hand-built ``Trace`` and hand-built program
spans: placement by the least offset and its refusals, idle gaps put down
to the innermost open span, and None wherever a reader has nothing of its
own to read (another role, four ranks, no trace, a program without
spans)."""

from __future__ import annotations

import sys
import types

import pytest

from benchmark import program_spans
from benchmark.spec import Spec
from benchmark.tests.conftest import ROOT
from benchmark.trace import Trace

T0 = 1_700_000_000_000_000_000      # the trace's start on time.time_ns
MS = 1_000_000
NEW = {"aug_device_ms.train": "train", "forward_device_ms.train": "train",
       "backward_device_ms.train": "train", "update_device_ms.train": "train",
       "dispatch_idle_ms.train": "train", "forward_device_ms.predict": "predict",
       "pull_idle_ms.predict": "predict"}


def span(name, parent, step, start_ms, end_ms, device_ms=None, lag_us=0):
    return {"name": name, "parent": parent, "step": step, "rows": None,
            "start_ns": T0 + int(start_ms * MS) + lag_us * 1000,
            "end_ns": T0 + int(end_ms * MS) + lag_us * 1000, "device_ms": device_ms}


def train_case(lags=(20, 50)):
    """Two 5-ms steps; each program span opens ``lags`` us after its
    step's mark. Device work: 0.1-3 ms, 4-9.9 ms; gaps 0-0.1 (in the first
    step's aug), 3-4 (in its backward, then the update), 9.9-10.5 (after
    the second step: outside)."""
    trace = Trace(0.0, 0.0105, device=[("k", 0.0001, 0.003), ("k", 0.004, 0.0099)],
                  spans=[("loader_next", -0.0002, 0.0), ("step", 0.0, 0.0048),
                         ("loader_next", 0.0048, 0.005), ("step", 0.005, 0.0088)],
                  launches=2, steps=2, images=8)
    spans = []
    for k, (base, lag) in enumerate(zip((0.0, 5.0), lags)):
        top = len(spans)
        spans += [span("train_step", None, k, base, base + 4.7, lag_us=lag),
                  span("train_step.augment", top, k, base, base + 1.0, 0.5, lag),
                  span("train_step.forward", top, k, base + 1.0, base + 2.0, 1.0, lag),
                  span("train_step.backward", top, k, base + 2.0, base + 3.5, 2.0, lag),
                  span("train_step.update", top, k, base + 3.5, base + 4.5, 0.25, lag)]
    return {"role": "train", "ranks": [{"trace": trace}]}, trace, spans


def test_placement_takes_the_least_offset():
    _, trace, spans = train_case()
    got = program_spans.place(trace, spans, "train")
    assert got is not None and len(got) == len(spans)
    # the first step's spans open 20 us after its mark: its lag is the least,
    # so they sit on the marks; the second step's sit 30 us late
    assert got[0][:3] == ("train_step", 0.0, pytest.approx(0.0047))
    assert got[5][1] == pytest.approx(0.00503)


@pytest.mark.parametrize("lags", [(20, 5021), (5050, 20)])
def test_placement_refuses_offsets_that_disagree_by_more_than_5_ms(lags):
    _, trace, spans = train_case(lags)
    assert program_spans.place(trace, spans, "train") is None


def test_a_late_span_moves_no_placement():
    """A step whose span opened 4.9 ms after its mark (the host held up)
    still places every span by the least offset."""
    _, trace, spans = train_case((20, 4920))
    got = program_spans.place(trace, spans, "train")
    assert got[0][1] == 0.0 and got[5][1] == pytest.approx(0.0099)


def test_placement_refuses_counts_that_differ():
    _, trace, spans = train_case()
    assert program_spans.place(trace, spans[:5], "train") is None
    trace.spans.append(("step", 0.0095, 0.0099))
    assert program_spans.place(trace, spans, "train") is None
    assert program_spans.place(trace, [], "train") is None


def test_a_gap_goes_to_the_innermost_open_span():
    _, trace, spans = train_case()
    idle = program_spans.idle_by_span(trace, program_spans.place(trace, spans, "train"))
    assert idle.keys() == {"train_step.augment", "train_step.backward", "outside the spans"}
    assert idle["train_step.augment"] == pytest.approx(0.0001)
    assert idle["train_step.backward"] == pytest.approx(0.001)
    assert idle["outside the spans"] == pytest.approx(0.0006)


def test_a_collection_inside_a_step_is_its_own_label():
    _, trace, spans = train_case()
    spans.append(span("host.gc", 3, 0, 2.9, 3.9))
    idle = program_spans.idle_by_span(trace, program_spans.place(trace, spans, "train"))
    assert idle["host.gc"] == pytest.approx(0.001) and "train_step.backward" not in idle


@pytest.fixture
def readers():
    spec = Spec(ROOT)
    return {name: spec.reader(name) for name in NEW}


def test_the_train_readers_on_the_hand_built_stretch(readers, monkeypatch):
    ctx, _, spans = train_case()
    monkeypatch.setattr(program_spans, "recorded", lambda: spans)
    assert readers["aug_device_ms.train"](ctx) == pytest.approx(0.5)
    assert readers["forward_device_ms.train"](ctx) == pytest.approx(1.0)
    assert readers["backward_device_ms.train"](ctx) == pytest.approx(2.0)
    assert readers["update_device_ms.train"](ctx) == pytest.approx(0.25)
    # 0.1 ms in the aug and 1 ms in the backward over two steps
    assert readers["dispatch_idle_ms.train"](ctx) == pytest.approx(0.55)


def predict_case():
    """One pass of two 4-ms batches: views 0.5 ms, forward 3, pull 0.5;
    device work 0.2-3.6 ms and 4.5-7.6 ms."""
    trace = Trace(0.0, 0.008, device=[("k", 0.0002, 0.0036), ("k", 0.0045, 0.0076)],
                  spans=[("predict", 0.0, 0.008)], launches=2, steps=2, images=128)
    spans = [span("predict_ensemble", None, None, 0.0, 8.0, lag_us=15)]
    for b in range(2):
        base = 4.0 * b
        spans += [span("loader.next", 0, None, base, base + 0.2, 0.1, 15),
                  span("predict.views", 0, b, base + 0.2, base + 0.5, 0.3, 15),
                  span("predict.forward", 0, b, base + 0.5, base + 3.5, 3.0, 15),
                  span("predict.pull", 0, b, base + 3.5, base + 4.0, 0.01, 15)]
    return {"role": "predict", "ranks": [{"trace": trace}]}, spans


def test_the_predict_readers_on_the_hand_built_pass(readers, monkeypatch):
    ctx, spans = predict_case()
    monkeypatch.setattr(program_spans, "recorded", lambda: spans)
    assert readers["forward_device_ms.predict"](ctx) == pytest.approx(3.0)
    # gaps 0-0.2 (loader.next), 3.6-4.5 (predict.pull: 0.9 ms), 7.6-8 (the
    # second pull: 0.4 ms); over two batches
    assert readers["pull_idle_ms.predict"](ctx) == pytest.approx(0.65)


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_reader_reads_nothing_not_its_own(readers, monkeypatch, name):
    train_ctx, _, train_spans = train_case()
    predict_ctx, predict_spans = predict_case()
    mine, other = ((train_ctx, train_spans), (predict_ctx, predict_spans))[::(
        1 if NEW[name] == "train" else -1)]
    read = readers[name]
    monkeypatch.setattr(program_spans, "recorded", lambda: mine[1] + other[1])
    assert read(other[0]) is None                           # the other role
    four = dict(mine[0], ranks=mine[0]["ranks"] * 4)        # a four-card cell
    assert read(four) is None
    assert read(dict(mine[0], ranks=[{"trace": None}])) is None
    monkeypatch.setattr(program_spans, "recorded", lambda: [])
    assert read(mine[0]) is None                            # no spans
    monkeypatch.setattr(program_spans, "recorded", lambda: mine[1])
    assert read(mine[0]) is not None


def test_a_program_without_spans_reads_none(readers, monkeypatch):
    """A checkout whose ``utils/profiler.py`` has no ``recorded`` (the
    benchmark laid over an older program): every reader returns None."""
    import image_classification_tpu_torch.utils as utils

    older = types.ModuleType("profiler")
    monkeypatch.setattr(utils, "profiler", older, raising=False)
    monkeypatch.setitem(sys.modules, "image_classification_tpu_torch.utils.profiler", older)
    assert program_spans.recorded() is None
    ctx, _, _ = train_case()
    predict_ctx, _ = predict_case()
    for name, role in NEW.items():
        assert readers[name](ctx if role == "train" else predict_ctx) is None


def test_the_new_entries_name_only_one_card_cells():
    doc = Spec(ROOT).doc
    got = {m["name"]: m for m in doc["per_layer"] if m["source"] == "program_span"
           and m["name"] in NEW}
    assert got.keys() == NEW.keys()
    for name, m in got.items():
        assert m["workloads"] == ["v4_train" if NEW[name] == "train" else "v4_predict"]
