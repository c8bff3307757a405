"""The harness finds each configuration, traffic mix, limits file and
metric reader by name, and refuses bad names and units."""

from __future__ import annotations

import json

import pytest

from benchmark.spec import Spec, check_name, check_unit
from benchmark.tests.conftest import ROOT


def test_every_named_file_is_found():
    spec = Spec(ROOT)
    doc = spec.doc
    for c in doc["configs"]:
        assert (ROOT / c["file"]).is_file()
        cfg = spec.config(c["name"])
        assert set(c["reduced"]) <= set(cfg["config"])
    for w in doc["workloads"]:
        assert spec.workload(w["name"]) is w
        assert spec.traffic(w["traffic"])["entry"] in ("train", "predict", "foldpar")
        assert (spec.bench_dir / "limits" / f"{w['name']}.json").is_file()
        assert spec.metrics_of(w["name"], "end_to_end")
        assert spec.metrics_of(w["name"], "per_layer")
    for m in doc["per_layer"]:
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("name", ["v4_train", "a.b-c_d", "0x", "_x"])
def test_good_names(name):
    assert check_name(name, "x") == name


@pytest.mark.parametrize("name", ["", "a b", "a/b", "a,b", ".x", "-x", "x" * 65, "é"])
def test_bad_names(name):
    with pytest.raises(ValueError):
        check_name(name, "x")


@pytest.mark.parametrize("unit", ["images/s", "ms", "%", "s", "tokens/s"])
def test_good_units(unit):
    assert check_unit(unit) == unit


@pytest.mark.parametrize("unit", ["", "images per s", "x" * 17, "µs"])
def test_bad_units(unit):
    with pytest.raises(ValueError):
        check_unit(unit)


def test_a_bad_name_in_the_file_is_refused(tmp_path):
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["workloads"][0]["name"] = "v4 train"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    with pytest.raises(ValueError):
        Spec(tmp_path)


def test_bad_unit_in_the_file_is_refused(tmp_path):
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["end_to_end"][0]["unit"] = "images per second"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    with pytest.raises(ValueError):
        Spec(tmp_path)


def test_an_unknown_entry_is_refused(tmp_path):
    (tmp_path / "benchmark/traffic").mkdir(parents=True)
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "benchmark/traffic/odd.json").write_text('{"entry": "serve"}')
    with pytest.raises(ValueError):
        Spec(tmp_path).traffic("odd")


def test_contract_shape():
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(doc) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    e2e = {m["name"] for m in doc["end_to_end"]}
    assert "setup_s" in e2e
    for w in doc["workloads"]:
        got = [m for m in doc["end_to_end"]
               if "workloads" not in m or w["name"] in m["workloads"]]
        assert len(got) >= 2
    for m in doc["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            moved = next(x for x in doc["end_to_end"] if x["name"] == m["moves"])
            assert "workloads" not in moved or w in moved["workloads"]
    four = [w for w in doc["workloads"] if w["chips"] == 4]
    assert [w["name"] for w in four] == ["v4_foldpar4"]
