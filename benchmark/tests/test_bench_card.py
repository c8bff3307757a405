"""On the card, at the cells' own size: the control (the reference in fp8
in the program's place) fails its cell's limits, and one seed of the
program passes them. ``python -m pytest benchmark/tests -m card``."""

from __future__ import annotations

import json

import pytest

from benchmark import compare
from benchmark.check import readings
from benchmark.spec import Spec
from benchmark.tests.conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("cell", ["v4_train", "v4_predict"])
def test_control_fails_and_program_passes(card, cell):
    limits = json.loads((ROOT / f"benchmark/limits/{cell}.json").read_text())
    got = {r["kind"]: r for r in readings(Spec(ROOT), cell, [3_000_000_123], [3_000_000_321],
                                          [], card)}
    as_pairs = {k: {n: (v, "") for n, v in r["numbers"].items()} for k, r in got.items()}
    assert compare.judge(as_pairs["program"], limits)[0]
    assert not compare.judge(as_pairs["control"], limits)[0]
