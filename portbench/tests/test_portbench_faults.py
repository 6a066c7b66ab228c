"""A run with the timed path broken underneath comes out not ``correct``.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU at a small size (``conftest.TINY``) with one planted fault of
its cell, and with the cell's own limits. The control (the reference one
precision step below the cell's, in the program's place) fails too.
"""

from __future__ import annotations

import math

import pytest

from portbench import check, control, harness

from .conftest import TINY

TRAIN, PREDICT = ("r50_train_bf16_b8", "plain_train_f32_b8"), ("r50_predict_bf16_b32",
                                                              "plain_predict_bf16_b32")
CASES = [(c, f) for c in TRAIN for f in ("unchanged_state", "half_batch")] + \
        [(c, f) for c in PREDICT for f in ("half_batch", "altered_answer")]


def _tiny(cell: str) -> dict:
    return TINY[harness.load_cell(cell)[0]["entry"]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault):
    result = harness.run_cell(cell, 2**31 + 101, 0.5, False, device="cpu",
                              overrides=_tiny(cell), fault=fault)
    assert result["correct"] is False
    assert list(result)[-1] == "checks"
    assert any(not (math.isfinite(r["value"]) and r["value"] <= r["limit"])
               for r in result["checks"])


@pytest.mark.parametrize("cell", TRAIN + PREDICT)
def test_the_control_is_not_correct(cell):
    rows = control.readings(cell, [2**32 + 7], control_seeds=1, fault_seeds=0, device="cpu",
                            overrides=_tiny(cell))
    low = next(r for r in rows if r["kind"].startswith("control_"))
    ok, _ = check.verdict(low, harness.load_cell(cell)[0]["limits"])
    assert not ok, low
