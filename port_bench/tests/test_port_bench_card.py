"""On the card: the step cell run through the harness for a short window
and its control at the cell's own size (``python -m pytest
port_bench/tests -m gpu``)."""

import time

import pytest

import harness
from conftest import ROOT


@pytest.mark.gpu
def test_the_step_cell_is_correct_on_the_card(card):
    spec = harness.Spec(ROOT)
    res, _ = harness.run_cell(spec, "ws_cc_step.512", 2**31 + 99, 3.0, False, "cuda", time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["metrics"]["step_voxels_per_s"]["value"] > 0


@pytest.mark.gpu
def test_the_step_control_fails_at_the_cell_size(card):
    from control import readings

    got = readings(harness.Spec(ROOT), "ws_cc_step.512", 2**31 + 98, "cuda")
    assert any(v["value"] > v["limit"] for v in got.values()), got
