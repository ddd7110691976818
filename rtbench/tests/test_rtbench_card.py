"""The cells' check on the card at a small size: the kernels against the
plain reference (correct), and the control, the reference in bfloat16 in
the program's place, over the limits. Marked `cuda`: they skip without a
card.

    python3 -m pytest rtbench/tests/test_rtbench_card.py -m cuda
"""

from __future__ import annotations

import time

import pytest
import torch

from rtbench import harness

SMALL = {"image_width": 96, "image_height": 64, "max_depth": 50}
TRAFFIC = {"check_pixels": 512, "batch_spp": 4, "hold_frames": [1, 3], "checked_steps": 3}
CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _cell(workload):
    spp = 4 if workload.endswith("keyed_step") else 8
    return harness.Cell(workload, config=dict(SMALL, samples_per_pixel=spp), traffic=TRAFFIC)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_small_run_on_the_card_is_correct(card, workload):
    result = harness.run_cell(_cell(workload), 2**31 + 3, 0.5, False, card, time.perf_counter())
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_on_the_card_fails_a_limit(card, workload):
    cell = _cell(workload)
    driver = cell.driver_class()(cell, 2**31 + 4, card)
    driver.setup()
    harness.measure(driver, 0.5, card)
    numbers = driver.check(control=True)
    assert any(v > cell.limits[k] for k, v in numbers["control"].items()), numbers
    assert all(v <= cell.limits[k] for k, v in numbers["program"].items()), numbers
