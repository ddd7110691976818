"""A run's check against planted faults: the harness's whole run at a tiny
size on the CPU (the port's plain versions; the look for a chip is
skipped), with the timed path sound and then broken underneath
(`rtbench.faults`) once set-up has ended, once for each fault a cell can
have."""

from __future__ import annotations

import contextlib
import time

import pytest
import torch

from rtbench import faults, harness

TINY = {"image_width": 24, "image_height": 16, "max_depth": 8}
TRAFFIC = {"check_pixels": 96, "batch_spp": 2, "hold_frames": [1, 3], "checked_steps": 3}
CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


def _cell(workload: str):
    spp = 2 if workload.endswith("keyed_step") else 4
    return harness.Cell(workload, config=dict(TINY, samples_per_pixel=spp), traffic=TRAFFIC)


def _run(cell, seed: int = 2**31 + 11) -> dict:
    return harness.run_cell(cell, seed, 0.3, False, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    cell = _cell(workload)
    result = _run(cell)
    assert result["correct"] is True, result["checks"]
    # Every limit is compared (the sweeps a keyed step counts come from the card's kernels alone).
    assert set(result["checks"]) == set(cell.limits) - ({"sweeps_gap"} if "sweeps_gap" in cell.limits else set())
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_broken_run_is_not_correct(workload, fault):
    cell = _cell(workload)
    with contextlib.ExitStack() as stack:
        faulty = faults.after_setup(cell.driver_class(), fault, stack)
        cell.driver_class = lambda: faulty
        result = _run(cell)
    assert result["correct"] is False, result["checks"]
