"""The benchmark's files: every piece found by name, BENCHMARK.json within
the contract's limits, and nothing under rtbench/ importing JAX or the JAX
package (the reference not even the port)."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from rtbench import harness, tracing

BENCH = harness.load_benchmark()
RTBENCH = harness.BENCH_DIR
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path: Path) -> set[str]:
    """Top-level names of every module `path` imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(workload):
    cell = harness.Cell(workload)
    assert cell.config["name"] == cell.entry["config"]
    assert cell.driver_class().tail in {m["name"] for m in cell.end_to_end}
    assert {"mrays_s", "setup_s", "peak_mem_gib"} <= {m["name"] for m in cell.end_to_end}
    assert cell.per_layer, "every cell reports a per-layer metric"
    assert cell.limits and all(isinstance(v, (int, float)) for v in cell.limits.values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.metric_reader(metric).read)


def test_every_config_and_mix_file_is_used():
    configs = {c["name"] for c in BENCH["configs"]}
    assert {p.stem for p in (RTBENCH / "configs").glob("*.json")} == configs
    assert {w["config"] for w in BENCH["workloads"]} == configs
    assert {p.stem for p in (RTBENCH / "traffic").glob("*.json")} == {w["traffic"] for w in BENCH["workloads"]}
    assert {p.stem for p in (RTBENCH / "limits").glob("*.json")} == {w["name"] for w in BENCH["workloads"]}
    assert {p.stem for p in (RTBENCH / "metrics").glob("*.py")} == {m["name"] for m in BENCH["per_layer"]}


def test_benchmark_json_keeps_the_contracts_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(1 <= len(c[k]) <= 200 for k in ("source", "why"))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_no_module_imports_jax_or_the_jax_package():
    for path in RTBENCH.rglob("*.py"):
        found = _imports(path) & set(harness.FORBIDDEN_MODULES)
        assert not found, f"{path} imports {found}"


def test_the_reference_imports_nothing_of_the_port():
    for path in (RTBENCH / "reference").glob("*.py"):
        assert "ray_tracing_in_one_weekend_tpu_torch" not in _imports(path), path


def test_a_kernel_with_an_untraced_launch_reads_no_seconds():
    trace = {"device_ops": [("render_kernel(float*)", 0.0, 1000.0), ("render_kernel(float*)", 2000.0, 2500.0)],
             "launches": {"render_kernel": 2}}
    assert tracing.kernel_seconds(trace, "render_kernel") == pytest.approx(1.5e-3)
    assert tracing.untraced_launches(trace) == {}
    trace["launches"]["render_kernel"] = 3
    assert tracing.kernel_seconds(trace, "render_kernel") is None
    assert tracing.untraced_launches(trace) == {"render_kernel": 1}
