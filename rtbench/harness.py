"""One run of one cell: set-up, the measured window, the reference's check
and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name `BENCHMARK.json` gives it:

* `configs/<config>.json`: the configuration as it is run;
* `traffic/<traffic>.json`: the mix's parameters, and the driver module
  under `drivers/` that plays them;
* `limits/<workload>.json`: each number the check compares, with its
  limit;
* `metrics/<metric>.py`: a reader of the traced run (`read(trace)` ->
  a number, or None where the cell has nothing to read).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path

from rtbench import tracing

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
BENCHMARK_FILE = ROOT / "BENCHMARK.json"
# Top-level module names that no run may load: the JAX package and JAX.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ray_tracing_in_one_weekend_tpu")


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(path: Path = BENCHMARK_FILE) -> dict:
    return _read_json(path)


class Cell:
    """A workload of `BENCHMARK.json` with its configuration, traffic mix,
    limits and metrics, read from their files."""

    def __init__(self, name: str, bench: dict | None = None, bench_dir: Path = BENCH_DIR, **overrides):
        """`overrides` replace entries of the configuration (`config=`) or
        the mix (`traffic=`): how the tests run a cell at a tiny size."""
        bench = load_benchmark() if bench is None else bench
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(entries)}")
        self.name = name
        self.entry = entries[name]
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _read_json(ROOT / configs[self.entry["config"]]["file"])
        self.traffic = _read_json(bench_dir / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = _read_json(bench_dir / "limits" / f"{name}.json")
        self.config.update(overrides.get("config", {}))
        self.traffic.update(overrides.get("traffic", {}))
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]

    def driver_class(self):
        return importlib.import_module(f"rtbench.drivers.{self.traffic['driver']}").Driver


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The module `metrics/<name>.py`, loaded by its path."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"rtbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def process_seconds() -> float | None:
    """Seconds since this process started, from the kernel's clock ticks
    (/proc), or None where that is not readable."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN_MODULES)


def p95(values) -> float:
    """The 95th percentile (statistics.quantiles, inclusive method)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(driver, seconds: float, device) -> dict:
    """Frames back to back until `seconds` have passed -> the frames' ms,
    the rays they traced and the window's seconds."""
    frame_ms, rays = [], 0
    t0 = time.perf_counter()
    while True:
        f0 = time.perf_counter()
        rays += driver.frame()
        f1 = time.perf_counter()
        frame_ms.append((f1 - f0) * 1e3)
        if f1 - t0 >= seconds:
            break
    return {"frame_ms": frame_ms, "rays": rays, "window_s": f1 - t0}


def traced_window(driver, seconds: float, device) -> dict:
    """Frames under torch.profiler for `seconds` -> the trace's device
    events inside the window, its busy and wall seconds, the frames, and
    the host's operations (for the idle gaps)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    before = dict(build.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1_000_000)  # the profiler has been seen to drop the first kernel it should trace
        _sync(device)
        frames = 0
        with record_function("rtbench.window"):
            t0 = time.perf_counter()
            while True:
                driver.frame()
                frames += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            _sync(device)
    launches = {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()}
    events = prof.events()
    win = next(e for e in events if e.name == "rtbench.window" and e.device_type == DeviceType.CPU)
    w0, w1 = win.time_range.start, win.time_range.end
    device_ops, host_ops = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # The window's own annotation on the device's timeline, and the
            # sleep before it, are no work.
            if e.name == "rtbench.window" or "sleep" in e.name or end <= w0 or start >= w1:
                continue
            device_ops.append((e.name, max(start, w0), min(end, w1)))
        elif w0 <= start < w1 and e.name != "rtbench.window":
            host_ops.append((e.name, start, end))
    device_ops.sort(key=lambda op: op[1])
    busy, gaps, cursor = 0.0, [], w0
    for _, start, end in device_ops:
        if start > cursor:
            gaps.append((cursor, start))
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if w1 > cursor:
        gaps.append((cursor, w1))
    return {"frames": frames, "window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6, "device_ops": device_ops,
            "gaps": gaps, "host_ops": host_ops, "launches": launches}


def breakdown(trace: dict) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps by the host operation running when each began."""
    by_name: dict = {}
    for name, start, end in trace["device_ops"]:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    host = sorted(trace["host_ops"], key=lambda op: op[1])
    gaps = []
    for g0, g1 in sorted(trace["gaps"], key=lambda g: g[0] - g[1])[:10]:
        # The innermost host operation running when the gap began.
        running = [op for op in host if op[1] <= g0 < op[2]]
        name = min(running, key=lambda op: op[2] - op[1])[0] if running else "host between operations"
        gaps.append([name[:120], (g1 - g0) / 1e6])
    return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": gaps}


def nvidia_smi(fields: str) -> str | None:
    """One `nvidia-smi --query-gpu` reading of the first card, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def judge(checks: dict) -> tuple:
    """(numbers over their limits, correct) of `checks` ({name: {"value",
    "limit"}}). A NaN fails its comparison too, and a run with nothing
    compared is not correct."""
    failed = sum(1 for c in checks.values() if not c["value"] <= c["limit"])
    return failed, failed == 0 and bool(checks)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, process_start: float) -> dict:
    """One run of `cell` on `device` -> the result's fields (not yet the
    forbidden-module check). `process_start` is the process's start on the
    `time.perf_counter()` clock: set-up runs from there until the window
    opens."""
    import torch

    parts = {"to_harness": time.perf_counter() - process_start}
    if device.type == "cuda":
        torch.zeros(1, device=device)  # the CUDA context
        parts["cuda_context"] = time.perf_counter() - process_start
    driver = cell.driver_class()(cell, seed, device)
    driver.setup()
    _sync(device)
    setup_s = time.perf_counter() - process_start
    result = {"correct": None, "attempted": 0, "failed": 0, "metrics": {}}
    if trace:
        driver.recording = True
        window = traced_window(driver, min(seconds, float(cell.traffic.get("trace_seconds", seconds))), device)
        window.update(driver.trace_counts(window["frames"]))
        result["attempted"] = window["frames"]
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(window)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = breakdown(window)
        untraced = tracing.untraced_launches(window)
        busy_s, window_s = window["busy_s"], window["window_s"]
    else:
        window = measure(driver, seconds, device)
        result["attempted"] = len(window["frame_ms"])
        values = {
            "mrays_s": window["rays"] / window["window_s"] / 1e6,
            driver.tail: p95(window["frame_ms"]),
            "setup_s": setup_s,
        }
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    # The card's clock, temperature and power as the window closed.
    card = nvidia_smi("clocks.sm,temperature.gpu,power.draw") if device.type == "cuda" else None
    if not trace:
        values["peak_mem_gib"] = peak / 2**30
        for m in cell.end_to_end:
            if m["name"] in values:
                result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    checks = driver.check()
    result["failed"], result["correct"] = judge(checks)
    result["device"] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    if trace:
        result["device"].update(busy_s=busy_s, window_s=window_s, untraced_launches=untraced)
    result["device"]["card_at_close"] = card
    marks = {k: t - process_start for k, t in getattr(driver, "setup_parts", {}).items()}
    result["device"]["setup_parts_s"] = dict(parts, **marks, total=setup_s)
    result["checks"] = checks
    return result
