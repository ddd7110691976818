"""The readers of the port's spans (`rtbench/spans.py` and its four
metrics): on synthetic traces on the CPU, and on the card, where a few
frames of each cell's path run under the profiler (marked `cuda`: skipped
without a card).

    python3 -m pytest rtbench/tests/test_rtbench_spans.py -m cuda
"""

from __future__ import annotations

import random

import pytest
import torch

from rtbench import harness, spans

READERS = ("host_syncs_per_frame", "idle_sync_pct", "idle_program_pct", "idle_client_pct")
PARTS = ("idle_sync_pct", "idle_program_pct", "idle_client_pct")


def _read(name, trace):
    return harness.metric_reader(name).read(trace)


def _trace(host_ops, gaps, frames=2, window_us=200.0):
    """A traced window of `window_us` µs from 0 whose only idle is `gaps`."""
    idle = sum(g1 - g0 for g0, g1 in gaps)
    return {"frames": frames, "window_s": window_us / 1e6, "busy_s": (window_us - idle) / 1e6,
            "gaps": gaps, "host_ops": host_ops, "device_ops": [], "launches": {}}


# Two threads: the main one in the train step, the autograd engine's in
# the backward and its sync; PyTorch's own operations are no port spans.
HOST_OPS = [
    ("rt.train_step", 0.0, 100.0),
    ("aten::mul", 10.0, 30.0),
    ("rt.keyed.backward", 40.0, 90.0),
    ("rt.sync.arena_total", 50.0, 60.0),
    ("aten::_local_scalar_dense", 50.5, 59.0),
    ("rt.sync.arena_total", 120.0, 121.0),
]


@pytest.mark.parametrize("gap, part", [
    ((10.0, 20.0), "idle_program_pct"),  # inside the step, under a PyTorch operation
    ((45.0, 48.0), "idle_program_pct"),  # the backward, on the other thread
    ((55.0, 58.0), "idle_sync_pct"),  # the sync, the innermost port span at its start
    ((95.0, 110.0), "idle_program_pct"),  # begun in the step, ended past it
    ((150.0, 160.0), "idle_client_pct"),  # begun in no port span
    ((121.0, 130.0), "idle_client_pct"),  # begun as a sync span ended
])
def test_a_gap_goes_to_the_innermost_port_span_at_its_start(gap, part):
    trace = _trace(HOST_OPS, [gap])
    expected = 100.0 * (gap[1] - gap[0]) / 200.0
    for name in PARTS:
        assert _read(name, trace) == pytest.approx(expected if name == part else 0.0, abs=1e-12), name


def test_host_syncs_are_the_sync_spans_a_frame():
    assert _read("host_syncs_per_frame", _trace(HOST_OPS, [(150.0, 160.0)], frames=2)) == 1.0
    assert _read("host_syncs_per_frame", _trace(HOST_OPS[:3], [(150.0, 160.0)], frames=2)) == 0.0


@pytest.mark.parametrize("seed", range(4))
def test_the_three_parts_add_up_to_idle_pct(seed):
    """Random nested spans on two threads and random gaps: the parts sum to
    what `metrics/idle_pct.py` reads."""
    rng = random.Random(seed)
    host_ops = []
    for thread_start in (0.0, 5000.0):
        t = thread_start
        while t < thread_start + 4000.0:
            d = rng.uniform(50.0, 400.0)
            host_ops.append(("rt.accumulate", t, t + d))
            host_ops.append(("rt.sync.cam_key" if rng.random() < 0.5 else "rt.sched.pass", t + d / 4, t + d / 2))
            host_ops.append(("aten::empty", t + d / 3, t + d / 3 + 1.0))
            t += d + rng.uniform(0.0, 100.0)
    cuts = sorted(rng.uniform(0.0, 10000.0) for _ in range(400))
    gaps = [(a, b) for a, b in zip(cuts[::2], cuts[1::2])]
    trace = _trace(host_ops, gaps, frames=7, window_us=10000.0)
    total = sum(_read(name, trace) for name in PARTS)
    assert abs(total - _read("idle_pct", trace)) <= 1e-9
    assert all(_read(name, trace) > 0.0 for name in PARTS)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("window", ["no_frames", "no_gaps", "no_port_spans"])
def test_a_window_with_nothing_to_attribute_reads_none(name, window):
    """No frames, no gaps, or a program that records no span (the parent of
    the spans) reads None, and never raises."""
    host_ops, gaps, frames = HOST_OPS, [(150.0, 160.0)], 2
    if window == "no_frames":
        frames = 0
    elif window == "no_gaps":
        gaps = []
    else:
        host_ops = [op for op in HOST_OPS if not op[0].startswith(spans.PREFIX)]
    assert _read(name, _trace(host_ops, gaps, frames=frames)) is None


# -- on the card --------------------------------------------------------------

SMALL = {"image_width": 96, "image_height": 64, "max_depth": 50}
TRAFFIC = {"check_pixels": 512, "batch_spp": 4, "hold_frames": [1, 3], "checked_steps": 3}
CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]
# The sync spans of each cell's path: the camera vector's two numbers
# everywhere, the warm cache's key on the PCG streams, the keyed
# backward's read of its sweeps.
CELL_SYNCS = {"keyed_step": {"rt.sync.cam_pack", "rt.sync.arena_total"},
              "final": {"rt.sync.cam_pack", "rt.sync.cam_key"},
              "preview": {"rt.sync.cam_pack", "rt.sync.cam_key"}, "final_jnp": {"rt.sync.cam_pack"}}
FRAMES = 6
BLOCKING_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _blocking(events) -> list:
    """(start ns, runtime call, its copy's name) of every call that blocks
    the host: a synchronize, or a cudaMemcpyAsync whose copy on the device
    (paired by correlation id) is device->host or from pageable memory."""
    copies = {e.correlation_id(): e.name() for e in events
              if e.device_type() == torch.autograd.DeviceType.CUDA and e.name().startswith("Memcpy")}
    out = []
    for e in events:
        name = e.name()
        if name.startswith(BLOCKING_CALLS):
            out.append((e.start_ns(), name, None))
        elif name.startswith("cudaMemcpyAsync"):
            copy = copies.get(e.correlation_id(), "")
            if "DtoH" in copy or ("HtoD" in copy and "Pageable" in copy):
                out.append((e.start_ns(), name, copy))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_every_host_blocking_call_in_a_port_span_is_a_sync_span(card, workload):
    """A few frames of the cell's path (at a small size) under the
    profiler: no device event carries a port span's name, every call that
    blocks the host inside a port span lies in an `rt.sync.*` span (the
    innermost port span at its start), each sync span holds one, and the
    cell makes the sync spans it is known to make. Then a traced window of
    the harness: the four readers read, and the idle parts add up to
    `idle_pct`."""
    from torch.profiler import ProfilerActivity, profile

    spp = 4 if workload.endswith("keyed_step") else 8
    cell = harness.Cell(workload, config=dict(SMALL, samples_per_pixel=spp), traffic=TRAFFIC)
    driver = cell.driver_class()(cell, 2**31 + 5, card)
    driver.setup()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(FRAMES):
            driver.frame()
        torch.cuda.synchronize(card)
    events = prof.profiler.kineto_results.events()
    device_spans = [e.name() for e in events
                    if e.device_type() == torch.autograd.DeviceType.CUDA and e.name().startswith(spans.PREFIX)]
    assert not device_spans, device_spans
    port = [(e.name(), e.start_ns(), e.end_ns()) for e in events
            if e.device_type() != torch.autograd.DeviceType.CUDA and e.name().startswith(spans.PREFIX)]
    host = [(e.name(), e.start_ns(), e.end_ns()) for e in events
            if e.device_type() != torch.autograd.DeviceType.CUDA and not e.name().startswith((spans.PREFIX, "cuda"))]
    blocking = _blocking(events)
    unspanned = []
    for t, call, copy in blocking:
        running = [op for op in port if op[1] <= t < op[2]]
        if running:
            inner = min(running, key=lambda op: op[2] - op[1])[0]
            if not inner.startswith(spans.SYNC_PREFIX):
                # The PyTorch operation that made the call names its site.
                made = [op for op in host if op[1] <= t < op[2]]
                unspanned.append((inner, min(made, key=lambda op: op[2] - op[1])[0] if made else None, call, copy))
    assert not unspanned, sorted(set(unspanned))
    syncs = [op for op in port if op[0].startswith(spans.SYNC_PREFIX)]
    assert {op[0] for op in syncs} == CELL_SYNCS[cell.entry["traffic"]]
    assert all(any(s <= t < e for t, _, _ in blocking) for _, s, e in syncs), syncs

    driver.recording = True
    window = harness.traced_window(driver, 0.5, card)
    window.update(driver.trace_counts(window["frames"]))
    values = {name: _read(name, window) for name in (*READERS, "idle_pct")}
    assert all(values[name] is not None for name in READERS), values
    assert abs(sum(values[name] for name in PARTS) - values["idle_pct"]) <= 0.01, values
