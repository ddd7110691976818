"""The port's spans (utils/spans.py) on the CPU: nothing recorded while no
profiler runs, and under torch.profiler each layer's span around the
layers it calls, every name in `SPANS`, and the host syncs of a frame or
step counted by their `rt.sync.*` spans.

The counts are the CPU route's, where a sync span marks a copy between
host and host. On the card a keyed step records its paths through the
kernel, whose camera vector adds the two `rt.sync.cam_pack` copies, and
reads the sweeps made (`rt.sync.arena_total`), where the CPU's backward
re-renders under autograd; a jnp frame packs the camera too (two).
"""

from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ray_tracing_in_one_weekend_tpu_torch.models.camera import make_camera
from ray_tracing_in_one_weekend_tpu_torch.models.scene import single_sphere_scene
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_threefry import keyed_grad_pass, record_keyed
from ray_tracing_in_one_weekend_tpu_torch.ops.image import to_uint8
from ray_tracing_in_one_weekend_tpu_torch.parallel import dist
from ray_tracing_in_one_weekend_tpu_torch.utils import checkpoint as ckpt
from ray_tracing_in_one_weekend_tpu_torch.utils import spans

torch.set_num_threads(2)


def _world():
    scene = single_sphere_scene(pad_to=128, device="cpu")
    cam = make_camera(image_width=16, aspect_ratio=2.0, samples_per_pixel=2, max_depth=3, device="cpu")
    return scene, cam


def _pcg_frame(tmp_path):
    """A preview frame: one accumulate call on PCG streams (cold: two
    passes, a compaction, the cache's fill) and its 8-bit image."""
    scene, cam = _world()
    cr._WORK_CACHE.clear()
    to_uint8(ckpt.accumulate(ckpt.new_state(cam, device="cpu"), scene, cam, 3, 2).image)


def _jnp_frame(tmp_path):
    scene, cam = _world()
    ckpt.accumulate(ckpt.new_state(cam, device="cpu"), scene, cam, 3, 2, backend="jnp")


def _keyed_step(tmp_path):
    scene, cam = _world()
    target = torch.zeros(cam.image_height, cam.image_width, 3)
    dist.train_step(dist.scene_params(scene), scene, cam, target, 0)


def _keyed_kernels(tmp_path):
    """The keyed backward's two halves, by their plain versions."""
    scene, cam = _world()
    pix = torch.arange(cam.num_pixels)
    _, _, rec = record_keyed(scene, cam, pix, 0)
    keyed_grad_pass(rec, torch.ones(3, pix.numel()), 0, cam.num_pixels)


def _save(tmp_path):
    _, cam = _world()
    ckpt.save(ckpt.new_state(cam, device="cpu"), str(tmp_path / "state.npz"))


# case: (what it runs, the spans it emits with their counts, (outer, inner)
# pairs where each inner span lies inside an outer one on its thread).
CASES = {
    "pcg_frame": (_pcg_frame,
                  {"rt.accumulate": 1, "rt.sched.render": 1, "rt.sync.cam_pack": 2, "rt.sync.cam_key": 1,
                   "rt.sched.pass": 2, "rt.sched.compact": 1, "rt.sched.cache_fill": 1, "rt.to_uint8": 1},
                  [("rt.accumulate", "rt.sched.render"), ("rt.sched.render", "rt.sched.pass"),
                   ("rt.sched.render", "rt.sched.compact"), ("rt.sched.render", "rt.sync.cam_pack"),
                   ("rt.sched.render", "rt.sync.cam_key"), ("rt.sched.render", "rt.sched.cache_fill")]),
    "jnp_frame": (_jnp_frame, {"rt.accumulate": 1, "rt.keyed.render": 1},
                  [("rt.accumulate", "rt.keyed.render")]),
    "keyed_step": (_keyed_step, {"rt.train_step": 1, "rt.keyed.forward": 1, "rt.keyed.backward": 1},
                   [("rt.train_step", "rt.keyed.forward"), ("rt.train_step", "rt.keyed.backward")]),
    "keyed_kernels": (_keyed_kernels, {"rt.keyed.record": 1, "rt.sync.cam_pack": 2, "rt.keyed.grad_pass": 1},
                      [("rt.keyed.record", "rt.sync.cam_pack")]),
    "checkpoint_save": (_save, {"rt.sync.checkpoint_save": 1}, []),
}


def _profiled(fn, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(tmp_path)
    # The raw records: `prof.events()` builds a tree of every operation,
    # seconds on the plain keyed backward.
    return [(e.name(), e.start_thread_id(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events() if e.name().startswith("rt.")]


def test_span_names_are_distinct_and_prefixed():
    assert len(set(spans.SPANS)) == len(spans.SPANS)
    assert all(name.startswith("rt.") for name in spans.SPANS)
    covered = set().union(*(counts for _, counts, _ in CASES.values()))
    # Each span a CPU run can reach is reached by a case; the rest record
    # device syncs (the PCG replay's, a mesh collective's, the keyed
    # backward's read of its sweeps).
    assert set(spans.SPANS) - covered == {spans.SYNC_PREFIX + s for s in
                                          ("arena_total", "replay_work", "replay_events", "replay_flags", "mesh")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_record_nothing_while_no_profiler_runs(case, tmp_path, monkeypatch):
    """With the profiler off no span makes a record: the record function is
    replaced by one that raises, and the frame or step runs all the same."""
    assert not torch.autograd.profiler._is_profiler_enabled

    def refuse(name):
        raise AssertionError(f"a record of {name!r} was made with no profiler running")

    monkeypatch.setattr(spans, "_RecordFunctionFast", refuse)
    assert spans.span("rt.accumulate") is spans._OFF and spans.sync("cam_key") is spans._OFF
    CASES[case][0](tmp_path)


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_nest_as_the_layers_do(case, tmp_path):
    """Under torch.profiler on the CPU each case emits exactly its spans,
    every name in SPANS, and each inner span inside its outer one. Its
    host syncs are its `rt.sync.*` spans: three a PCG frame (the camera
    vector's two numbers and the warm cache's key), none a jnp frame or a
    keyed step on the CPU (the plain routes pack no camera), two a keyed
    recording, one a checkpoint's save."""
    fn, counts, nested = CASES[case]
    events = _profiled(fn, tmp_path)
    names = Counter(name for name, *_ in events)
    assert set(names) <= set(spans.SPANS), set(names) - set(spans.SPANS)
    assert dict(names) == counts
    for outer, inner in nested:
        for name, thread, start, end in events:
            if name == inner:
                assert any(o == outer and t == thread and s <= start and end <= e for o, t, s, e in events), \
                    (outer, inner)
