"""The keyed train step's recording forward and per-path reverse, in their
plain versions on the CPU, against the replay's layout and against JAX.

On the card the keyed step's forward (`threefry_record_kernel`) writes the
image, the work map and one record a sweep into an arena in the order the
sweeps are made, each linked to its path's previous record, with each
path's sweeps and last record in two tables; the reverse kernel's threads
walk a path at a time along the links and write each event where
`build.path_slots` puts it. Their plain versions
(`ops/cuda_threefry.record_plain`, `reverse_paths_plain`) are what
`record_keyed` and `keyed_grad_pass` run on a CPU scene. Here they are held
to `render_flat_threefry` (the image and work map, bit for bit), to the
replay's logical order (`replay_records_plain`, `reverse_records_plain`,
bit for bit, for arenas in any order) and, reduced in the kernel's order,
to JAX's `render_grads` (parallel/dist.py:244) on a one-device mesh under
tests/test_torch_keyed_grad.py's bounds. The kernels themselves are tested
on the card (tests/test_torch_cuda.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

# The keyed gradient's module-scoped JAX fixtures and helpers.
from test_torch_keyed_grad import (  # noqa: F401
    COVER0_SQUARED_ERROR_BOUNDS,
    FIELDS,
    _check_grads,
    jax_camera_to_port,
    jax_grads,
    worlds,
)
from test_torch_jnp_render import GRAD_BOUNDS

from ray_tracing_in_one_weekend_tpu_torch.kernels import build
from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_threefry as ct
from ray_tracing_in_one_weekend_tpu_torch.ops import render as port_render
from ray_tracing_in_one_weekend_tpu_torch.ops.integrator import _END_NONE, _REC_DEPTH, _REC_END

torch.set_num_threads(2)

KEY = 5


@pytest.fixture(scope="module")
def subset():
    """cover_scene(0) at 16x8, spp 2, depth 6; a shuffled subset of its
    pixels; their recording; the replay's records and a cotangent."""
    sc = scene_lib.cover_scene(0, device="cpu")
    cam = jax_camera_to_port(image_width=16, samples_per_pixel=2, max_depth=6)
    pix = torch.arange(10, 90, 3)
    pix = pix[torch.randperm(pix.numel(), generator=torch.Generator().manual_seed(0))]
    _, _, rec = ct.record_plain(sc, cam, pix, KEY)
    replay = ct.replay_records_plain(sc, cam, pix, KEY)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal((3, pix.numel()), dtype=np.float32))
    return sc, cam, rec, replay, g


def _reordered(rec, order: str):
    """The recording with its arena in another order and its links and
    path_last rewritten: as made, reversed, or a seeded permutation; or as
    made with rows of random words after the last record, as the kernel's
    arena has room past its sweeps."""
    n = rec.arena.shape[0]
    if order == "made":
        return rec
    if order == "padded":
        junk = torch.from_numpy(np.random.default_rng(9).integers(-(1 << 31), 1 << 31, (n // 2, 16), dtype=np.int32))
        return dataclasses.replace(rec, arena=torch.cat([rec.arena, junk.view(torch.float32)]))
    perm = (torch.arange(n - 1, -1, -1) if order == "reversed"
            else torch.from_numpy(np.random.default_rng(7).permutation(n)))
    new_of = torch.empty_like(perm)
    new_of[perm] = torch.arange(n)  # old index -> new index
    arena = rec.arena[perm].clone()
    links = arena.view(torch.int64)[:, 7]
    first = links < 0
    links[~first] = new_of[links[~first]]
    return dataclasses.replace(rec, arena=arena, path_last=new_of[rec.path_last])


def _slots(rec, n_live):
    slots, n_events = build.path_slots(rec.pix, rec.path_count, rec.spp, 0, n_live)
    return slots, int(n_events)


@pytest.mark.parametrize("name", ["three", "cover0"])
def test_record_plain_is_the_forward(name):
    """`record_plain`'s image and work map are `render_flat_threefry`'s bits
    (spp 3, depth 5, all pixels at 16x8); each path's sweeps sum to its
    pixel's work; the arena holds every sweep once; each path's chain of
    links from its last record is as long as its count, its bounce indices
    count down to 0, its first record links to -1, only its last ends it."""
    sc = (scene_lib.three_sphere_scene(pad_to=128, device="cpu") if name == "three"
          else scene_lib.cover_scene(0, device="cpu"))
    cam = jax_camera_to_port(image_width=16, samples_per_pixel=3, max_depth=5)
    pix = torch.arange(cam.num_pixels)
    colors, work, rec = ct.record_plain(sc, cam, pix, KEY)
    want, want_work = port_render.render_flat_threefry(sc, cam, pix, KEY, return_work=True)
    assert torch.equal(colors, want) and torch.equal(work, want_work)
    assert torch.equal(rec.path_count.reshape(-1, 3).sum(1).to(torch.int32), work)
    assert int(rec.total) == rec.capacity == int(work.sum())
    words, links = rec.arena.view(torch.int32), rec.arena.view(torch.int64)[:, 7]
    seen = torch.zeros(rec.capacity, dtype=torch.int64)
    for k in range(rec.path_count.numel()):
        at = int(rec.path_last[k])
        for d in range(int(rec.path_count[k]) - 1, -1, -1):
            seen[at] += 1
            assert int(words[at, _REC_DEPTH]) == d
            assert (int(words[at, _REC_END]) != _END_NONE) == (d == int(rec.path_count[k]) - 1)
            at = int(links[at])
        assert at == -1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("order", ["made", "reversed", "permuted", "padded"])
def test_records_in_logical_order_are_the_replay(subset, order):
    """A recording put in logical order by its links and `path_slots` gives
    `replay_records_plain`'s records, words 0-13 bit for bit, for the arena
    as made, reversed, permuted with its links rewritten, and with rows of
    junk past its records."""
    sc, cam, rec, replay, _ = subset
    rec = _reordered(rec, order)
    slots, n_events = _slots(rec, cam.num_pixels)
    assert n_events == replay.records.shape[0]
    got = ct.records_in_logical_order(rec, slots, n_events)
    assert torch.equal(got.view(torch.int32)[:, :14], replay.records.view(torch.int32)[:, :14])


@pytest.mark.parametrize("order", ["made", "permuted", "padded"])
def test_per_path_reverse_is_the_plain_reverse(subset, order):
    """`reverse_paths_plain` on the recording (arena as made, shuffled with
    its links rewritten, or with rows of junk past its records) writes
    `reverse_records_plain`'s events on the replay's records, bit for bit,
    in the same slots."""
    sc, cam, rec, replay, g = subset
    rec = _reordered(rec, order)
    slots, n_events = _slots(rec, cam.num_pixels)
    p_mat, cam_vec = cr.pack_scene(sc), cr.pack_camera(cam)
    got = ct.reverse_paths_plain(p_mat, cam_vec, rec, slots, n_events, g)
    want = ct.reverse_records_plain(p_mat, cam_vec, replay, g)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert int((got.view(torch.int32)[:, 0] >= 0).sum()) > 0


@pytest.mark.parametrize("name", ["three", "cover0"])
def test_keyed_grad_pass_matches_jax(worlds, jax_grads, name):
    """The keyed step through the wrappers' CPU route, `record_keyed` then
    `keyed_grad_pass` (the plain per-path reverse and the ordered
    reduction), taken through `pack_scene`, against JAX's `render_grads` on
    a one-device mesh (key 0, random target, 16x8, spp 2, depth 4): the
    loss within 1e-5 relative, each field within
    tests/test_torch_keyed_grad.py's bounds (GRAD_BOUNDS; on cover_scene(0)
    COVER0_SQUARED_ERROR_BOUNDS). No kernel is launched."""
    scenes_, (_, tc), target = worlds
    _, ts = scenes_[name]
    loss_j, grads_j = jax_grads[name]
    build.reset_launches()
    n = tc.num_pixels
    img, _, rec = ct.record_keyed(ts, tc, torch.arange(n), 0)
    diff = img - torch.from_numpy(target).reshape(-1, 3)
    loss = torch.mean(diff ** 2)
    assert abs(float(loss) - loss_j) <= 1e-5 * abs(loss_j)
    g = (2.0 * diff / diff.numel()).T / tc.samples_per_pixel
    grads = cg.params_vjp(ts, ct.keyed_grad_pass(rec, g, 0, n))
    _check_grads(grads, grads_j, COVER0_SQUARED_ERROR_BOUNDS if name == "cover0" else GRAD_BOUNDS)
    assert sum(build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_path_slots_are_event_slots_plus_earlier_samples(seed):
    """`path_slots` for pixel ids in any order, pads among them (ids below
    pixel_offset or at or past n_live): each live path's first slot is
    `event_slots`' ev_start of its position plus the sweeps of the pixel's
    earlier samples, pads own none (-1), and the events' count is the live
    sweeps' sum."""
    rng = np.random.default_rng(seed)
    spp, pixel_offset, n_live = 4, 20, 70
    pix = torch.from_numpy(rng.permutation(np.arange(10, 80))[:50].astype(np.int32))
    counts = torch.from_numpy(rng.integers(1, 9, size=(50, spp)).astype(np.int32))
    slots, n_events = build.path_slots(pix, counts.reshape(-1), spp, pixel_offset, n_live)
    local = pix.to(torch.int64) - pixel_offset
    live = (local >= 0) & (pix < n_live)
    work = torch.zeros(n_live - pixel_offset, dtype=torch.int64)
    work[local[live]] = counts[live].sum(1).to(torch.int64)
    ev_start, ev_count = build.event_slots(pix, work, pixel_offset, n_live)
    earlier = torch.cumsum(counts.to(torch.int64), 1) - counts
    want = torch.where(live[:, None], ev_start[:, None] + earlier, -1).reshape(-1)
    assert torch.equal(slots, want)
    assert int(n_events) == int(ev_count.sum()) == int(counts[live].sum())
    assert bool(live.any()) and bool((~live).any())


def test_keyed_grad_pass_skips_pad_positions(subset):
    """Positions whose ids lie outside [pixel_offset, n_live) add nothing:
    the gradient of a recording over a subset with pads is the bits of the
    recording over the live ids alone."""
    sc, cam, _, _, _ = subset
    pix = torch.tensor([40, 3, 41, 60, 42, 90, 43])  # live: 40-43 in [40, 44)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal((3, pix.numel()), dtype=np.float32))
    _, _, rec = ct.record_keyed(sc, cam, pix, KEY)
    live = (pix >= 40) & (pix < 44)
    _, _, rec_live = ct.record_keyed(sc, cam, pix[live], KEY)
    got = ct.keyed_grad_pass(rec, g, 40, 44)
    want = ct.keyed_grad_pass(rec_live, g[:, live].contiguous(), 40, 44)
    assert torch.equal(got, want)
    assert float(got.abs().sum()) > 0.0
