"""The jnp backend's forward: the hand-written kernel and its plain version.

The JAX package's jnp path (ops/render.py::render_image ->
ops/integrator.py::trace_rays, XLA-fused, no Pallas kernel) on the
port's threefry keys. `render_kernel_pixels` renders any flat batch of
global pixel ids of a CUDA scene by `csrc/threefry_render_kernel.cu`
through `kernels.build.threefry_render`, which raises if it cannot: a
persistent grid whose threads take the pixels from a queue counter on the
card, one pixel at a time, and sweep the scene in groups of tests with
one sign test a group (see the kernel's source note). A pixel's value and
its count of sweeps depend only on its global id, so any order of
`pixel_indices` gives the same bits. The kernel's plain version is
`ops/render.render_flat_threefry` (its `return_work` counts the sweeps as
the kernel does); `ops/render.render_keyed` chooses between the two by the
scene's device, with no fallback from one to the other.

The kernel and the plain version compute the same operations in the same
order (the fused multiply-adds the plain version computes exactly), so on
the card they agree bit for bit where the render kernel and its plain
version do; against the JAX package on the CPU they agree to float32
rounding per bounce (tests/test_torch_jnp_render.py holds the gates).

The keyed train step, the counterpart of `jax.grad` of the jnp path (JAX
parallel/dist.py:225-282), is `record_keyed` then `keyed_grad_pass`: on
CUDA tensors `csrc/threefry_grad_kernel.cu` through
`kernels.build.threefry_record` (the forward, which also records every
sweep of its paths into an arena in the order it makes them, each record
linked to its path's previous one) and `kernels.build.threefry_grad_pass`
(`threefry_reverse_kernel` walks each path back along the links by the
keyed bounce adjoint and writes its events where `build.path_slots` puts
them, then the PCG backward's fixed-order reduction sums them into the
[16, N] cotangent of the packed scene). Their plain versions are here, on
the CPU the wrappers' own route: `record_plain` (`render_flat_threefry`'s
image and work map, whose `trace_rays_threefry` returns one record a
sweep, and the arena, links and path tables), `reverse_paths_plain`
(torch.autograd of `_keyed_bounce`, the plain keyed bounce, and of the
sky, walked from each path's end along the links) and the ordered
reduction. `replay_records_plain` and `reverse_records_plain` keep the
records and events in their logical order (pixel id, sample, bounce):
`records_in_logical_order` puts an arena in that order.
`parallel/dist.py`'s CPU path differentiates the plain render itself.
"""

from __future__ import annotations

import torch

from ray_tracing_in_one_weekend_tpu_torch.models.camera import Camera
from ray_tracing_in_one_weekend_tpu_torch.models.scene import Scene
from ray_tracing_in_one_weekend_tpu_torch.ops import intersect, sampling
from ray_tracing_in_one_weekend_tpu_torch.ops import vecmath as vm
from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_grad import (
    _EVENT_ROWS,
    _path_positions,
    _reduce_events_ordered,
)
from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_render import _u32, pack_camera, pack_scene
from ray_tracing_in_one_weekend_tpu_torch.ops.integrator import (
    _END_SKY,
    _REC_DEPTH,
    _REC_END,
    _REC_K0,
    _REC_K1,
    _REC_WINNER,
    sky_color,
)
from ray_tracing_in_one_weekend_tpu_torch.ops.materials import scatter_sampled
from ray_tracing_in_one_weekend_tpu_torch.ops.threefry import as_key
from ray_tracing_in_one_weekend_tpu_torch.utils.spans import spanned


def render_kernel_pixels(scene: Scene, cam: Camera, pixel_indices, base_key=0, spp: int | None = None,
                         sample_offset: int = 0, return_work: bool = False):
    """The kernel on a CUDA scene -> [R, 3] (and, with `return_work`, the
    [R] sweeps each pixel ran). Raises for a scene on another device."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    spp = cam.samples_per_pixel if spp is None else spp
    pix = torch.as_tensor(pixel_indices, device=scene.device).reshape(-1).to(torch.int32).contiguous()
    return build.threefry_render(
        pack_scene(scene).T.contiguous(), pack_camera(cam).to(scene.device), pix, as_key(base_key),
        sample_offset, spp, cam.max_depth, work=return_work,
    )



# ---------------------------------------------------------------------------
# The keyed backward: the kernels' chain and their plain versions.
# ---------------------------------------------------------------------------

# Pixels a vectorized step of the plain replay (bounds its [pixels, N]
# sweep), and records a vector-Jacobian product of the plain reverse.
_PLAIN_PIXELS = {"cuda": 1 << 14, "cpu": 1 << 10}
_PLAIN_RECORDS = {"cuda": 1 << 20, "cpu": 1 << 16}


@spanned("rt.keyed.record")
def record_keyed(scene: Scene, cam: Camera, pix, base_key=0, spp: int | None = None, sample_offset: int = 0,
                 p_mat: torch.Tensor | None = None):
    """The keyed forward that records its paths -> (colors [n, 3], work [n]
    int32, `build.Recording`) for the distinct global pixel ids `pix`: on a
    CUDA scene `build.threefry_record` (which raises if it cannot build or
    launch; the colors are `render_kernel_pixels`' bits), on a CPU scene
    `record_plain`. `p_mat`: `pack_scene(scene)` where the caller has it."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    spp = cam.samples_per_pixel if spp is None else spp
    if scene.device.type != "cuda":
        return record_plain(scene, cam, pix, base_key, sample_offset, spp)
    table = (pack_scene(scene) if p_mat is None else p_mat.detach()).T.contiguous()
    pix = torch.as_tensor(pix, device=scene.device).reshape(-1).to(torch.int32).contiguous()
    return build.threefry_record(table, pack_camera(cam).to(scene.device), pix, as_key(base_key), sample_offset,
                                 spp, cam.max_depth)


@spanned("rt.keyed.grad_pass")
def keyed_grad_pass(rec, g, pixel_offset: int, n_live: int) -> torch.Tensor:
    """The keyed backward of a recording (`record_keyed`) -> [16, N] f32, the
    cotangent of the packed scene, for `g` [3, n] each position's radiance
    cotangent of one sample; ids of `rec.pix` outside [pixel_offset, n_live)
    add nothing. On CUDA tensors `build.threefry_grad_pass` (the reverse
    kernel and the reduction; it raises if a kernel cannot build or
    launch); on the CPU `reverse_paths_plain` and the ordered reduction."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    g = g.contiguous()
    if rec.arena.device.type == "cuda":
        return build.threefry_grad_pass(rec, g, pixel_offset, n_live)
    slots, n_events = build.path_slots(rec.pix, rec.path_count, rec.spp, pixel_offset, n_live)
    events = reverse_paths_plain(rec.table.T, rec.cam_vec, rec, slots, int(n_events), g)
    return _reduce_events_ordered(events, rec.table.shape[0])


def record_plain(scene: Scene, cam: Camera, pix, base_key=0, sample_offset: int = 0, spp: int | None = None):
    """The recording forward in plain PyTorch -> (colors [n, 3], work [n]
    int32, `build.Recording`), the layout of `build.threefry_record`:
    `render_flat_threefry`'s image and work map (its bits), and its
    records in the order it makes them (chunk, sample, bounce), each linked
    to its path's previous one, with the path tables. The arena holds
    exactly the sweeps made."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops.render import render_flat_threefry

    spp = cam.samples_per_pixel if spp is None else spp
    dev = scene.device
    pix = torch.as_tensor(pix, device=dev).reshape(-1).to(torch.int32)
    chunk = _PLAIN_PIXELS.get(dev.type, _PLAIN_PIXELS["cpu"])
    colors, work, parts = render_flat_threefry(scene, cam, pix, base_key, chunk_size=chunk, spp=spp,
                                               sample_offset=sample_offset, return_work=True,
                                               return_records=True)
    arena = torch.empty(sum(rows.shape[0] for *_, rows in parts), 16, dtype=torch.float32, device=dev)
    path_count = torch.zeros(pix.numel() * spp, dtype=torch.int32, device=dev)
    path_last = torch.full((pix.numel() * spp,), -1, dtype=torch.int64, device=dev)  # each path's latest
    at = 0
    for lanes, s, depth, rows in parts:  # moved as int32, so every word keeps its bits
        k = lanes * spp + s
        idx = torch.arange(at, at + rows.shape[0], device=dev)
        arena.view(torch.int32)[idx] = rows.view(torch.int32)
        arena.view(torch.int64)[idx, 7] = path_last[k]  # words 14-15: the link
        path_last[k] = idx
        path_count[k] = depth + 1
        at += rows.shape[0]
    rec = build.Recording(arena, torch.tensor([at], dtype=torch.int64, device=dev), path_count, path_last, pix,
                          pack_scene(scene).T.contiguous(), pack_camera(cam).to(dev), as_key(base_key),
                          sample_offset, spp, cam.max_depth)
    return colors, work, rec


def records_in_logical_order(rec, slots, n_events: int) -> torch.Tensor:
    """A recording's records in their logical order -> [n_events, 16] f32:
    the record of bounce d of path k at slots[k] + d (`build.path_slots`),
    found by walking each path's links from its last record; pad paths
    (slots -1) are left out. Every word keeps its bits."""
    dev = rec.arena.device
    words, links = rec.arena.view(torch.int32), rec.arena.view(torch.int64)[:, 7]
    counts = rec.path_count.to(torch.int64)
    out = torch.zeros(n_events, 16, dtype=torch.float32, device=dev)
    sel = ((slots >= 0) & (counts > 0)).nonzero()[:, 0]
    at = rec.path_last[sel]
    r = 0
    while sel.numel():
        out.view(torch.int32)[slots[sel] + counts[sel] - 1 - r] = words[at]
        at = links[at]
        r += 1
        keep = counts[sel] > r
        sel, at = sel[keep], at[keep]
    return out


def replay_records_plain(scene: Scene, cam: Camera, pix, base_key=0, sample_offset: int = 0,
                         spp: int | None = None, pixel_offset: int = 0, n_live: int | None = None):
    """The keyed paths' records in their logical order, in plain PyTorch ->
    `build.Replay` (words 0-13 as `build.Recording` describes them, 14-15
    zero): each pixel's sweeps in sample and bounce order, in slots that
    follow the pixel ids (`build.event_slots`), where
    `records_in_logical_order` puts the recording forward's arena and the
    reverse kernel writes the events. `pix` [n] distinct
    global pixel ids in [pixel_offset, n_live) (default: the image). The
    records are `render_flat_threefry`'s (its keys, camera rays and
    `trace_rays_threefry`'s bounces); the slots come from this replay's own
    sweep counts, so they can be held against the forward's work map."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops.render import render_flat_threefry

    spp = cam.samples_per_pixel if spp is None else spp
    n_live = cam.num_pixels if n_live is None else n_live
    dev = scene.device
    pix = torch.as_tensor(pix, device=dev).reshape(-1).to(torch.int64)
    chunk = _PLAIN_PIXELS.get(dev.type, _PLAIN_PIXELS["cpu"])
    _, parts = render_flat_threefry(scene, cam, pix, base_key, chunk_size=chunk, spp=spp,
                                    sample_offset=sample_offset, return_records=True)
    per_sample = torch.zeros(pix.numel(), spp, dtype=torch.int64, device=dev)
    for lanes, s, _, _ in parts:
        per_sample[lanes, s] += 1
    work = torch.zeros(n_live - pixel_offset, dtype=torch.int64, device=dev)
    work[pix - pixel_offset] = per_sample.sum(1)
    ev_start, ev_count = build.event_slots(pix, work, pixel_offset, n_live)
    earlier = torch.cumsum(per_sample, 1) - per_sample  # sweeps of a pixel's earlier samples
    records = torch.empty(int(work.sum()), 16, dtype=torch.float32, device=dev)
    for lanes, s, depth, rows in parts:  # moved as int32, so every word keeps its bits
        records.view(torch.int32)[ev_start[lanes] + earlier[lanes, s] + depth] = rows.view(torch.int32)
    return build.Replay(records, ev_start, ev_count)


def _keyed_bounce(o, d, att, pc, keys, depth, t_min):
    """One keyed bounce off the winner as a pure function of its continuous
    inputs -> (o', d', att'): `pc` [L, 16] the winner's packed parameter
    rows; the hit point and the outward normal as `intersect.hit_scene`
    takes them (its t recomputed by `intersect._winner_t`, the sweep's
    bits), then `scatter_sampled` on the bounce's draws
    (uniforms_b(keys, 5, domain=depth)) and the attenuation. The decisions
    (root, front face, material, must_reflect) come from the same values as
    in the forward, so they are its own."""
    center, radius = pc[:, 0:3], pc[:, 3]
    t = intersect._winner_t(center, radius, o, d, t_min, intersect.T_MISS)
    point = vm.ray_at(o, d, t)
    outward = (point - center) / radius[:, None]
    front_face = vm.dot_fma(d, outward) < 0.0
    rec = intersect.HitRecord(
        hit=torch.ones_like(front_face), t=t, point=point,
        normal=torch.where(front_face[:, None], outward, -outward), front_face=front_face,
        sphere_index=torch.zeros_like(front_face, dtype=torch.int64), albedo=pc[:, 5:8], fuzz=pc[:, 8],
        ior=pc[:, 9], mat_type=pc[:, 10].detach().round().to(torch.int32),
    )
    u = sampling.uniforms_b(keys, 5, domain=depth)
    new_dir, mat_att, _ = scatter_sampled(rec, d, sampling.unit_vector_from_uniforms(u[:, 0:4]), u[:, 4])
    return point, new_dir, att * mat_att


def _vjp(fn, inputs, cotangents):
    """The cotangents of `inputs` of `fn(*inputs)` by torch.autograd."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in inputs]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        bars = torch.autograd.grad(outs, leaves, grad_outputs=cotangents, allow_unused=True)
    return [torch.zeros_like(x) if b is None else b for x, b in zip(leaves, bars)]


def reverse_records_plain(p_mat, cam_vec, replay, g) -> torch.Tensor:
    """The keyed reverse in plain PyTorch: records -> events [E, 16] f32, the
    layout of `build.threefry_reverse` (a new tensor; the records stay).
    `p_mat` [16, N] the packed scene, `g` [3, n] each position's radiance
    cotangent of one sample.

    Paths are independent once the adjoints restart at each path's last
    bounce, so this walks all paths at once, step r taking the bounce r
    places before each path's end: at a path that reached the sky the
    adjoint of att * sky_color(d), then each earlier bounce's
    vector-Jacobian product of `_keyed_bounce`, from torch.autograd."""
    records, ev_start, ev_count = replay.records, replay.ev_start, replay.ev_count
    t_min = float(cam_vec[20])
    dev = records.device
    n = records.shape[0]
    words = records.view(torch.int32)
    events = torch.zeros(n, 16, dtype=torch.float32, device=dev)
    events.view(torch.int32)[:, 0] = -1
    if n == 0:
        return events
    counts = ev_count.to(torch.int64)
    lane_of = torch.repeat_interleave(torch.arange(counts.numel(), device=dev), counts)
    first = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    slot_lane = torch.empty(n, dtype=torch.int64, device=dev)
    slot_lane[ev_start[lane_of] + torch.arange(n, device=dev) - first] = lane_of
    ends, path, back = _path_positions(records)
    lit = words[ends[path], _REC_END] == _END_SKY  # the slot's path reached the sky
    bars = torch.zeros(3, ends.numel(), 3, dtype=torch.float32, device=dev)  # o, d, att adjoints a path

    chunk = _PLAIN_RECORDS.get(dev.type, _PLAIN_RECORDS["cpu"])
    for r in range(int(back.max()) + 1):
        for sel in ((back == r) & lit).nonzero()[:, 0].split(chunk):
            if r == 0:  # the path's last bounce: the sky's adjoint
                db, ab = _vjp(lambda d, att: att * sky_color(d), (records[sel, 3:6], records[sel, 6:9]),
                              (g[:, slot_lane[sel]].T.contiguous(),))
                bars[1, path[sel]], bars[2, path[sel]] = db, ab
                continue
            winner = words[sel, _REC_WINNER].to(torch.int64)
            keys = (_u32(words[sel, _REC_K0]), _u32(words[sel, _REC_K1]))
            depth = words[sel, _REC_DEPTH].to(torch.int64)
            cot = tuple(bars[i, path[sel]] for i in range(3))
            ob, db, ab, pb = _vjp(lambda o, d, att, pc: _keyed_bounce(o, d, att, pc, keys, depth, t_min),
                                  (records[sel, 0:3], records[sel, 3:6], records[sel, 6:9], p_mat[:, winner].T),
                                  cot)
            bars[0, path[sel]], bars[1, path[sel]], bars[2, path[sel]] = ob, db, ab
            events.view(torch.int32)[sel, 0] = winner.to(torch.int32)
            events[sel, 1:14] = pb[:, list(_EVENT_ROWS)]
    return events


def reverse_paths_plain(p_mat, cam_vec, rec, slots, n_events: int, g) -> torch.Tensor:
    """The keyed reverse kernel in plain PyTorch, a path at a time: a
    recording (`record_plain` or `build.threefry_record`, its arena in any
    order) -> events [n_events, 16] f32, the layout of
    `build.threefry_reverse`, the event of bounce d of path k at slots[k] +
    d (`build.path_slots`). `p_mat` [16, N] the packed scene, `g` [3, n]
    each position's radiance cotangent of one sample.

    Step r takes the record r places before each path's end, found along
    the links, for the paths that reached the sky: at r = 0 the adjoint of
    att * sky_color(d), then each earlier bounce's vector-Jacobian product
    of `_keyed_bounce`, from torch.autograd. The paths go in the order of
    their slots, so each step's batches are `reverse_records_plain`'s and
    the events its bits."""
    t_min = float(cam_vec[20])
    dev = rec.arena.device
    words, links = rec.arena.view(torch.int32), rec.arena.view(torch.int64)[:, 7]
    counts = rec.path_count.to(torch.int64)
    events = torch.zeros(n_events, 16, dtype=torch.float32, device=dev)
    events.view(torch.int32)[:, 0] = -1
    paths = ((slots >= 0) & (counts > 0)).nonzero()[:, 0]
    paths = paths[torch.argsort(slots[paths])]
    paths = paths[words[rec.path_last[paths], _REC_END] == _END_SKY]  # the paths that reached the sky
    at = rec.path_last[paths]
    bars = torch.zeros(3, paths.numel(), 3, dtype=torch.float32, device=dev)  # o, d, att adjoints a path
    chunk = _PLAIN_RECORDS.get(dev.type, _PLAIN_RECORDS["cpu"])
    live = torch.arange(paths.numel(), device=dev)  # the paths still walked, as indices into `paths`
    r = 0
    while live.numel():
        for part in live.split(chunk):
            rows = rec.arena[at[part]]
            o, d, att = (rows[:, a : a + 3].contiguous() for a in (0, 3, 6))  # as the plain reverse slices them
            if r == 0:  # the path's last bounce: the sky's adjoint
                db, ab = _vjp(lambda d, att: att * sky_color(d), (d, att),
                              (g[:, paths[part] // rec.spp].T.contiguous(),))
                bars[1, part], bars[2, part] = db, ab
                continue
            rw = rows.view(torch.int32)
            winner = rw[:, _REC_WINNER].to(torch.int64)
            keys = (_u32(rw[:, _REC_K0]), _u32(rw[:, _REC_K1]))
            depth = rw[:, _REC_DEPTH].to(torch.int64)
            cot = tuple(bars[i, part] for i in range(3))
            ob, db, ab, pb = _vjp(lambda o, d, att, pc: _keyed_bounce(o, d, att, pc, keys, depth, t_min),
                                  (o, d, att, p_mat[:, winner].T), cot)
            bars[0, part], bars[1, part], bars[2, part] = ob, db, ab
            slot = slots[paths[part]] + counts[paths[part]] - 1 - r
            events.view(torch.int32)[slot, 0] = winner.to(torch.int32)
            events[slot, 1:14] = pb[:, list(_EVENT_ROWS)]
        r += 1
        live = live[counts[paths[live]] > r]
        at[live] = links[at[live]]
    return events
