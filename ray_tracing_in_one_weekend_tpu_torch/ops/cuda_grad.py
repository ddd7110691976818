"""Scene-parameter gradients: the backward render kernel and the train step.

The PyTorch counterpart of ray_tracing_in_one_weekend_tpu/ops/pallas_grad.py.
`_DiffRender` is a `torch.autograd.Function` around the packed scene
matrix:

* forward: `_multipass`, the forward render of `ops/cuda_render.py`
  (the CUDA kernel on the card), which also gives the per-lane cost map.
  The value of `render_cuda_diff` is `render_cuda`'s bit for bit.
* backward: `_grad_pass` replays every (pixel, sample) path with the
  forward's own device functions, so the replay takes the forward's
  discrete decisions, then walks each path's bounces in reverse through
  the vector-Jacobian product of the bounce `_bounce_f`, with the
  decisions frozen. Each bounce's cotangent of the winning sphere's
  16-row parameter column is added into a [16, N] result. On CUDA
  tensors that is `csrc/grad_kernel.cu`: a replay kernel that records
  every bounce, a reverse kernel (a hand-written adjoint, see its source
  note) that turns the records into per-bounce events in place, and a
  fixed-order reduction. On CPU tensors it is `_grad_pass_plain`, which
  gets the same vector-Jacobian products from `torch.autograd.grad`;
  `_replay_records_plain` and `_reverse_records_plain` are the plain
  versions of the two kernels, record for record.

Gradients reach center, radius, albedo, fuzz and ior through `pack_scene`
(autograd follows its row writes, including the fused -2c and
|c|^2 - r^2 rows). The camera gets none, as in the JAX package.

The semantics are the Monte-Carlo-discrete gradient of the JAX kernel:
adjoints start at zero for every path, each step's adjoints and
parameter cotangent are clipped to +-1e6, and a sample that ends absorbed
or at the depth limit adds nothing (its radiance is 0).
"""

from __future__ import annotations

import dataclasses

import torch

from ray_tracing_in_one_weekend_tpu_torch.models.camera import Camera
from ray_tracing_in_one_weekend_tpu_torch.models.scene import Scene
from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_render import (
    _CSQR2,
    _CX,
    _CY,
    _CZ,
    _IOR,
    _M2CX,
    _M2CY,
    _M2CZ,
    _PLAIN_CHUNK,
    _R,
    _U32,
    DEFAULT_TILE,
    P_ROWS,
    _as_i32,
    _camera_ray_block,
    _check_tile,
    _cost_perm,
    _default_budget,
    _dot3,
    _hit_and_scatter,
    _init_state,
    _multipass,
    _pcg,
    _perm_from_hint,
    _render_pass,
    _scatter_block,
    _rank_share,
    _sky,
    _slab_hint,
    _sqrt,
    _surface,
    _u32,
    _unpack_cam,
    pack_camera,
    pack_scene,
)

# Lanes per CUDA block of the backward's replay and reverse kernels.
DEFAULT_BWD_TILE = 128

# Per-step clip of the adjoints and the parameter cotangent
# (ray_tracing_in_one_weekend_tpu/ops/pallas_grad.py:468-472): a bounce's
# Jacobian is unbounded at ill-conditioned events (a near-degenerate
# lambertian direction), and one inf lane would poison every sphere.
GRAD_CLIP = 1e6

# Scene leaves that receive gradients; mat_type and active are structure.
DIFF_FIELDS = ("center", "radius", "albedo", "fuzz", "ior")


def scene_params(scene: Scene) -> dict:
    """The differentiable fields of a Scene, by name."""
    return {f: getattr(scene, f) for f in DIFF_FIELDS}


def scene_with_params(scene: Scene, params: dict) -> Scene:
    return scene.replace(**params)


# ---------------------------------------------------------------------------
# The plain backward.
# ---------------------------------------------------------------------------


def _winner_t(o, d, pcols, mask, t_min):
    """The winning sphere's t recomputed from its parameter column `pcols`
    [16, L], with the gradient guards -> (pc, t): lanes outside `mask`
    [1, L] see a safe column (radius 1, ior 1) and disc = 1, and the sqrt
    argument is floored at 1e-12, so no reciprocal or sqrt derivative is
    infinite. The operations are the sweep's (`_sweep_ts`), in its order,
    so on a masked lane t is the sweep's value wherever the floor does not
    bind."""
    safe = torch.zeros(P_ROWS, 1, dtype=pcols.dtype, device=pcols.device)
    safe[_R] = 1.0
    safe[_IOR] = 1.0
    pc = torch.where(mask, pcols, safe)
    o_dot_d = _dot3(o, d)
    o_sq = _dot3(o, o)
    d_dot_c = pc[_CX : _CX + 1] * d[0:1] + pc[_CY : _CY + 1] * d[1:2] + pc[_CZ : _CZ + 1] * d[2:3]
    cc_part = (
        pc[_CSQR2 : _CSQR2 + 1]
        + pc[_M2CX : _M2CX + 1] * o[0:1]
        + pc[_M2CY : _M2CY + 1] * o[1:2]
        + pc[_M2CZ : _M2CZ + 1] * o[2:3]
    )
    half_b = o_dot_d - d_dot_c
    cc = o_sq + cc_part
    disc = torch.where(mask, half_b * half_b - cc, 1.0)
    sqrt_d = _sqrt(torch.clamp(disc, min=1e-12))
    root_near = -half_b - sqrt_d
    root_far = -half_b + sqrt_d
    return pc, torch.where(root_near > t_min, root_near, root_far)


def _bounce_f(o, d, att, pcols, cont, miss, stream, ctr, t_min):
    """One bounce as a pure function of its continuous inputs -> (o', d',
    att', radiance term), the `F` of the JAX kernel. `pcols` [16, L] is
    the winner's parameter column; `cont` and `miss` [1, L] are the
    replayed event; front_face, the material branch, the lambertian
    fallback, metal's `ok` and the dielectric choice are recomputed from
    the same values as in the forward, so they are the replay's. Lanes
    that do not continue get `_winner_t`'s guards."""
    pc, t = _winner_t(o, d, pcols, cont, t_min)
    p, n_vec, front_face = _surface(o, d, torch.where(cont, t, 1.0), pc)
    new_dir, mat_atten, _ = _scatter_block(d, n_vec, front_face, pc, stream, ctr)
    o2 = torch.where(cont, p, o)
    d2 = torch.where(cont, new_dir, d)
    att2 = torch.where(cont, att * mat_atten, att)
    return o2, d2, att2, torch.where(miss, att * _sky(d), 0.0)


def _bounce_vjp(o, d, att, pcols, cont, miss, stream, ctr, t_min, cotangents):
    """(o_bar, d_bar, att_bar, pcols_bar) of `_bounce_f` at the given
    point for the cotangents of its four outputs."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (o, d, att, pcols)]
        outs = _bounce_f(*leaves, cont, miss, stream, ctr, t_min)
        bars = torch.autograd.grad(outs, leaves, grad_outputs=cotangents, allow_unused=True)
    return [torch.zeros_like(x) if b is None else b for x, b in zip(leaves, bars)]


@dataclasses.dataclass
class _Step:
    """One bounce of the lanes `live` still on their path: the pre-bounce
    state, the winner's parameter column and index, and the event."""

    live: torch.Tensor  # [L] positions among the replayed lanes
    o: torch.Tensor
    d: torch.Tensor
    att: torch.Tensor
    params: torch.Tensor  # [16, L]; 0 on a miss
    best: torch.Tensor  # [1, L] winning sphere
    cont: torch.Tensor  # [1, L] bool
    miss: torch.Tensor  # [1, L] bool
    stream: tuple
    depth: int


def _lanes(camc, seed, pix):
    """(px, py, h0) of global pixel ids `pix` [1, L] int64."""
    width = camc[-1]
    return (pix % width).to(torch.float32), (pix // width).to(torch.float32), _pcg(
        _u32(pix) ^ _pcg(seed & _U32)
    )


def _replay(p_mat, camc, t_min, lanes, s_global, max_depth):
    """Replay global sample `s_global` of every lane with the forward's
    plain functions -> its bounces, a list of `_Step`."""
    px, py, h0 = lanes
    o, d, lo, hi = _camera_ray_block(camc, h0, px, py, torch.full_like(h0, s_global))
    o = o.clone()  # without defocus it is a broadcast view of the camera center
    att = torch.ones_like(o)
    live = torch.arange(o.shape[1], device=o.device)
    steps = []
    for depth in range(max_depth):
        if live.numel() == 0:
            break
        o_l, d_l, att_l = o[:, live], d[:, live], att[:, live]
        stream = (lo[:, live], hi[:, live])
        hit, params, best, p, new_dir, mat_atten, ok = _hit_and_scatter(
            p_mat, t_min, o_l, d_l, depth, stream
        )
        cont = hit & ok & (depth + 1 < max_depth)
        steps.append(_Step(live, o_l, d_l, att_l, params, best, cont, ~hit, stream, depth))
        c = cont[0]
        live = live[c]
        o[:, live], d[:, live] = p[:, c], new_dir[:, c]
        att[:, live] = att_l[:, c] * mat_atten[:, c]
    return steps


def record_bounces(p_mat, cam_vec, seed, pix, spp, max_depth):
    """The bounces that continue, replayed for global pixel ids `pix` [L]
    over samples [0, spp): dict of o, d, att [3, n] f32 and winner, lo,
    hi, depth [n] int32 (stream words as int32 bits) — the inputs of the
    hand-written adjoint's check against `_bounce_f`."""
    camc = _unpack_cam(cam_vec)
    lanes = _lanes(camc, seed, pix.to(torch.int64)[None])
    rec = {k: [] for k in ("o", "d", "att", "winner", "lo", "hi", "depth")}
    for s in range(spp):
        for st in _replay(p_mat, camc, float(cam_vec[20]), lanes, s, max_depth):
            c = st.cont[0]
            for k, v in (("o", st.o), ("d", st.d), ("att", st.att)):
                rec[k].append(v[:, c])
            rec["winner"].append(st.best[0, c])
            rec["lo"].append(st.stream[0][0, c])
            rec["hi"].append(st.stream[1][0, c])
            rec["depth"].append(torch.full_like(st.best[0, c], st.depth))
    out = {k: torch.cat(v, dim=-1) for k, v in rec.items()}
    return {k: _as_i32(v) if v.dtype == torch.int64 else v for k, v in out.items()}


def _grad_lanes(p_mat, camc, t_min, seed, sample_offset, n_live, spp, max_depth, pix, g, grads):
    """The plain backward over one chunk of lanes, added into `grads`."""
    keep = (pix < n_live).nonzero()[:, 0]
    if keep.numel() == 0:
        return
    lanes = _lanes(camc, seed, pix[keep].to(torch.int64)[None])
    g = g[:, keep]
    zeros3 = torch.zeros(3, keep.numel(), dtype=torch.float32, device=pix.device)
    for s in range(spp):
        steps = _replay(p_mat, camc, t_min, lanes, s + sample_offset, max_depth)
        # Reverse: adjoints start at zero for the sample.
        obar, dbar, attbar = zeros3.clone(), zeros3.clone(), zeros3.clone()
        for st in reversed(steps):
            live = st.live
            cot = (obar[:, live], dbar[:, live], attbar[:, live], g[:, live])
            bars = _bounce_vjp(st.o, st.d, st.att, st.params, st.cont, st.miss, st.stream,
                               8 + st.depth * 16, t_min, cot)
            ob, db, ab, pb = (torch.clamp(b, -GRAD_CLIP, GRAD_CLIP) for b in bars)
            obar[:, live], dbar[:, live], attbar[:, live] = ob, db, ab
            grads.index_add_(1, st.best[0], pb)


def _grad_pass_plain(p_mat, cam_vec, scalars, pix, g, spp, max_depth):
    """The backward over lanes in plain PyTorch -> [16, N] cotangent of
    `p_mat`.

    The same computation as `csrc/grad_kernel.cu`, vectorized over lanes
    in chunks. `scalars` = (seed, pixel_offset, sample_offset, n_live);
    `pix` [P] int holds each lane's global pixel id in any order (lanes
    with id >= n_live are idle); `g` [3, P] the matching radiance
    cotangent of one sample (the image cotangent / spp)."""
    seed, _pixel_offset, sample_offset, n_live = (int(v) for v in scalars)
    camc = _unpack_cam(cam_vec)
    t_min = float(cam_vec[20])
    grads = torch.zeros_like(p_mat)
    chunk = _PLAIN_CHUNK.get(pix.device.type, _PLAIN_CHUNK["cpu"])
    for a in range(0, pix.shape[0], chunk):
        _grad_lanes(p_mat, camc, t_min, seed, sample_offset, n_live, spp, max_depth,
                    pix[a : a + chunk], g[:, a : a + chunk], grads)
    return grads


# Words 1-13 of a backward event (`build.grad_reverse`) hold these rows of a sphere's
# cotangent; r^2, mat and active (rows 4, 10, 11) never get one.
_EVENT_ROWS = (0, 1, 2, 3, 5, 6, 7, 8, 9, 12, 13, 14, 15)


# Events per chunk of the backward's reduction (`build.grad_reduce`, the
# kernel's CHUNK_EVENTS): its summation order is fixed by it.
CHUNK_EVENTS = 8192
# The reduction kernel's walk inside a chunk (csrc/grad_kernel.cu: events a
# shared-memory stage, warps that own spheres, chunks a round of the fold
# over chunks). They do not enter the order; the tests emulate the walk
# with them, and the card's tests hold them to the library's.
REDUCE_STAGE_EVENTS, REDUCE_WARPS, REDUCE_FOLD_ROUND = 128, 8, 128


def _reduce_events_plain(events, n_spheres):
    """The plain version of the backward's reduction: events
    [E, 16] (word 0 the winner as int32 bits, -1 for none) -> [16, N]."""
    idx = events[:, 0].contiguous().view(torch.int32).to(torch.int64)
    keep = (idx >= 0) & (idx < n_spheres)
    out = torch.zeros(P_ROWS, n_spheres, dtype=torch.float32, device=events.device)
    out[list(_EVENT_ROWS)] = out[list(_EVENT_ROWS)].index_add(1, idx[keep], events[keep, 1:14].T)
    return out


def _reduce_events_ordered(events, n_spheres):
    """The backward's reduction in the kernel's exact order, in plain
    PyTorch: events [E, 16] -> [16, N], the bits of `build.grad_reduce`.

    Chunk c is events [CHUNK_EVENTS * c, CHUNK_EVENTS * (c + 1)). Its
    partial of (row, sphere) is ((+0 + e0) + e1) + ... over that sphere's
    events in increasing index; the result is ((+0 + p0) + p1) + ... over
    the chunks in order. Step p adds the p-th event of every chunk into its
    chunk's accumulator, one event a chunk, so each add is one float32 add.
    Winners outside [0, N) add nothing (they go to a spare column)."""
    dev = events.device
    n_events = events.shape[0]
    n_chunks = -(-n_events // CHUNK_EVENTS)
    pad = n_chunks * CHUNK_EVENTS - n_events
    idx = events[:, 0].contiguous().view(torch.int32).to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < n_spheres), idx, n_spheres)
    idx = torch.cat([idx, idx.new_full((pad,), n_spheres)]).view(n_chunks, CHUNK_EVENTS)
    vals = torch.cat([events[:, 1:14], events.new_zeros(pad, 13)]).view(n_chunks, CHUNK_EVENTS, 13)
    acc = torch.zeros(n_chunks, 13, n_spheres + 1, dtype=torch.float32, device=dev)
    chunks = torch.arange(n_chunks, device=dev)
    for p in range(CHUNK_EVENTS if n_chunks else 0):
        w = idx[:, p]
        acc[chunks, :, w] = acc[chunks, :, w] + vals[:, p]
    total = torch.zeros(13, n_spheres, dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        total = total + acc[c, :, :n_spheres]
    out = torch.zeros(P_ROWS, n_spheres, dtype=torch.float32, device=dev)
    out[list(_EVENT_ROWS)] = total
    return out


# Words of a backward record (`build.grad_replay`; int fields as int32
# bits): o, d, att at 0-8, then the winner (-1 for a miss), the stream
# words, the depth and how the path goes on after the bounce.
_REC_WINNER, _REC_LO, _REC_HI, _REC_DEPTH, _REC_END = 9, 10, 11, 12, 13
_END_NONE, _END_DARK, _END_SKY = 0, 1, 2  # goes on; ends without radiance; ends at the sky


def _record_rows(st: _Step) -> torch.Tensor:
    """The records [L, 16] of one replayed bounce of lanes `st.live`."""
    rows = torch.zeros(st.o.shape[1], 16, dtype=torch.float32, device=st.o.device)
    rows[:, 0:3], rows[:, 3:6], rows[:, 6:9] = st.o.T, st.d.T, st.att.T
    words = rows.view(torch.int32)
    words[:, _REC_WINNER] = torch.where(st.miss[0], -1, st.best[0]).to(torch.int32)
    words[:, _REC_LO] = _as_i32(st.stream[0][0])
    words[:, _REC_HI] = _as_i32(st.stream[1][0])
    words[:, _REC_DEPTH] = st.depth
    end = torch.where(st.miss[0], _END_SKY, _END_DARK)
    words[:, _REC_END] = torch.where(st.cont[0], _END_NONE, end).to(torch.int32)
    return rows


def _replay_records_plain(p_mat, cam_vec, scalars, pix, spp, max_depth):
    """The replay half of the backward in plain PyTorch -> (records
    [E, 16] f32, ev_start [P] int64, ev_count [P] int32), the layout of
    `build.grad_replay` (see there): each lane's bounces in sample and
    bounce order, in slots that follow the pixel ids. The slots come from
    this replay's own bounce counts, so a lane's count can be held
    against the forward's work map."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    seed, pixel_offset, sample_offset, n_live = (int(v) for v in scalars)
    camc = _unpack_cam(cam_vec)
    t_min = float(cam_vec[20])
    dev = pix.device
    local = pix.to(torch.int64) - pixel_offset
    keep = ((local >= 0) & (pix < n_live)).nonzero()[:, 0]
    per_sample = torch.zeros(pix.shape[0], spp, dtype=torch.int64, device=dev)
    parts = []  # (lanes, sample, depth, records)
    chunk = _PLAIN_CHUNK.get(dev.type, _PLAIN_CHUNK["cpu"])
    for a in range(0, keep.numel(), chunk):
        idx = keep[a : a + chunk]
        lanes = _lanes(camc, seed, pix[idx].to(torch.int64)[None])
        for s in range(spp):
            for st in _replay(p_mat, camc, t_min, lanes, s + sample_offset, max_depth):
                per_sample[idx[st.live], s] += 1
                parts.append((idx[st.live], s, st.depth, _record_rows(st)))
    work = torch.zeros(n_live - pixel_offset, dtype=torch.int64, device=dev)
    work[local[keep]] = per_sample[keep].sum(1)
    ev_start, ev_count = build.event_slots(pix, work, pixel_offset, n_live)
    earlier = torch.cumsum(per_sample, 1) - per_sample  # bounces of a lane's earlier samples
    records = torch.empty(int(work.sum()), 16, dtype=torch.float32, device=dev)
    for idx, s, depth, rows in parts:  # moved as int32, so every word keeps its bits
        records.view(torch.int32)[ev_start[idx] + earlier[idx, s] + depth] = rows.view(torch.int32)
    return build.Replay(records, ev_start, ev_count)


def _path_positions(records):
    """Where each record sits in its path -> (ends, path, back): `ends` the
    slots of the paths' last bounces in increasing order, `path` [E] each
    slot's path (an index into `ends`), `back` [E] its distance from that
    last bounce (0 at the last bounce)."""
    slots = torch.arange(records.shape[0], device=records.device)
    ends = (records.view(torch.int32)[:, _REC_END] != _END_NONE).nonzero()[:, 0]
    path = torch.searchsorted(ends, slots)
    return ends, path, ends[path] - slots


def _reverse_records_plain(p_mat, cam_vec, replay, g, dtype=torch.float32):
    """The reverse half in plain PyTorch: records -> events [E, 16] f32,
    the layout of `build.grad_reverse` (a new tensor; the records stay).
    With `dtype=torch.float64` the walk runs in float64 at the records'
    float32 points (`probes/grad_exact.py`'s reference): the events are
    float64 and word 0 holds the winner as a value.

    Paths are independent once the adjoints restart at each path's last
    bounce, so this walks all paths at once, step r taking the bounce r
    places before each path's end. The sky's adjoint and each earlier
    bounce's vector-Jacobian product come from torch.autograd of
    `_bounce_f`, as in `_grad_lanes`, with the same ±1e6 clips."""
    records, ev_start, ev_count = replay.records, replay.ev_start, replay.ev_count
    t_min = float(cam_vec[20])
    dev = records.device
    n = records.shape[0]
    words = records.view(torch.int32)
    events = torch.zeros(n, 16, dtype=dtype, device=dev)
    winners = events[:, 0] if dtype != torch.float32 else events.view(torch.int32)[:, 0]
    winners.fill_(-1)
    if n == 0:
        return events
    # Each slot's lane, then its path and its distance from the path's end.
    counts = ev_count.to(torch.int64)
    lane_of = torch.repeat_interleave(torch.arange(counts.numel(), device=dev), counts)
    first = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    slot_lane = torch.empty(n, dtype=torch.int64, device=dev)
    slot_lane[ev_start[lane_of] + torch.arange(n, device=dev) - first] = lane_of
    ends, path, back = _path_positions(records)
    lit = words[ends[path], _REC_END] == _END_SKY  # the slot's path reached the sky
    bars = torch.zeros(3, 3, ends.numel(), dtype=dtype, device=dev)  # o, d, att adjoints per path

    def vjp(sel, pcols, cont, cot):
        rec = records[sel, 0:9].to(dtype)
        stream = (_u32(words[sel, _REC_LO])[None], _u32(words[sel, _REC_HI])[None])
        ctr = 8 + 16 * words[sel, _REC_DEPTH].to(torch.int64)[None]
        miss = ~cont
        out = _bounce_vjp(rec[:, 0:3].T, rec[:, 3:6].T, rec[:, 6:9].T, pcols, cont, miss, stream, ctr,
                          t_min, cot)
        return [torch.clamp(b, -GRAD_CLIP, GRAD_CLIP) for b in out]

    # The last bounce of a path that reached the sky: the sky's adjoint.
    sel = ((back == 0) & lit).nonzero()[:, 0]
    zeros = torch.zeros(3, sel.numel(), dtype=dtype, device=dev)
    no = torch.zeros(1, sel.numel(), dtype=torch.bool, device=dev)
    ob, db, ab, _ = vjp(sel, torch.zeros(P_ROWS, sel.numel(), dtype=dtype, device=dev), no,
                        (zeros, zeros, zeros, g[:, slot_lane[sel]].to(dtype)))
    bars[:, :, path[sel]] = torch.stack([ob, db, ab])
    # Each earlier bounce of such a path, last first.
    for r in range(1, int(back.max()) + 1):
        sel = ((back == r) & lit).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        winner = words[sel, _REC_WINNER].to(torch.int64)
        yes = torch.ones(1, sel.numel(), dtype=torch.bool, device=dev)
        cot = bars[:, :, path[sel]]
        ob, db, ab, pb = vjp(sel, p_mat[:, winner].to(dtype), yes, (*cot, torch.zeros_like(cot[0])))
        bars[:, :, path[sel]] = torch.stack([ob, db, ab])
        winners[sel] = winner.to(winners.dtype)
        events[sel, 1:14] = pb[list(_EVENT_ROWS)].T
    return events


def _grad_pass(p_mat, cam_vec, scalars, pix, g, work, tile, spp, max_depth):
    """The backward: the CUDA kernels for CUDA tensors (`build.grad_pass`:
    replay, reverse, reduction; it raises if a kernel cannot launch or if
    the replay diverges from the forward; there is no fallback), the
    plain version for CPU tensors. `work` [n_live] is the forward's
    per-pixel bounce count in pixel order: the kernels' record slots. The
    plain version does not need it."""
    if g.device.type == "cuda":
        from ray_tracing_in_one_weekend_tpu_torch.kernels import build

        return build.grad_pass(
            p_mat.T.contiguous(), cam_vec, scalars, pix, g, work, tile, spp, max_depth
        )
    return _grad_pass_plain(p_mat, cam_vec, scalars, pix, g, spp, max_depth)


# ---------------------------------------------------------------------------
# The differentiable render.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _DiffCfg:
    n_lanes: int  # this rank's slab: the whole padded image on one device
    pixel_offset: int  # the slab's first global pixel id
    n_pixels_total: int  # the image's pixels
    seed: int
    spp: int  # this rank's samples (spp / S on a mesh)
    sample_shards: int  # S: the image is the mean of S sample windows
    max_depth: int
    tile: int
    bwd_tile: int
    n_passes: int
    budget: int
    sample_offset: int  # this rank's window starts here

    @property
    def n_live(self) -> int:
        """The slab's pixels inside the image (0 or fewer: none)."""
        return min(self.pixel_offset + self.n_lanes, self.n_pixels_total) - self.pixel_offset


class _DiffRender(torch.autograd.Function):
    """(p_mat, cam_vec, hint) -> (rad [3, n], work [n]) of the whole image:
    the render with the backward kernels as its vector-Jacobian product.
    `work`, the per-pixel bounce count, is scheduling metadata and has no
    gradient.

    On a mesh each rank renders its slab and sample window; the forward
    averages the windows and gathers the slabs, so every rank returns the
    whole image. Every rank then holds the same cotangent of the image, and
    its backward takes its slab's part (each window's radiance enters the
    image with weight 1/S, and each sample with 1/spp of the whole
    budget), runs the backward kernels on it, and sums the [16, N]
    cotangent over the mesh in rank order, so the chain rule through
    `pack_scene` runs once, on the sum."""

    @staticmethod
    def forward(ctx, p_mat, cam_vec, cfg: _DiffCfg, hint, mesh):
        sf, si = _init_state(cfg.pixel_offset, cfg.n_lanes, cfg.n_pixels_total, cfg.spp, p_mat.device)
        work_perm = None
        if hint is not None:
            # Warm start: lanes sorted by a previous step's cost map.
            perm, inv = _perm_from_hint(hint).reshape(2, -1)
            work_perm = (perm, inv)
        rad, work = _multipass(
            p_mat, cam_vec, (cfg.seed, cfg.pixel_offset, cfg.sample_offset, 0), sf, si, cfg.tile,
            cfg.spp, cfg.max_depth, cfg.budget, cfg.n_passes, _render_pass, work_perm=work_perm,
        )
        # The backward replays this rank's own window: its bounce counts.
        local_work = work[: max(cfg.n_live, 0)].contiguous()
        if mesh is not None:
            rad, work = mesh.sample_mean(rad), mesh.sample_mean(work)
            rad, work = mesh.gather_pixels(rad), mesh.gather_pixels(work)
        n = cfg.n_pixels_total
        rad, work = rad[:, :n].contiguous(), work[:n].contiguous()
        ctx.save_for_backward(p_mat, cam_vec, local_work)
        ctx.cfg, ctx.mesh = cfg, mesh
        ctx.mark_non_differentiable(work)
        return rad, work

    @staticmethod
    def backward(ctx, grad_rad, _grad_work):
        p_mat, cam_vec, work = ctx.saved_tensors
        cfg, mesh = ctx.cfg, ctx.mesh
        start, n_live = cfg.pixel_offset, cfg.n_live
        if n_live <= 0:
            # A slab wholly past the image: no launch, a zero cotangent.
            grads = torch.zeros_like(p_mat)
        else:
            g = None if grad_rad is None else grad_rad[:, start : start + n_live]
            pix, g = _bwd_lanes(work, g, cfg.spp * cfg.sample_shards, cfg.bwd_tile, start)
            grads = _grad_pass(
                p_mat, cam_vec, (cfg.seed, start, cfg.sample_offset, start + n_live), pix, g, work,
                cfg.bwd_tile, cfg.spp, cfg.max_depth,
            )
        if mesh is not None:
            grads = mesh.sum_all(grads)
        return grads, None, None, None, None


def _bwd_lanes(work, grad_rad, spp, bwd_tile, pixel_offset=0):
    """The backward's lanes -> (pix [P] int32, g [3, P]): lane i replays
    global pixel pix[i] = pixel_offset + perm[i], the slab's pixels sorted
    by descending cost (`work`, this step's own cost map: each block then
    holds paths of similar length), with its radiance cotangent per sample
    (the pixel's / spp, the whole budget of samples that the image
    averages). Pad lanes carry ids past the slab's pixels and idle."""
    n = work.numel()
    padded = -(-n // bwd_tile) * bwd_tile
    g = torch.zeros(3, padded, dtype=torch.float32, device=work.device)
    if grad_rad is not None:
        g[:, :n] = grad_rad / spp
    cost = torch.zeros(padded, dtype=torch.float32, device=work.device)
    cost[:n] = work
    perm = _cost_perm(cost)
    return (perm + pixel_offset).to(torch.int32), g[:, perm].contiguous()


def params_vjp(scene: Scene, p_bar: torch.Tensor) -> dict:
    """Gradients of the scene's differentiable fields from a cotangent
    `p_bar` [16, N] of its packed matrix (the chain rule through
    `pack_scene`, as the backward of `render_cuda_diff` applies it)."""
    leaves = {k: v.detach().requires_grad_() for k, v in scene_params(scene).items()}
    with torch.enable_grad():
        p_mat = pack_scene(scene_with_params(scene, leaves))
        grads = torch.autograd.grad(p_mat, list(leaves.values()), grad_outputs=p_bar)
    return dict(zip(leaves, grads))


def render_cuda_diff(
    scene: Scene,
    cam: Camera,
    seed: int = 0,
    spp: int | None = None,
    max_depth: int | None = None,
    tile: int = DEFAULT_TILE,
    bwd_tile: int = DEFAULT_BWD_TILE,
    n_passes: int = 1,
    budget: int | None = None,
    sample_offset: int = 0,
    work_hint: torch.Tensor | None = None,
    return_work: bool = False,
    mesh=None,
):
    """Differentiable render -> [H, W, 3] float32 on the scene's device.

    Its value equals `render_cuda`'s bit for bit. Under autograd, the
    scene's center, radius, albedo, fuzz and ior get gradients from the
    backward kernels (`csrc/grad_kernel.cu` on a CUDA scene, the plain
    version on a CPU scene); the camera gets none.

    `work_hint` ([H, W] or flat: a previous step's cost map) sorts the
    forward's lanes by cost before the first pass; with `return_work` the
    step's own map comes back for the next step. Neither changes a pixel
    or a gradient. `n_passes` is 1 by default with or without a hint
    (more passes compact the lanes between them, as `render_cuda`'s do).
    The render never reads or fills `render_cuda`'s warm-start cache. The
    JAX package's `interpret` and `bwd_group` are TPU scheduling knobs and
    have no counterpart: the replay runs all of a lane's samples in one
    persistent loop, and its records live in device memory.

    With a `mesh` it is `render_cuda_diff_distributed`."""
    _check_tile(tile)
    _check_tile(bwd_tile)
    spp = cam.samples_per_pixel if spp is None else spp
    max_depth = cam.max_depth if max_depth is None else max_depth
    n = cam.num_pixels
    start, shard, spp_local, window = _rank_share(n, tile, spp, sample_offset, mesh)
    cfg = _DiffCfg(
        n_lanes=shard, pixel_offset=start, n_pixels_total=n, seed=seed, spp=spp_local,
        sample_shards=spp // spp_local, max_depth=max_depth, tile=tile, bwd_tile=bwd_tile, n_passes=n_passes,
        budget=_default_budget(spp_local) if budget is None else budget, sample_offset=window,
    )
    p_mat = pack_scene(scene)
    cam_vec = pack_camera(cam).to(scene.device)
    hint = None
    if work_hint is not None:
        hint = _slab_hint(work_hint, n, start, shard, scene.device)
    rad, work = _DiffRender.apply(p_mat, cam_vec, cfg, hint, mesh)
    img = rad.T.reshape(cam.image_height, cam.image_width, 3)
    if return_work:
        return img, work.reshape(cam.image_height, cam.image_width)
    return img


def render_cuda_diff_distributed(scene: Scene, cam: Camera, seed: int = 0, mesh=None, **kw):
    """The differentiable render sharded over `mesh` (`parallel/dist.py`;
    default: every rank on the pixel axis) -> [H, W, 3], the whole image on
    every rank; the counterpart of `render_pallas_diff_distributed`
    (ops/pallas_grad.py:786-928).

    The forward is `render_cuda_distributed`'s layout: each rank renders its
    tile-aligned pixel slab and its window of spp / S samples, the windows
    are averaged and the slabs gathered in rank order. The backward runs
    the backward kernels on each rank's slab and window, for the rank's
    part of the image's cotangent; a slab wholly past the image launches
    nothing. The [16, N] cotangent is summed over every rank in rank order
    before the chain rule through `pack_scene`, so every rank gets the same
    gradients: within float32 summation order of one device's. Keywords as
    `render_cuda_diff`'s; `work_hint` is the whole image's cost map and
    `return_work` gives it back averaged over the sample axis."""
    if mesh is None:
        from ray_tracing_in_one_weekend_tpu_torch.parallel.dist import make_mesh

        mesh = make_mesh()
    return render_cuda_diff(scene, cam, seed=seed, mesh=mesh, **kw)


def render_loss_cuda(params: dict, scene: Scene, cam: Camera, target: torch.Tensor,
                     mesh=None, return_work: bool = False, **kw):
    """Mean squared pixel error of the render of `scene` with `params`
    against `target`; with `return_work`, (loss, [H, W] cost map). With a
    `mesh` the render is sharded over it, and the loss is the whole
    image's, on every rank."""
    out = render_cuda_diff(scene_with_params(scene, params), cam, return_work=return_work,
                           mesh=mesh, **kw)
    img, work = out if return_work else (out, None)
    loss = torch.mean((img - target) ** 2)
    return (loss, work) if return_work else loss


def render_grads_cuda(params: dict, scene: Scene, cam: Camera, target: torch.Tensor,
                      mesh=None, return_work: bool = False, **kw):
    """(loss, grads) of the render with respect to `params`, one gradient
    per field; with `return_work`, ((loss, work), grads). With a `mesh`
    the gradients are the sum over its ranks, the same on every rank."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    out = render_loss_cuda(leaves, scene, cam, target, mesh=mesh, return_work=return_work, **kw)
    loss, work = out if return_work else (out, None)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    loss = loss.detach()
    return ((loss, work), grads) if return_work else (loss, grads)


def train_step_cuda(params: dict, scene: Scene, cam: Camera, target: torch.Tensor,
                    mesh=None, lr: float = 1e-2, work_hint=None, return_work: bool = False, **kw):
    """One SGD step of inverse rendering -> (loss, new_params), or (loss,
    new_params, work) with `return_work`. Pass the previous step's `work`
    back as `work_hint` to warm-start the forward (the warm carry): the
    loss and gradients do not change. With a `mesh` the step is sharded
    over it (`render_cuda_diff_distributed`), and every rank takes the
    same step."""
    (loss, work), grads = render_grads_cuda(
        params, scene, cam, target, mesh=mesh, return_work=True, work_hint=work_hint, **kw
    )
    new_params = {k: (params[k] - lr * grads[k]).detach() for k in params}
    return (loss, new_params, work) if return_work else (loss, new_params)
