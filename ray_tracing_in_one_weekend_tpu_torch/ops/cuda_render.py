"""The forward render: the hand-written Hopper kernel and its plain version.

The PyTorch counterpart of ray_tracing_in_one_weekend_tpu/ops/pallas_render.py.
`render_cuda` packs the scene and camera, lays out one lane per pixel,
and runs budgeted passes of the persistent-sample loop over the lane
state. A pass on CUDA tensors launches `csrc/render_kernel.cu` (one
thread per lane; see its source note); a pass on CPU tensors runs
`_render_pass_plain`, the same computation vectorized over lanes in
PyTorch. The device functions below (`_pcg`, `_u01`, `_sweep_ts`, ...)
carry the JAX kernel's names, and `csrc/render_device.cuh` holds their
CUDA counterparts.

Contracts kept from the JAX kernel:

* the layout constants (P rows, lane-state rows, the camera vector with
  t_min in slot 20) and the lane state itself: row r, lane j at r*P + j,
  with the uint32 stream words stored as int32 bits;
* the 64-bit PCG streams keyed by the GLOBAL (pixel, sample) and the
  draw counter layout `8 + 16*depth` — bit for bit;
* NaN-as-miss in the sphere sweep, inactive slots at r^2 = -1;
* `sample_offset` progressive rendering, `t_min` as runtime data, and
  pad lanes born finished.

What differs, by design:

* lanes are independent: each lane advances one bounce per iteration
  until it is idle or the pass budget is spent, exactly the lane state
  the TPU's per-tile loop produces for every busy lane. Two rows are the
  exception: `_SF_ITERS` holds the lane's OWN trip count in this pass
  (the TPU kernel wrote the tile's), and the depth row of a FINISHED lane
  stays at its last sample's depth (the TPU kernel kept incrementing it
  while the rest of its tile ran). Neither row feeds the image;
* on an exact t tie the lowest sphere index wins (the JAX kernel
  averages the tied spheres' parameters) — a measure-zero case.

The lane scheduler is the JAX package's: budgeted passes with the
two-level tail compaction `_compact` between them, a `work_hint` or a
precomputed cost-sorted permutation before the first, and the warm-start
cache `_WORK_CACHE` that lets a repeated render of the same scene,
camera and noise realization run one pass over cost-sorted lanes. It is
pure lane permutation: the image is the same bits for any schedule.
On the card a warp runs until its longest lane is done, as a TPU tile
did, so the schedule decides how many lane-iterations run idle.

On the card, kernel and plain version give bit-identical lane state:
the kernel is built without FMA contraction and the plain version
spells out the kernel's operation order (see kernels/build.py for the
measured cost). Against the JAX kernel, and between the plain version
on the CPU and on the card, results agree to float32 rounding per bounce
only (sin, cos, rsqrt differ in the last ulp), and a bounce off a small
sphere amplifies such a difference, so a few lanes take another path.
The JAX package accepts the same between its compiled and interpreted
kernels.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch

from ray_tracing_in_one_weekend_tpu_torch.models.camera import Camera
from ray_tracing_in_one_weekend_tpu_torch.models.scene import Scene
from ray_tracing_in_one_weekend_tpu_torch.utils.spans import span, spanned, sync

# Lanes per CUDA block. A multiple of 128, as the JAX kernel's tiles are.
DEFAULT_TILE = 128

T_MISS = 1e30
T_MIN_EPS = 1e-3

# P-matrix row indices (rows 12:16 are (-2c, |c|^2 - r^2), the o-terms
# of the sweep's quadratic).
(_CX, _CY, _CZ, _R, _R2, _AR, _AG, _AB, _FUZZ, _IOR, _MAT, _ACTIVE,
 _M2CX, _M2CY, _M2CZ, _CSQR2) = range(16)
P_ROWS = 16

# Per-lane resumable state. Float rows: ray origin, unit direction,
# attenuation, radiance summed over the lane's retired samples, this
# pass's trip count, cumulative busy iterations. Int rows: global pixel
# id, samples started, RNG stream low word, bounce depth, busy flag, RNG
# stream high word.
_SF_O, _SF_D, _SF_ATT, _SF_RAD = 0, 3, 6, 9
_SF_ITERS = 12
_SF_WORK = 13
SF_ROWS = 16
_SI_PIX, _SI_STARTED, _SI_STREAM, _SI_DEPTH, _SI_BUSY, _SI_STREAM2 = range(6)
SI_ROWS = 8

# Camera vector: [0:3] center, [3:6] pixel00, [6:9] delta_u, [9:12]
# delta_v, [12:15] defocus_disk_u, [15:18] defocus_disk_v,
# [18] defocus_angle, [19] image_width, [20] t_min, rest pad.
CAM_LEN = 24

# Lanes per vectorized step of the plain version: bounds its [N, lanes]
# sweep temporaries (128 MB each at N = 512 on CUDA, 8 MB on the CPU).
_PLAIN_CHUNK = {"cuda": 1 << 16, "cpu": 1 << 12}


def pack_scene(scene: Scene) -> torch.Tensor:
    """Scene SoA -> [16, N] float32 parameter matrix on the scene's device.

    Inactive slots are made analytically unhittable: center 0 and
    r^2 = -1 give disc = (o.d)^2 - (o.o + 1) <= -1 < 0 for any unit ray,
    so the sweep never tests an `active` row."""
    act = scene.active.to(torch.float32)
    center = scene.center * act[:, None]
    r2 = torch.where(
        scene.active, scene.radius * scene.radius, torch.full_like(scene.radius, -1.0)
    )
    rows = torch.zeros((P_ROWS, scene.num_slots), dtype=torch.float32, device=scene.device)
    rows[_CX : _CZ + 1] = center.T
    rows[_R] = scene.radius
    rows[_R2] = r2
    rows[_AR : _AB + 1] = scene.albedo.T
    rows[_FUZZ] = scene.fuzz
    rows[_IOR] = scene.ior
    rows[_MAT] = scene.mat_type.to(torch.float32)
    rows[_ACTIVE] = act
    rows[_M2CX : _M2CZ + 1] = -2.0 * center.T
    c = center
    rows[_CSQR2] = (c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2]) - r2
    return rows


def pack_camera(cam: Camera, t_min: float = T_MIN_EPS) -> torch.Tensor:
    """Camera constants + the shadow-acne epsilon -> float32 [CAM_LEN] on
    the camera's device. `t_min` defaults to the reference's 1e-3
    (reference: src/cpu/main.cc:19); it is data, not a kernel constant,
    so the negative-example test can disable it."""
    v = torch.zeros(CAM_LEN, dtype=torch.float32, device=cam.center.device)
    for i, vec in enumerate(
        (cam.center, cam.pixel00_loc, cam.pixel_delta_u, cam.pixel_delta_v,
         cam.defocus_disk_u, cam.defocus_disk_v)
    ):
        v[3 * i : 3 * i + 3] = vec
    v[18] = cam.defocus_angle
    # A Python number written into a card's tensor is a copy from pageable
    # host memory, which waits for the stream.
    with sync("cam_pack"):
        v[19] = float(cam.image_width)
    with sync("cam_pack"):
        v[20] = float(t_min)
    return v


# ---------------------------------------------------------------------------
# Counter-based PCG streams (O'Neill's pcg_hash). torch has no full uint32
# arithmetic, so a uint32 is an int64 tensor (or Python int) in [0, 2^32)
# and every result is reduced mod 2^32 — bit-equal to the JAX kernel's
# uint32 math and to the CUDA kernel's.
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_GOLDEN2 = 0x85EBCA6B  # murmur3 fmix constant; independent of _GOLDEN
_TWO_PI = 2.0 * math.pi


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits (or any int tensor) -> their uint32 value as int64."""
    return x.to(torch.int64) & _U32


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 value (int64) -> the same 32 bits as int32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _mul32(a, b: int):
    """(a * b) mod 2^32 for a uint32 `a` and a constant `b`, split in two
    16-bit halves of `b` so no int64 product overflows."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _U32


def _pcg(x):
    """pcg_hash: uint32 -> well-mixed uint32."""
    state = (_mul32(x, 747796405) + 2891336453) & _U32
    word = _mul32((state >> ((state >> 28) + 4)) ^ state, 277803737)
    return (word >> 22) ^ word


def _to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> (0, 1) float32 with a 24-bit mantissa (log-safe)."""
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u + (0.5 / (1 << 24))


def _u01(stream, counter) -> torch.Tensor:
    """One U(0,1) per lane from the 64-bit stream (lo, hi) and a draw
    counter (int or uint32 tensor): pcg(pcg(lo ^ ctr*golden) + hi)."""
    lo, hi = stream
    c = _mul32(counter, _GOLDEN)
    return _to_unit_float(_pcg((_pcg(lo ^ c) + hi) & _U32))


def _unit_vectors(stream, counter) -> torch.Tensor:
    """[3, L] uniform directions on S^2 via the cylinder map:
    z ~ U(-1,1), phi ~ U(0,2pi)."""
    z = 2.0 * _u01(stream, counter) - 1.0
    phi = _TWO_PI * _u01(stream, counter + 1)
    s = _sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.cat([s * torch.cos(phi), s * torch.sin(phi), z], dim=0)


# ---------------------------------------------------------------------------
# Vector helpers on [3, L] blocks ([1, L] rows out).
# ---------------------------------------------------------------------------


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[0:1] * b[0:1] + a[1:2] * b[1:2] + a[2:3] * b[2:3]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """IEEE float32 sqrt (correctly rounded, as sqrtf and jnp.sqrt are):
    torch's vectorized CPU sqrt is off by an ulp on ~0.7% of inputs. A
    float64 `x` keeps its precision."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def _normalize3(v: torch.Tensor) -> torch.Tensor:
    return v * torch.rsqrt(torch.clamp(_dot3(v, v), min=1e-20))


# ---------------------------------------------------------------------------
# The kernel's device functions, vectorized over lanes.
# ---------------------------------------------------------------------------


def _unpack_cam(cam_vec: torch.Tensor):
    """Camera vector -> ([3,1] center, pixel00, delta_u, delta_v, disk_u,
    disk_v, defocus_on: bool, width: int)."""
    cols = tuple(cam_vec[3 * i : 3 * i + 3].reshape(3, 1) for i in range(6))
    return (*cols, bool(cam_vec[18] > 0.0), int(cam_vec[19]))


def _camera_ray_block(camc, h0, px, py, s_global):
    """Camera ray + 64-bit stream (lo, hi) for the GLOBAL sample index
    `s_global` [1, L] (reference: src/gpu/camera.h:140-167). Both stream
    words mix the global pixel hash h0 with the global sample index, so
    streams are invariant to pass and lane layout. Returns (o [3,L],
    unit d [3,L], lo, hi)."""
    center, pixel00, delta_u, delta_v, disk_u, disk_v, defocus_on, _ = camc
    s_u = s_global & _U32
    lo = _pcg(h0 ^ _mul32(s_u, _GOLDEN))
    hi = _pcg(_mul32((h0 + s_u) & _U32, _GOLDEN2))
    stream = (lo, hi)
    jx = _u01(stream, 0) - 0.5
    jy = _u01(stream, 1) - 0.5
    sample_pos = pixel00 + (px + jx) * delta_u + (py + jy) * delta_v
    if defocus_on:
        disk_r = _sqrt(_u01(stream, 2))
        disk_t = _TWO_PI * _u01(stream, 3)
        o = (
            center
            + (disk_r * torch.cos(disk_t)) * disk_u
            + (disk_r * torch.sin(disk_t)) * disk_v
        )
    else:
        o = center.expand(3, sample_pos.shape[1])
    return o, _normalize3(sample_pos - o), lo, hi


def _sweep_ts(o, d, p_mat, t_min=T_MIN_EPS) -> torch.Tensor:
    """Candidate nearest-root t for every (sphere, ray) pair -> [N, L].

    `d` MUST be unit length (a = 1: roots -half_b -+ sqrt(disc)).
    NaN-as-miss: sqrt(disc < 0) is NaN — including every padding slot,
    whose r^2 = -1 makes disc <= -1 — and every compare against NaN is
    false, so those pairs fall through both selects to T_MISS."""
    o_dot_d = _dot3(o, d)
    o_sq = _dot3(o, o)
    c = p_mat.unsqueeze(-1)  # [16, N, 1]: c[row] is a column over spheres
    d_dot_c = c[_CX] * d[0:1] + c[_CY] * d[1:2] + c[_CZ] * d[2:3]
    cc_part = c[_CSQR2] + c[_M2CX] * o[0:1] + c[_M2CY] * o[1:2] + c[_M2CZ] * o[2:3]
    half_b = o_dot_d - d_dot_c
    cc = o_sq + cc_part
    disc = half_b * half_b - cc
    sqrt_d = _sqrt(disc)
    root_near = -half_b - sqrt_d
    root_far = -half_b + sqrt_d
    # Nearest root strictly beyond the shadow-acne epsilon
    # (reference: src/gpu/hittable_list.h:49-65).
    t_c = torch.where(root_near > t_min, root_near, root_far)
    return torch.where(t_c > t_min, t_c, T_MISS)


def _select_hit(p_mat, t):
    """Closest hit from the [N, L] sweep -> (t_best [1,L], params [16,L],
    index [1,L]). An indexed gather replaces the TPU's one-hot matmul;
    on an exact tie the lowest index wins. Miss lanes get params 0."""
    t_best, best = torch.min(t, dim=0, keepdim=True)
    params = torch.where(t_best < T_MISS, p_mat[:, best[0]], 0.0)
    return t_best, params, best


def _scatter_block(d, n_vec, front_face, params, stream, ctr):
    """3-material scatter on [3,L]/[1,L] blocks
    (same semantics as ray_tracing_in_one_weekend_tpu/ops/materials.py).
    `d` is unit; the returned direction is unit."""
    unit_sample = _unit_vectors(stream, ctr)
    reflect_u = _u01(stream, ctr + 4)

    mat = params[_MAT : _MAT + 1]
    albedo = params[_AR : _AB + 1]
    fuzz = params[_FUZZ : _FUZZ + 1]
    ior = params[_IOR : _IOR + 1]

    # lambertian (reference: src/gpu/material.h:24-36)
    lam_dir = n_vec + unit_sample
    lam_dir = torch.where(_dot3(lam_dir, lam_dir) < 1e-16, n_vec, lam_dir)

    # metal (reference: src/gpu/material.h:47-59)
    reflected = d - 2.0 * _dot3(d, n_vec) * n_vec
    metal_dir = reflected + fuzz * unit_sample
    metal_ok = _dot3(metal_dir, n_vec) > 0.0

    # dielectric (reference: src/gpu/material.h:70-93)
    # The sqrt guards are double-where, as in the JAX kernel: the
    # derivative of sqrt at 0 is 0/0 = NaN even under a zero cotangent,
    # and every lane evaluates every material branch, so one lane whose
    # `k` sits at 0 would poison the backward pass. The primal is the
    # single-where value bit for bit: sqrt(x) * 1 for x > 0, else 0.
    ratio = torch.where(front_face, 1.0 / ior, ior)
    cos_theta = torch.clamp(_dot3(-d, n_vec), max=1.0)
    s2 = torch.clamp(1.0 - cos_theta * cos_theta, min=0.0)
    s2_pos = s2 > 0.0
    sin_theta = _sqrt(torch.where(s2_pos, s2, 1.0)) * s2_pos
    cannot_refract = ratio * sin_theta > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    one_m_cos = 1.0 - cos_theta
    omc2 = one_m_cos * one_m_cos
    # x**5 as x * (x^2)^2: the multiplication order of JAX's integer_pow.
    schlick = r0 + (1.0 - r0) * (one_m_cos * (omc2 * omc2))
    must_reflect = cannot_refract | (schlick > reflect_u)
    r_perp = ratio * (d + cos_theta * n_vec)
    k = torch.clamp(1.0 - _dot3(r_perp, r_perp), min=0.0)
    k_pos = k > 0.0
    r_par = -(_sqrt(torch.where(k_pos, k, 1.0)) * k_pos) * n_vec
    diel_dir = torch.where(must_reflect, reflected, r_perp + r_par)

    is_lam = mat < 0.5
    is_metal = (mat >= 0.5) & (mat < 1.5)
    new_dir = torch.where(is_lam, lam_dir, torch.where(is_metal, metal_dir, diel_dir))
    new_dir = _normalize3(new_dir)
    atten = torch.where(mat >= 1.5, torch.ones_like(albedo), albedo)
    return new_dir, atten, ~is_metal | metal_ok


def _sky(d):
    """Sky radiance along unit `d` (reference: src/gpu/camera.h:118-124)."""
    sky_a = 0.5 * (d[1:2] + 1.0)
    return torch.cat(
        [(1.0 - sky_a) + sky_a * 0.5, (1.0 - sky_a) + sky_a * 0.7, (1.0 - sky_a) + sky_a * 1.0]
    )


def _surface(o, d, t, params):
    """Hit point and the normal facing the ray -> (p, n_vec, front_face).
    The SIGNED radius divides the normal, as the reference's
    (p - c) / radius does (reference: src/gpu/sphere.h:40-42)."""
    p = o + t * d
    r_signed = params[_R : _R + 1]
    inv_r = 1.0 / torch.where(r_signed.abs() > 1e-8, r_signed, 1.0)
    outward = (p - params[_CX : _CZ + 1]) * inv_r
    front_face = _dot3(d, outward) < 0.0
    return p, torch.where(front_face, outward, -outward), front_face


def _hit_and_scatter(p_mat, t_min, o, d, depth, stream):
    """Closest hit and scatter of a bounce at `depth` -> (hit, params,
    index, p, new_dir, mat_atten, ok), shared by the render and the
    backward replay so both take the same decisions."""
    t_best, params, best = _select_hit(p_mat, _sweep_ts(o, d, p_mat, t_min))
    hit = t_best < T_MISS * 0.5
    p, n_vec, front_face = _surface(o, d, torch.where(hit, t_best, 1.0), params)
    new_dir, mat_atten, ok = _scatter_block(d, n_vec, front_face, params, stream, 8 + depth * 16)
    return hit, params, best, p, new_dir, mat_atten, ok


def _bounce(p_mat, t_min, max_depth, o, d, att, rad, depth, stream):
    """One bounce of busy lanes: closest hit, sky on a miss, signed-radius
    normal, scatter. Returns (o, d, att, rad, depth, cont)."""
    hit, _, _, p, new_dir, mat_atten, ok = _hit_and_scatter(p_mat, t_min, o, d, depth, stream)
    # miss -> sky, retire
    rad = rad + torch.where(hit, 0.0, att * _sky(d))
    depth = depth + 1
    cont = hit & ok & (depth < max_depth)
    att = torch.where(cont, att * mat_atten, att)
    o = torch.where(cont, p, o)
    d = torch.where(cont, new_dir, d)
    return o, d, att, rad, depth, cont


def _pass_lanes(p_mat, camc, t_min, seed, sample_offset, budget, spp, max_depth, sf, si):
    """The plain pass over one chunk of lanes -> (of, oi)."""
    pix = si[_SI_PIX : _SI_PIX + 1].to(torch.int64)
    width = camc[-1]
    px = (pix % width).to(torch.float32)
    py = (pix // width).to(torch.float32)
    h0 = _pcg(_u32(pix) ^ _pcg(seed & _U32))

    started = si[_SI_STARTED : _SI_STARTED + 1].to(torch.int64)
    lo = _u32(si[_SI_STREAM : _SI_STREAM + 1])
    hi = _u32(si[_SI_STREAM2 : _SI_STREAM2 + 1])
    depth = si[_SI_DEPTH : _SI_DEPTH + 1].to(torch.int64)
    busy = si[_SI_BUSY : _SI_BUSY + 1] > 0
    o, d, att, rad = (sf[r : r + 3].clone() for r in (_SF_O, _SF_D, _SF_ATT, _SF_RAD))
    work = sf[_SF_WORK : _SF_WORK + 1].clone()
    iters = torch.zeros_like(work)

    def start_samples():
        """Idle lanes with samples left start their next one."""
        idx = (~busy & (started < spp))[0].nonzero()[:, 0]
        if idx.numel() == 0:
            return
        o2, d2, lo2, hi2 = _camera_ray_block(
            camc, h0[:, idx], px[:, idx], py[:, idx], started[:, idx] + sample_offset
        )
        o[:, idx], d[:, idx], lo[:, idx], hi[:, idx] = o2, d2, lo2, hi2
        started[:, idx] += 1
        depth[:, idx] = 0
        att[:, idx] = 1.0
        busy[:, idx] = True

    # Each lane: start a sample if idle, then one bounce per iteration
    # while busy and within the budget; a lane that retires with samples
    # left starts the next one in the same iteration. Lanes are
    # independent, so each step computes only the busy ones.
    start_samples()
    for _ in range(budget):
        idx = busy[0].nonzero()[:, 0]
        if idx.numel() == 0:
            break
        work[:, idx] += 1.0
        iters[:, idx] += 1.0
        o_i, d_i, att_i, rad_i, depth_i, cont = _bounce(
            p_mat, t_min, max_depth, o[:, idx], d[:, idx], att[:, idx],
            rad[:, idx], depth[:, idx], (lo[:, idx], hi[:, idx]),
        )
        o[:, idx], d[:, idx], att[:, idx], rad[:, idx] = o_i, d_i, att_i, rad_i
        depth[:, idx] = depth_i
        busy[:, idx] = cont
        start_samples()

    of = torch.zeros_like(sf)
    of[_SF_O : _SF_O + 3] = o
    of[_SF_D : _SF_D + 3] = d
    of[_SF_ATT : _SF_ATT + 3] = att
    of[_SF_RAD : _SF_RAD + 3] = rad
    of[_SF_ITERS] = iters[0]
    of[_SF_WORK] = work[0]
    oi = torch.zeros_like(si)
    oi[_SI_PIX] = si[_SI_PIX]
    oi[_SI_STARTED] = started[0].to(torch.int32)
    oi[_SI_STREAM] = _as_i32(lo[0])
    oi[_SI_DEPTH] = depth[0].to(torch.int32)
    oi[_SI_BUSY] = busy[0].to(torch.int32)
    oi[_SI_STREAM2] = _as_i32(hi[0])
    return of, oi


def _render_pass_plain(p_mat, cam_vec, scalars, sf, si, tile, spp, max_depth):
    """One budgeted pass over the lane state, in plain PyTorch.

    The same computation as `csrc/render_kernel.cu`, vectorized over
    lanes in chunks (lanes are independent, so chunking and `tile` change
    no result). `scalars` = (seed, pixel_offset, sample_offset, budget)
    ints; `sf` [SF_ROWS, P] f32 and `si` [SI_ROWS, P] i32 in, the
    advanced (of, oi) out."""
    del tile  # lanes are independent: the block size changes nothing
    seed, _pixel_offset, sample_offset, budget = (int(v) for v in scalars)
    camc = _unpack_cam(cam_vec)
    t_min = float(cam_vec[20])
    of, oi = torch.empty_like(sf), torch.empty_like(si)
    chunk = _PLAIN_CHUNK.get(sf.device.type, _PLAIN_CHUNK["cpu"])
    for a in range(0, sf.shape[1], chunk):
        of[:, a : a + chunk], oi[:, a : a + chunk] = _pass_lanes(
            p_mat, camc, t_min, seed, sample_offset, budget, spp, max_depth,
            sf[:, a : a + chunk], si[:, a : a + chunk],
        )
    return of, oi


def _render_pass(p_mat, cam_vec, scalars, sf, si, tile, spp, max_depth):
    """One pass: the CUDA kernel for CUDA tensors (it raises if it cannot
    launch; there is no fallback), the plain version for CPU tensors."""
    if sf.device.type == "cuda":
        from ray_tracing_in_one_weekend_tpu_torch.kernels import build

        return build.render_pass(
            p_mat.T.contiguous(), cam_vec, scalars, sf, si, tile, spp, max_depth
        )
    return _render_pass_plain(p_mat, cam_vec, scalars, sf, si, tile, spp, max_depth)


def _init_state(pixel_offset, padded, n_pixels_total, spp, device=None):
    """Fresh lane state for `padded` lanes with global pixel ids
    pixel_offset + [0, padded). Lanes beyond the image are born finished
    (started = spp, not busy)."""
    pix = pixel_offset + torch.arange(padded, dtype=torch.int32, device=device)
    sf = torch.zeros((SF_ROWS, padded), dtype=torch.float32, device=device)
    si = torch.zeros((SI_ROWS, padded), dtype=torch.int32, device=device)
    si[_SI_PIX] = pix
    si[_SI_STARTED] = torch.where(pix < n_pixels_total, 0, spp).to(torch.int32)
    return sf, si



# ---------------------------------------------------------------------------
# The lane scheduler (ops/pallas_render.py:763-1220).
# ---------------------------------------------------------------------------

# Lanes per block of the compaction's global reorder: the TPU's vector-lane
# row, and four warps here. A tile is a whole number of blocks
# (`_check_tile`).
_BLOCK = 128


@spanned("rt.sched.compact")
def _compact(sf, si, tile, spp):
    """Tail compaction: unfinished lanes to dense front blocks, without a
    global lane sort -> (sf, si, inv) with inv [P] int64, the inverse of
    the lane permutation applied (lane inv[j] now holds what lane j held).

    Two levels, as the JAX package's `_compact`: a stable sort of each
    tile's lanes (unfinished first, most remaining work first), then a
    stable sort of the 128-lane blocks by descending total remaining work.
    The remaining-work estimate of a lane is its bounce rate so far
    (`_SF_WORK` over samples started) times the samples it has left. Pure
    lane permutation: each lane carries its pixel id, so no pixel changes.
    Index for index the JAX function's permutation on the same state."""
    _check_tile(tile)
    padded = sf.shape[1]
    n_tiles, n_blocks = padded // tile, padded // _BLOCK
    started = si[_SI_STARTED]
    unfinished = (si[_SI_BUSY] > 0) | (started < spp)
    remaining = (sf[_SF_WORK] / started.to(torch.float32).clamp_min(1.0)) * (
        spp - started + si[_SI_BUSY]
    ).to(torch.float32)
    # 1. Per tile: unfinished lanes first, deepest remaining work first.
    lane_key = torch.where(unfinished, -remaining, torch.inf)
    lane_order = torch.argsort(lane_key.reshape(n_tiles, tile), dim=1, stable=True)
    # 2. Blocks by descending total remaining work; dead blocks last.
    rem_sorted = torch.gather(
        torch.where(unfinished, remaining, 0.0).reshape(n_tiles, tile), 1, lane_order
    )
    block_order = torch.argsort(-rem_sorted.reshape(n_blocks, _BLOCK).sum(dim=1), stable=True)
    # The flat permutation: new lane i holds old lane perm[i].
    base = torch.arange(n_tiles, device=sf.device)[:, None] * tile
    perm = (base + lane_order).reshape(n_blocks, _BLOCK)[block_order].reshape(-1)
    return sf[:, perm], si[:, perm], _inverse(perm)


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    """Inverse of a permutation by one scatter (no argsort), along the last
    dimension."""
    inv = torch.empty_like(perm)
    ramp = torch.arange(perm.shape[-1], device=perm.device).expand_as(perm)
    return inv.scatter_(-1, perm, ramp)


def _multipass(p_mat, cam_vec, scalars, sf, si, tile, spp, max_depth, budget, n_passes, pass_fn,
               work_hint=None, work_perm=None):
    """`n_passes` passes over one lane buffer with tail compaction between
    them -> (radiance / spp [3, P], work [P]) in pixel order.

    Each pass but the last stops after its budget (`budget`: an int, or a
    tuple with one entry per budgeted pass); the last is unbudgeted
    (spp * max_depth bounds any lane's queue). Between passes `_compact`
    packs the unfinished lanes into the front blocks, so the next pass
    runs them side by side while the finished blocks exit at once.

    Before the first pass the lanes may be permuted: by `work_perm` =
    (perm, inv) [P] (lane i runs pixel perm[i], the fully cost-sorted
    order of `_perm_from_hint`), or else by `work_hint` [P], a per-pixel
    cost that seeds the compaction's remaining-work estimate (the row is
    cleared after). The inverses compose pass by pass into one gather at
    the end. No schedule changes a pixel: each lane reads its pixel id
    from its state."""
    seed, pixel_offset, sample_offset, _ = scalars
    inv_total = None
    if work_perm is not None:
        perm, inv_total = work_perm
        sf, si = sf[:, perm], si[:, perm]
    elif work_hint is not None:
        sf = sf.clone()
        sf[_SF_WORK] = work_hint
        sf, si, inv_total = _compact(sf, si, tile, spp)
        sf[_SF_WORK] = 0.0
    for p in range(n_passes):
        last = p == n_passes - 1
        b = spp * max_depth if last else budget[p] if isinstance(budget, (tuple, list)) else budget
        with span("rt.sched.pass"):
            sf, si = pass_fn(
                p_mat, cam_vec, (seed, pixel_offset, sample_offset, b),
                sf, si, tile, spp, max_depth,
            )
        if not last:
            sf, si, inv = _compact(sf, si, tile, spp)
            # Lane inv_total[j] holds pixel j: compose this pass's inverse.
            inv_total = inv if inv_total is None else inv[inv_total]
    rad, work = sf[_SF_RAD : _SF_RAD + 3], sf[_SF_WORK]
    if inv_total is not None:
        rad, work = rad[:, inv_total], work[inv_total]
    return rad * (1.0 / spp), work


def _cost_perm(cost: torch.Tensor) -> torch.Tensor:
    """Lane permutation by descending cost (stable): lane i runs pixel
    perm[i], so each block holds paths of similar length. Zero-cost pad
    lanes sink to the tail blocks, which finish at once."""
    return torch.argsort(-cost, stable=True)


def _perm_from_hint(hint: torch.Tensor, n_slabs: int = 1) -> torch.Tensor:
    """Cost map [total] -> stacked (perm, inverse) [2, n_slabs, slab] int64
    with SLAB-LOCAL indices: each slab's lanes sorted by descending cost
    (lanes never cross slabs; `n_slabs=1` is the global sort). One argsort
    of the whole map, run once per scene when the warm cache is filled."""
    local = _cost_perm(hint.reshape(n_slabs, -1))
    return torch.stack([local, _inverse(local)])


# Passes of a render with no permutation (the last one unbudgeted); 1
# disables compaction. Measured on an H100 80GB HBM3 (700 W) at the bench
# preset by chip_smoke.py phase 8, best of 7 interleaved rounds: 24.00 ms
# for 1 pass, 23.44 for 2, 24.89 for 3 (the JAX package's default), 27.67
# for 4. Each pass after the second runs fewer lanes than fill the card,
# for up to ~175 iterations, so it costs more than its warp-iterations.
DEFAULT_PASSES = 2


def _default_budget(spp: int) -> int:
    return max(16, 3 * spp)


def _check_tile(tile: int) -> None:
    if tile <= 0 or tile % 128 != 0:
        raise ValueError(f"tile ({tile}) must be a positive multiple of 128")


# ---------------------------------------------------------------------------
# Warm start: the per-(scene, camera) schedule cache
# (ops/pallas_render.py:1035-1107).
#
# Maps an identity key to the cost-sorted lane permutation derived from the
# last cold render's per-pixel cost map, and the (seed, sample_offset) of
# that render. A later render of the same key applies the permutation and
# runs ONE pass, but only when it re-renders the same noise realization
# (same seed and sample window): for another realization the JAX package
# measured a stale permutation slower than the cold compaction schedule,
# so such a render runs cold and refills the entry. A stale or wrong hit
# can only cost time, never a pixel, which is why identity (tensor ids and
# the camera's bytes), not content, is a sufficient key.
# ---------------------------------------------------------------------------
_WORK_CACHE: OrderedDict = OrderedDict()
_WORK_CACHE_MAX = 8


def _warm_cache_get(key, seed: int, sample_offset: int):
    """The cached [2, P] permutation, or None unless the fill's (seed,
    sample_offset) match this render's."""
    entry = _WORK_CACHE.get(key)
    if entry is None:
        return None
    perm_inv, fill_seed, fill_offset = entry
    if fill_seed != seed or fill_offset != sample_offset:
        return None
    return perm_inv


def _warm_cache_key(scene: Scene, cam_bytes: bytes, padded: int, tile: int, extra=()):
    """Identity key of the schedule cache, or None when the render must not
    use it: a scene tensor that requires grad (autograd records the render,
    as for the differentiable render's inputs; the JAX package returns None
    for a tracer) or a TorchScript trace in progress."""
    if torch.jit.is_tracing() or any(
        getattr(scene, f).requires_grad
        for f in ("center", "radius", "albedo", "fuzz", "ior")
    ):
        return None
    return (id(scene.center), id(scene.radius), scene.num_slots, cam_bytes, padded, tile, *extra)


def _warm_cache_put(key, perm_inv, seed: int, sample_offset: int) -> None:
    _WORK_CACHE[key] = (perm_inv, seed, sample_offset)
    _WORK_CACHE.move_to_end(key)
    while len(_WORK_CACHE) > _WORK_CACHE_MAX:
        _WORK_CACHE.popitem(last=False)


def _cache_key_for(scene, cam_vec, padded, tile, spp, mesh=None):
    # spp is part of the key: a cost map measured at another spp is a noisy
    # estimate of this render's (the JAX package's policy). On a mesh the
    # key adds its shape and this rank's coordinates: the entry holds this
    # rank's slab.
    extra = (spp,) if mesh is None else (
        spp, mesh.pixels, mesh.samples, mesh.pixel_index, mesh.sample_index)
    with sync("cam_key"):
        cam_bytes = cam_vec.cpu().numpy().tobytes()
    return _warm_cache_key(scene, cam_bytes, padded, tile, extra=extra)


def _rank_share(n_pixels: int, tile: int, spp: int, sample_offset: int, mesh):
    """This rank's share of a render -> (first pixel, lanes, samples, first
    sample): the image's flat pixel space split into P contiguous,
    tile-aligned slabs of ceil(n / (P * tile)) * tile pixels
    (ops/pallas_render.py:1365), and the spp split into S windows. Without
    a mesh, one slab of every pixel and every sample."""
    n_pix, n_smp = (1, 1) if mesh is None else (mesh.pixels, mesh.samples)
    if spp % n_smp != 0:
        raise ValueError(f"samples_per_pixel={spp} must divide evenly over the 'samples' mesh "
                         f"axis of size {n_smp}")
    shard = -(-n_pixels // (n_pix * tile)) * tile
    spp_local = spp // n_smp
    if mesh is None:
        return 0, shard, spp_local, sample_offset
    return mesh.pixel_index * shard, shard, spp_local, sample_offset + mesh.sample_index * spp_local


def _slab_hint(work_hint, n_pixels, start, shard, device):
    """A per-pixel cost map ([H, W] or flat) -> this slab's [shard] part,
    zero past the image."""
    flat = work_hint.reshape(-1)[:n_pixels].to(device=device, dtype=torch.float32)
    hint = torch.zeros(shard, dtype=torch.float32, device=device)
    live = flat[start : start + shard]
    hint[: live.numel()] = live
    return hint


def warm_cache_hit(scene: Scene, cam: Camera, seed: int = 0, tile: int = DEFAULT_TILE,
                   spp: int | None = None, sample_offset: int = 0, t_min: float = T_MIN_EPS,
                   mesh=None) -> bool:
    """Whether `render_cuda` (or `render_cuda_distributed` on `mesh`) with
    these arguments and `warm=True` would run the cached warm schedule (one
    pass over cost-sorted lanes) on this rank."""
    spp = cam.samples_per_pixel if spp is None else spp
    _, shard, _, _ = _rank_share(cam.num_pixels, tile, spp, sample_offset, mesh)
    key = _cache_key_for(scene, pack_camera(cam, t_min), shard, tile, spp, mesh)
    return key is not None and _warm_cache_get(key, seed, sample_offset) is not None


@spanned("rt.sched.render")
def render_with(
    pass_fn,
    scene: Scene,
    cam: Camera,
    seed: int = 0,
    tile: int = DEFAULT_TILE,
    spp: int | None = None,
    max_depth: int | None = None,
    n_passes: int | None = None,
    budget: int | tuple | None = None,
    sample_offset: int = 0,
    work_hint: torch.Tensor | None = None,
    return_work: bool = False,
    warm: bool = True,
    t_min: float = T_MIN_EPS,
    mesh=None,
):
    """`render_cuda` (`render_cuda_distributed` with a `mesh`) with an
    explicit pass function (`_render_pass`, `_render_pass_plain`): how a
    check runs the plain version on the card.

    The lanes are this rank's slab: global pixel ids [start, start +
    shard), the whole padded image without a mesh. The rank renders its
    sample window, and the mesh's collectives turn the slabs into the
    image on every rank."""
    _check_tile(tile)
    spp = cam.samples_per_pixel if spp is None else spp
    max_depth = cam.max_depth if max_depth is None else max_depth
    w, h = cam.image_width, cam.image_height
    n_pixels = cam.num_pixels
    start, shard, spp_local, window = _rank_share(n_pixels, tile, spp, sample_offset, mesh)
    device = scene.device

    p_mat = pack_scene(scene)
    cam_vec = pack_camera(cam, t_min).to(device)
    work_perm, cache_key = None, None
    if work_hint is not None:
        hint = _slab_hint(work_hint, n_pixels, start, shard, device)
        work_perm = _perm_from_hint(hint).reshape(2, shard)
    elif warm:
        cache_key = _cache_key_for(scene, cam_vec, shard, tile, spp, mesh)
        if cache_key is not None:
            work_perm = _warm_cache_get(cache_key, seed, sample_offset)
    if n_passes is None:
        n_passes = 1 if work_perm is not None else DEFAULT_PASSES
    if n_passes < 1:
        raise ValueError(f"n_passes ({n_passes}) must be >= 1")
    budget = _default_budget(spp_local) if budget is None else budget
    if isinstance(budget, (tuple, list)):
        budget = tuple(budget)
        if len(budget) < n_passes - 1:
            raise ValueError(
                f"budget schedule has {len(budget)} entries but n_passes={n_passes} "
                f"needs {n_passes - 1} budgeted passes"
            )

    sf, si = _init_state(start, shard, n_pixels, spp_local, device)
    rad, work = _multipass(
        p_mat, cam_vec, (seed, start, window, 0), sf, si, tile, spp_local, max_depth,
        budget, n_passes, pass_fn, work_perm=work_perm,
    )
    if mesh is not None:
        # The sample windows' mean; the cost map too, so that every rank of
        # a pixel group sorts its lanes alike.
        rad, work = mesh.sample_mean(rad), mesh.sample_mean(work)
    if cache_key is not None and work_perm is None:
        # Once per (scene, realization): the full cost sort of this slab.
        with span("rt.sched.cache_fill"):
            _warm_cache_put(cache_key, _perm_from_hint(work).reshape(2, shard), seed, sample_offset)
    if mesh is not None:
        rad, work = mesh.gather_pixels(rad), mesh.gather_pixels(work)
    img = rad[:, :n_pixels].T.reshape(h, w, 3)
    if return_work:
        return img, work[:n_pixels].reshape(h, w)
    return img


def render_cuda(
    scene: Scene,
    cam: Camera,
    seed: int = 0,
    tile: int = DEFAULT_TILE,
    spp: int | None = None,
    max_depth: int | None = None,
    n_passes: int | None = None,
    budget: int | tuple | None = None,
    sample_offset: int = 0,
    work_hint: torch.Tensor | None = None,
    return_work: bool = False,
    warm: bool = True,
    t_min: float = T_MIN_EPS,
):
    """Render the full image -> [H, W, 3] float32 on the scene's device.

    On a CUDA scene every pass launches the hand-written kernel
    (`csrc/render_kernel.cu`); on a CPU scene it runs the plain version.
    `sample_offset` starts the global sample streams at that index:
    rendering [0, k) then [k, k+n) and averaging equals one (k+n)-sample
    render. With `return_work`, also returns the per-pixel busy-iteration
    count [H, W]. `t_min` is the shadow-acne epsilon (reference:
    src/cpu/main.cc:19).

    Scheduling never changes a pixel. `n_passes`/`budget` (an int, or a
    tuple per budgeted pass) split the work into passes with tail
    compaction between them. Warm start (the default): the first render
    of a scene, camera, spp and tile caches the cost-sorted lane
    permutation of its cost map, and a later render of the same seed and
    `sample_offset` runs one pass over those lanes; another realization
    runs cold and refills the entry. `warm=False` skips the cache; an
    explicit `work_hint` (a previous `return_work` map, [H, W] or flat)
    sorts by that map instead. With a permutation `n_passes` defaults to
    1, without one to `DEFAULT_PASSES`."""
    return render_with(
        _render_pass, scene, cam, seed=seed, tile=tile, spp=spp,
        max_depth=max_depth, n_passes=n_passes, budget=budget,
        sample_offset=sample_offset, work_hint=work_hint, return_work=return_work,
        warm=warm, t_min=t_min,
    )


def render_cuda_distributed(
    scene: Scene,
    cam: Camera,
    seed: int = 0,
    mesh=None,
    tile: int = DEFAULT_TILE,
    spp: int | None = None,
    max_depth: int | None = None,
    n_passes: int | None = None,
    budget: int | tuple | None = None,
    sample_offset: int = 0,
    work_hint: torch.Tensor | None = None,
    return_work: bool = False,
    warm: bool = True,
    t_min: float = T_MIN_EPS,
):
    """Render the full image sharded over `mesh` (`parallel/dist.py`;
    default: every rank on the pixel axis) -> [H, W, 3] float32, the whole
    image on every rank, on the scene's device.

    The counterpart of `render_pallas_distributed`
    (ops/pallas_render.py:1306-1411). Each rank runs the lane scheduler on
    its slab of ceil(n / (P * tile)) * tile pixels and its sample window of
    spp / S samples: the kernel on a CUDA scene, the plain version on a CPU
    scene. Compaction stays inside the slab. The sample axis is averaged in
    rank order and the slabs are gathered (the mesh's fixed-order
    collectives). A pixel mesh gives `render_cuda`'s image bit for bit, a
    sample mesh the windows rendered on one device and averaged in rank
    order. `spp % S != 0` raises.

    Warm start as in `render_cuda`, per rank: the cache key adds the mesh's
    shape and the rank's coordinates, and each rank caches its slab's
    permutation of the cost map averaged over the sample axis. A
    `work_hint` is the whole image's map; each rank takes its slab. With
    `return_work`, the cost map [H, W] (averaged over the sample axis)
    comes back too."""
    if mesh is None:
        from ray_tracing_in_one_weekend_tpu_torch.parallel.dist import make_mesh

        mesh = make_mesh()
    return render_with(
        _render_pass, scene, cam, seed=seed, tile=tile, spp=spp,
        max_depth=max_depth, n_passes=n_passes, budget=budget,
        sample_offset=sample_offset, work_hint=work_hint, return_work=return_work,
        warm=warm, t_min=t_min, mesh=mesh,
    )
