"""Plain reference of the port's PCG render: camera rays, streams, sweep,
materials, sky and the per-pixel sample mean.

A frozen copy of the arithmetic that the port's lane kernel
(`render_kernel`) and its plain version carry, written as a
straightforward path tracer: every (pixel, sample) ray is traced side by
side, bounce after bounce, and each pixel adds its samples' radiance in
sample order. The operations and their order are the kernel's (it is
built without FMA contraction), so on the card the result is the
kernel's bits; any schedule, pass split or lane order of the program
gives the same pixels.

`dtype` is the precision of every floating-point operation: float32 is
the configuration's precision, bfloat16 the control's. The random
streams are integer arithmetic and the same in both.

Nothing here imports the port.
"""

from __future__ import annotations

import math

import torch

T_MISS = 1e30
T_MIN_EPS = 1e-3

# Rows of the packed scene [16, N].
(_CX, _CY, _CZ, _R, _R2, _AR, _AG, _AB, _FUZZ, _IOR, _MAT, _ACTIVE,
 _M2CX, _M2CY, _M2CZ, _CSQR2) = range(16)

_U32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_GOLDEN2 = 0x85EBCA6B
_TWO_PI = 2.0 * math.pi

# Rays a block of the [N, rays] sweep: bounds its temporaries.
RAYS_PER_BLOCK = 1 << 16


def pack_scene(scene: dict, dtype=torch.float32) -> torch.Tensor:
    """Scene arrays -> [16, N]: inactive slots get center 0 and r^2 = -1, so
    the sweep's discriminant is negative for every unit ray."""
    act = scene["active"]
    actf = act.to(torch.float32)
    center = scene["center"] * actf[:, None]
    radius = scene["radius"]
    r2 = torch.where(act, radius * radius, torch.full_like(radius, -1.0))
    rows = torch.zeros((16, center.shape[0]), dtype=torch.float32, device=center.device)
    rows[_CX:_CZ + 1] = center.T
    rows[_R] = radius
    rows[_R2] = r2
    rows[_AR:_AB + 1] = scene["albedo"].T
    rows[_FUZZ] = scene["fuzz"]
    rows[_IOR] = scene["ior"]
    rows[_MAT] = scene["mat_type"].to(torch.float32)
    rows[_ACTIVE] = actf
    rows[_M2CX:_M2CZ + 1] = -2.0 * center.T
    c = center
    rows[_CSQR2] = (c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2]) - r2
    return rows.to(dtype)


def _mul32(a, b: int):
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _U32


def _pcg(x):
    state = (_mul32(x, 747796405) + 2891336453) & _U32
    word = _mul32((state >> ((state >> 28) + 4)) ^ state, 277803737)
    return (word >> 22) ^ word


def _u01(stream, counter, dtype):
    """One U(0, 1) a ray from its stream (lo, hi) and a draw counter."""
    lo, hi = stream
    bits = _pcg((_pcg(lo ^ _mul32(counter, _GOLDEN)) + hi) & _U32)
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24)) + (0.5 / (1 << 24))
    return u.to(dtype)


def _sqrt(x):
    """IEEE sqrt, correctly rounded in x's precision."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def _dot3(a, b):
    return a[0:1] * b[0:1] + a[1:2] * b[1:2] + a[2:3] * b[2:3]


def _normalize3(v):
    return v * torch.rsqrt(torch.clamp(_dot3(v, v), min=1e-20))


def _unit_vectors(stream, counter, dtype):
    z = 2.0 * _u01(stream, counter, dtype) - 1.0
    phi = _TWO_PI * _u01(stream, counter + 1, dtype)
    s = _sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.cat([s * torch.cos(phi), s * torch.sin(phi), z], dim=0)


def camera_rays(cam: dict, pix, s_global, seed: int, dtype):
    """Camera rays (o [3, L], unit d [3, L]) and the streams (lo, hi) of
    global pixels `pix` [L] at global samples `s_global` [L]."""
    width = cam["width"]
    px = (pix % width).to(torch.float32).to(dtype)[None]
    py = (pix // width).to(torch.float32).to(dtype)[None]
    h0 = _pcg((pix & _U32) ^ _pcg(seed & _U32))[None]
    s_u = s_global[None] & _U32
    lo = _pcg(h0 ^ _mul32(s_u, _GOLDEN))
    hi = _pcg(_mul32((h0 + s_u) & _U32, _GOLDEN2))
    stream = (lo, hi)

    def col(name):
        return cam[name].to(dtype).reshape(3, 1)

    jx = _u01(stream, 0, dtype) - 0.5
    jy = _u01(stream, 1, dtype) - 0.5
    sample_pos = col("pixel00_loc") + (px + jx) * col("pixel_delta_u") + (py + jy) * col("pixel_delta_v")
    if float(cam["defocus_angle"]) > 0.0:
        disk_r = _sqrt(_u01(stream, 2, dtype))
        disk_t = _TWO_PI * _u01(stream, 3, dtype)
        o = col("center") + (disk_r * torch.cos(disk_t)) * col("defocus_disk_u") \
            + (disk_r * torch.sin(disk_t)) * col("defocus_disk_v")
    else:
        o = col("center").expand(3, sample_pos.shape[1])
    return o, _normalize3(sample_pos - o), stream


def _sweep(o, d, p_mat, t_min):
    """Nearest root beyond t_min of every (sphere, ray) pair -> [N, L];
    T_MISS where none (sqrt of a negative discriminant is NaN, and NaN
    fails every compare)."""
    o_dot_d = _dot3(o, d)
    o_sq = _dot3(o, o)
    c = p_mat.unsqueeze(-1)
    d_dot_c = c[_CX] * d[0:1] + c[_CY] * d[1:2] + c[_CZ] * d[2:3]
    cc_part = c[_CSQR2] + c[_M2CX] * o[0:1] + c[_M2CY] * o[1:2] + c[_M2CZ] * o[2:3]
    half_b = o_dot_d - d_dot_c
    disc = half_b * half_b - (o_sq + cc_part)
    sqrt_d = _sqrt(disc)
    root_near = -half_b - sqrt_d
    root_far = -half_b + sqrt_d
    t_c = torch.where(root_near > t_min, root_near, root_far)
    return torch.where(t_c > t_min, t_c, T_MISS)


def _closest(o, d, p_mat, t_min):
    """The nearest root and its sphere of each ray -> ([1, L], [1, L]), the
    sweep taken RAYS_PER_BLOCK rays at a time (the lowest index on a tie)."""
    parts = [torch.min(_sweep(o[:, a:a + RAYS_PER_BLOCK], d[:, a:a + RAYS_PER_BLOCK], p_mat, t_min), dim=0,
                       keepdim=True) for a in range(0, o.shape[1], RAYS_PER_BLOCK)]
    return torch.cat([t for t, _ in parts], dim=1), torch.cat([i for _, i in parts], dim=1)


def _scatter(d, n_vec, front_face, params, stream, ctr, dtype):
    """Lambertian, metal and dielectric scatter of unit `d` about `n_vec`
    -> (unit direction, attenuation, scattered)."""
    unit_sample = _unit_vectors(stream, ctr, dtype)
    reflect_u = _u01(stream, ctr + 4, dtype)
    mat = params[_MAT:_MAT + 1]
    albedo = params[_AR:_AB + 1]
    fuzz = params[_FUZZ:_FUZZ + 1]
    ior = params[_IOR:_IOR + 1]

    lam_dir = n_vec + unit_sample
    lam_dir = torch.where(_dot3(lam_dir, lam_dir) < 1e-16, n_vec, lam_dir)

    reflected = d - 2.0 * _dot3(d, n_vec) * n_vec
    metal_dir = reflected + fuzz * unit_sample
    metal_ok = _dot3(metal_dir, n_vec) > 0.0

    ratio = torch.where(front_face, 1.0 / ior, ior)
    cos_theta = torch.clamp(_dot3(-d, n_vec), max=1.0)
    s2 = torch.clamp(1.0 - cos_theta * cos_theta, min=0.0)
    s2_pos = s2 > 0.0
    sin_theta = _sqrt(torch.where(s2_pos, s2, 1.0)) * s2_pos
    cannot_refract = ratio * sin_theta > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    omc = 1.0 - cos_theta
    omc2 = omc * omc
    schlick = r0 + (1.0 - r0) * (omc * (omc2 * omc2))
    must_reflect = cannot_refract | (schlick > reflect_u)
    r_perp = ratio * (d + cos_theta * n_vec)
    k = torch.clamp(1.0 - _dot3(r_perp, r_perp), min=0.0)
    k_pos = k > 0.0
    r_par = -(_sqrt(torch.where(k_pos, k, 1.0)) * k_pos) * n_vec
    diel_dir = torch.where(must_reflect, reflected, r_perp + r_par)

    is_lam = mat < 0.5
    is_metal = (mat >= 0.5) & (mat < 1.5)
    new_dir = _normalize3(torch.where(is_lam, lam_dir, torch.where(is_metal, metal_dir, diel_dir)))
    atten = torch.where(mat >= 1.5, torch.ones_like(albedo), albedo)
    return new_dir, atten, ~is_metal | metal_ok


def _sky(d):
    a = 0.5 * (d[1:2] + 1.0)
    return torch.cat([(1.0 - a) + a * 0.5, (1.0 - a) + a * 0.7, (1.0 - a) + a * 1.0])


def trace(p_mat, o, d, stream, max_depth, dtype, t_min=T_MIN_EPS):
    """Radiance [3, L] of the rays, and the sweeps [L] each ran (one a
    bounce). A miss adds the sky times the attenuation and ends the path;
    an absorbed path or one out of bounces ends dark."""
    lo, hi = stream
    n = o.shape[1]
    rad = torch.zeros(3, n, dtype=dtype, device=o.device)
    att = torch.ones(3, n, dtype=dtype, device=o.device)
    work = torch.zeros(n, dtype=torch.int64, device=o.device)
    live = torch.arange(n, device=o.device)
    for depth in range(max_depth):
        work[live] += 1
        t_best, best = _closest(o, d, p_mat, t_min)
        hit = t_best < T_MISS * 0.5
        params = torch.where(t_best < T_MISS, p_mat[:, best[0]], 0.0)
        t = torch.where(hit, t_best, 1.0)
        p = o + t * d
        r_signed = params[_R:_R + 1]
        outward = (p - params[_CX:_CZ + 1]) * (1.0 / torch.where(r_signed.abs() > 1e-8, r_signed, 1.0))
        front = _dot3(d, outward) < 0.0
        n_vec = torch.where(front, outward, -outward)
        new_dir, mat_att, ok = _scatter(d, n_vec, front, params, (lo[:, live], hi[:, live]), 8 + 16 * depth,
                                        dtype)
        rad[:, live] = rad[:, live] + torch.where(hit, 0.0, att * _sky(d))
        keep = (hit & ok)[0].nonzero()[:, 0]
        if depth + 1 == max_depth or keep.numel() == 0:
            break
        live = live[keep]
        o, d, att = p[:, keep], new_dir[:, keep], (att * mat_att)[:, keep]
    return rad, work


def sample_radiance(p_mat, cam: dict, pix, seed: int, s0: int, ns: int, max_depth: int, dtype=torch.float32):
    """Each sample's radiance [ns, R, 3] of global samples [s0, s0 + ns) of
    global pixels `pix` [R], and the sweeps [ns, R] each ran: every ray
    traced side by side."""
    r = pix.numel()
    s_global = torch.arange(s0, s0 + ns, device=pix.device).repeat_interleave(r)
    o, d, stream = camera_rays(cam, pix.repeat(ns), s_global, seed, dtype)
    rad, work = trace(p_mat, o, d, stream, max_depth, dtype)
    return rad.view(3, ns, r).permute(1, 2, 0), work.view(ns, r)


def fold(rad, spp: int):
    """The samples' radiance [spp, R, 3] added in sample order and scaled by
    1 / spp, as the lane kernel does."""
    acc = torch.zeros_like(rad[0])
    for s in range(rad.shape[0]):
        acc = acc + rad[s]
    return acc * (1.0 / spp)


def render_pixels(p_mat, cam: dict, pix, seed: int, spp: int, sample_offset: int, max_depth: int,
                  dtype=torch.float32):
    """Samples [sample_offset, sample_offset + spp) of global pixels `pix`
    [R] -> (the sample mean [R, 3], the sweeps [R] each pixel ran)."""
    rad, work = sample_radiance(p_mat, cam, pix, seed, sample_offset, spp, max_depth, dtype)
    return fold(rad, spp), work.sum(0)
