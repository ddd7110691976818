"""Plain reference of the port's keyed render and its gradient: the JAX
package's jnp path tracer on threefry2x32 keys.

A frozen copy of the arithmetic that `threefry_render_kernel` and the
keyed train step's kernels carry, as a straightforward path tracer under
torch.autograd:

* keys: sample s of global pixel p draws from k = fold_in(fold_in(base,
  p), sample_offset + s); the camera from fold_in(k, 0), the bounces from
  fold_in(k, 1); bounce i takes five uniforms from fold_in(., i);
* camera rays with a +-0.5 pixel jitter and the defocus disk, directions
  not normalized;
* the sphere sweep of every ray against every sphere, the nearest root in
  (1e-3, 1e30), inactive slots masked, the lowest index on a tie;
* lambertian, metal and dielectric scatter, the sky, 50 bounces;
* each pixel's samples added in sample order and divided by spp.

The program's operations round as XLA's CPU code does, with a product
that feeds an add fused into one multiply-add. Here such an `fma` is
computed in float64 and rounded once to float32, which is the fused
result except where the double rounding meets a tie (about one operation
in 2^29). The sweep runs on detached inputs; the winner's t is computed
again from its sphere's parameters with a gradient, so autograd records
no [rays, spheres] tensor (the argmin is locally constant).

`dtype=torch.bfloat16` computes every floating-point operation in
bfloat16 instead, products and adds unfused: the control.

Nothing here imports the port.
"""

from __future__ import annotations

import math

import torch

T_MISS = 1e30
T_MIN_EPS = 1e-3
CAMERA_DOMAIN = 1 << 20
LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2
SKY_BLUE = (0.5, 0.7, 1.0)
_TWO_PI = 2.0 * math.pi
_U32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA

# Rays a block of the [rays, spheres] sweep.
SWEEP_BLOCK = 1 << 15


# ---------------------------------------------------------------------------
# threefry2x32 on uint32 words held in int64 tensors.
# ---------------------------------------------------------------------------


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _U32


def threefry_2x32(k, x0, x1):
    k0, k1 = k
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _U32
    x1 = (x1 + ks[1]) & _U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _U32
    return x0, x1


def fold_in(k, data):
    if isinstance(data, torch.Tensor):
        return threefry_2x32(k, 0, data.to(torch.int64) & _U32)
    return threefry_2x32(k, 0, int(data) & _U32)


def uniforms(keys, n: int, domain: int, dtype):
    """n U[0, 1) a key from fold_in(key, domain) -> [R, n]: the top 23 bits
    of bits0 ^ bits1 at counters 0..n-1 as a float in [1, 2), minus 1."""
    k0, k1 = fold_in(keys, domain)
    count = torch.arange(n, dtype=torch.int64, device=k0.device)
    b0, b1 = threefry_2x32((k0[:, None], k1[:, None]), 0, count)
    floats = (((b0 ^ b1) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return floats.to(dtype)


# ---------------------------------------------------------------------------
# Arithmetic.
# ---------------------------------------------------------------------------


class Arith:
    """The rounding of one precision: float32 with fused multiply-adds, or
    bfloat16 with every operation rounded."""

    def __init__(self, dtype):
        self.dtype = dtype
        self.exact = dtype == torch.float32

    def fma(self, a, b, c):
        device = next(x.device for x in (a, b, c) if isinstance(x, torch.Tensor))
        a, b, c = (x if isinstance(x, torch.Tensor) else torch.full((), x, dtype=self.dtype, device=device)
                   for x in (a, b, c))
        if not self.exact:
            return a * b + c
        with torch.no_grad():
            value = torch.addcmul(c.double(), a.double(), b.double()).float()
        if not (a.requires_grad or b.requires_grad or c.requires_grad):
            return value
        plain = torch.addcmul(c, a, b)
        return value + (plain - plain.detach())

    def sqrt(self, x):
        return torch.sqrt(x.double()).to(x.dtype)

    def dot(self, a, b):
        return self.fma(a[..., 2], b[..., 2], self.fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))

    def unit(self, v):
        sq = self.dot(v, v)
        safe = torch.where(sq > 0.0, sq, torch.ones_like(sq))
        scale = torch.where(sq > 0.0, 1.0 / self.sqrt(safe), torch.zeros_like(sq))
        return v * scale[..., None]


# ---------------------------------------------------------------------------
# Camera, sweep, materials, sky.
# ---------------------------------------------------------------------------


def camera_rays(cam: dict, pix, keys, ar: Arith):
    """Jittered rays of global pixels `pix` [R] from camera keys -> (origin
    [R, 3], direction [R, 3])."""
    u4 = uniforms(keys, 4, CAMERA_DOMAIN, ar.dtype)
    width = cam["width"]
    jitter = u4[:, 0:2] - 0.5
    fx = ((pix % width).to(torch.float32).to(ar.dtype) + jitter[:, 0])[:, None]
    fy = ((pix // width).to(torch.float32).to(ar.dtype) + jitter[:, 1])[:, None]
    v = {k: cam[k].to(ar.dtype) for k in ("center", "pixel00_loc", "pixel_delta_u", "pixel_delta_v",
                                          "defocus_disk_u", "defocus_disk_v")}
    sample = ar.fma(fy, v["pixel_delta_v"], ar.fma(fx, v["pixel_delta_u"], v["pixel00_loc"]))
    if float(cam["defocus_angle"]) > 0.0:
        r = ar.sqrt(u4[:, 2])
        theta = _TWO_PI * u4[:, 3]
        origin = ar.fma((r * torch.sin(theta))[:, None], v["defocus_disk_v"],
                        ar.fma((r * torch.cos(theta))[:, None], v["defocus_disk_u"], v["center"]))
    else:
        origin = v["center"].expand_as(sample)
    return origin, sample - origin


def _roots(ar: Arith, a, half_b, c, fma):
    disc = fma(half_b, half_b, -(a * c))
    has_root = disc > 0.0
    sqrt_d = ar.sqrt(torch.where(has_root, disc, 1.0))
    inv_a = 1.0 / a
    near = (-half_b - sqrt_d) * inv_a
    far = (-half_b + sqrt_d) * inv_a

    def in_range(t):
        return (t > T_MIN_EPS) & (t < T_MISS)

    t = torch.where(in_range(near), near, far)
    return t, has_root & in_range(t)


def sweep(scene: dict, o, d, ar: Arith):
    """Nearest root of every ray against every sphere and its minimum ->
    (t_best [R], index [R]), T_MISS on a miss (index 0); no tape.

    In float32 the pairs whose discriminant could be positive are found
    first in float64 with a margin of about 80 float32 roundings of the
    terms, and only those are computed exactly: the others have no root in
    either precision."""
    with torch.no_grad():
        o, d = o.detach(), d.detach()
        centers = scene["center"].detach()
        radius = scene["radius"].detach()
        csq = ar.fma(-radius, radius, ar.dot(centers, centers))
        a = ar.dot(d, d)
        o_dot_d = ar.dot(o, d)
        o_sq = ar.dot(o, o)
        t_best = torch.empty(o.shape[0], dtype=ar.dtype, device=o.device)
        index = torch.empty(o.shape[0], dtype=torch.int64, device=o.device)
        for s in range(0, o.shape[0], SWEEP_BLOCK):
            blk = slice(s, s + SWEEP_BLOCK)
            if ar.exact:
                t_best[blk], index[blk] = _sweep_candidates(ar, o[blk], d[blk], a[blk], o_dot_d[blk], o_sq[blk],
                                                            centers, csq, scene["active"])
            else:
                t_best[blk], index[blk] = _sweep_all(ar, o[blk], d[blk], a[blk], o_dot_d[blk], o_sq[blk],
                                                     centers, csq, scene["active"])
    return t_best, index


def _sweep_all(ar: Arith, o, d, a, o_dot_d, o_sq, centers, csq, active):
    """Every (ray, sphere) pair of a block, unfused (the control)."""
    def cols(x):
        return x[:, 2:3] * centers[:, 2] + (x[:, 1:2] * centers[:, 1] + x[:, 0:1] * centers[:, 0])

    half_b = o_dot_d[:, None] - cols(d)
    c = (o_sq[:, None] - 2.0 * cols(o)) + csq[None, :]
    t, valid = _roots(ar, a[:, None], half_b, c, lambda x, y, z: x * y + z)
    return torch.min(torch.where(valid & active[None, :], t, T_MISS), dim=1)


def _sweep_candidates(ar: Arith, o, d, a, o_dot_d, o_sq, centers, csq, active):
    """The float32 sweep of a block, exactly, on the pairs that can hit."""
    c64 = centers.double()
    d_c = d.double() @ c64.T
    o_c = o.double() @ c64.T
    hb = o_dot_d.double()[:, None] - d_c
    cc = (o_sq.double()[:, None] - 2.0 * o_c) + csq.double()[None, :]
    scale = hb * hb + a.double()[:, None] * ((o_sq.double()[:, None] + 2.0 * o_c.abs()) + csq.double().abs()[None, :]
                                             + d_c.abs() + o_dot_d.double().abs()[:, None])
    maybe = ((hb * hb - a.double()[:, None] * cc) > -1e-5 * scale) & active[None, :]
    ray, sph = maybe.nonzero(as_tuple=True)
    x_o, x_d, cen = o[ray], d[ray], centers[sph]

    def dot(x, y):  # fma(x2, y2, fma(x1, y1, x0 * y0)), each rounded once
        x, y = x.double(), y.double()
        p = (x[:, 0] * y[:, 0]).float().double()
        p = torch.addcmul(p, x[:, 1], y[:, 1]).float().double()
        return torch.addcmul(p, x[:, 2], y[:, 2]).float()

    half_b = o_dot_d[ray] - dot(x_d, cen)
    c = (o_sq[ray] - 2.0 * dot(x_o, cen)) + csq[sph]
    t, valid = _roots(ar, a[ray], half_b, c, lambda x, y, z: torch.addcmul(z.double(), x.double(), y.double()).float())
    t = torch.where(valid, t, T_MISS)
    n = o.shape[0]
    t_best = torch.full((n,), T_MISS, dtype=t.dtype, device=o.device)
    t_best.scatter_reduce_(0, ray, t, "amin")
    first = torch.full((n,), centers.shape[0], dtype=torch.int64, device=o.device)
    first.scatter_reduce_(0, ray[t == t_best[ray]], sph[t == t_best[ray]], "amin")
    return t_best, torch.where(t_best < T_MISS, first, 0)


def _winner_t(ar: Arith, center, radius, o, d):
    """The sweep's t of one sphere a ray, with a gradient to its center and
    radius."""
    a = ar.dot(d, d)
    half_b = ar.dot(o, d) - ar.dot(d, center)
    c = (ar.dot(o, o) - 2.0 * ar.dot(o, center)) + ar.fma(-radius, radius, ar.dot(center, center))
    return _roots(ar, a, half_b, c, ar.fma)[0]


def _unit_sample(ar: Arith, u4):
    u0 = torch.clamp(u4[:, 0], min=1e-12)
    u2 = torch.clamp(u4[:, 2], min=1e-12)
    r1 = ar.sqrt(-2.0 * torch.log(u0))
    r2 = ar.sqrt(-2.0 * torch.log(u2))
    t1 = _TWO_PI * u4[:, 1]
    t2 = _TWO_PI * u4[:, 3]
    g = torch.stack([r1 * torch.cos(t1), r1 * torch.sin(t1), r2 * torch.cos(t2)], dim=-1)
    sq = ar.dot(g, g)[:, None]
    return g * torch.rsqrt(torch.clamp(sq, min=1e-12))


def _scatter(ar: Arith, hit: dict, d, unit_sample, reflect_u):
    unit_in = ar.unit(d)
    normal = hit["normal"]
    lam_dir = normal + unit_sample
    lam_dir = torch.where(torch.all(torch.abs(lam_dir) < 1e-8, dim=-1)[:, None], normal, lam_dir)

    reflected = ar.fma(-2.0 * ar.dot(unit_in, normal)[:, None], normal, unit_in)
    metal_dir = ar.fma(hit["fuzz"][:, None], unit_sample, reflected)
    metal_ok = ar.dot(metal_dir, normal) > 0.0

    ior = hit["ior"]
    ratio = torch.where(hit["front"], 1.0 / ior, ior)
    cos_theta = torch.clamp(ar.dot(-unit_in, normal), max=1.0)
    sin_theta = ar.sqrt(torch.clamp(ar.fma(-cos_theta, cos_theta, 1.0), min=1e-12))
    cannot_refract = ratio * sin_theta > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    x = 1.0 - cos_theta
    x2 = x * x
    schlick = ar.fma(1.0 - r0, x * (x2 * x2), r0)
    must_reflect = cannot_refract | (schlick > reflect_u)
    cos_r = torch.clamp(ar.dot(-unit_in, normal), max=1.0)
    r_perp = ratio[:, None] * ar.fma(cos_r[:, None], normal, unit_in)
    k = 1.0 - ar.dot(r_perp, r_perp)
    refractable = k > 0.0
    sqrt_k = torch.where(refractable, ar.sqrt(torch.where(refractable, k, 1.0)), 0.0)
    refracted = ar.fma(-sqrt_k[:, None], normal, r_perp)
    diel_dir = torch.where(must_reflect[:, None], reflected, refracted)

    mat = hit["mat_type"]
    is_lam = mat == LAMBERTIAN
    is_metal = mat == METAL
    direction = torch.where(is_lam[:, None], lam_dir, torch.where(is_metal[:, None], metal_dir, diel_dir))
    attenuation = torch.where((mat == DIELECTRIC)[:, None], torch.ones_like(hit["albedo"]), hit["albedo"])
    return direction, attenuation, torch.where(is_metal, metal_ok, True)


def _sky(ar: Arith, d):
    a = 0.5 * (ar.unit(d)[:, 1] + 1.0)
    blue = torch.tensor(SKY_BLUE, dtype=ar.dtype, device=d.device)
    return ar.fma(a[:, None], blue, (1.0 - a)[:, None])


def trace(scene: dict, o, d, keys, max_depth: int, ar: Arith):
    """Radiance [R, 3] of the rays and the sweeps [R] each ran. Gradients
    reach the scene's center, radius, albedo, fuzz and ior where they
    require one."""
    n = o.shape[0]
    rad = torch.zeros(n, 3, dtype=ar.dtype, device=o.device)
    att = torch.ones(n, 3, dtype=ar.dtype, device=o.device)
    work = torch.zeros(n, dtype=torch.int64, device=o.device)
    live = torch.arange(n, device=o.device)
    k = keys
    grad = torch.is_grad_enabled()
    for i in range(max_depth):
        t_best, index = sweep(scene, o, d, ar)
        work[live] += 1
        hit = t_best < T_MISS * 0.5
        center_h = scene["center"][index]
        radius_h = scene["radius"][index]
        t = t_best
        if grad and any(x.requires_grad for x in (center_h, radius_h)):
            t_rec = _winner_t(ar, center_h, radius_h, o, d)
            t = t_best + torch.where(hit, t_rec - t_rec.detach(), 0.0)
        t = torch.where(hit, t, 1.0)
        point = ar.fma(t[:, None], d, o)
        outward = (point - center_h) / radius_h[:, None]
        front = ar.dot(d, outward) < 0.0
        rec = {"normal": torch.where(front[:, None], outward, -outward), "front": front,
               "albedo": scene["albedo"][index], "fuzz": scene["fuzz"][index], "ior": scene["ior"][index],
               "mat_type": scene["mat_type"][index]}
        rad = rad.index_copy(0, live, rad[live] + torch.where(hit[:, None], 0.0, att * _sky(ar, d)))
        if i + 1 == max_depth or not bool(hit.any()):
            break
        u = uniforms(k, 5, i, ar.dtype)
        new_dir, mat_att, ok = _scatter(ar, rec, d, _unit_sample(ar, u[:, 0:4]), u[:, 4])
        keep = (hit & ok).nonzero()[:, 0]
        if keep.numel() == 0:
            break
        live = live[keep]
        o, d, att = point[keep], new_dir[keep], (att * mat_att)[keep]
        k = (k[0][keep], k[1][keep])
    return rad, work


def sample_radiance(scene: dict, cam: dict, pix, base_key, s0: int, ns: int, max_depth: int,
                    dtype=torch.float32):
    """Each sample's radiance [ns, R, 3] of global samples [s0, s0 + ns) of
    global pixels `pix` [R] on threefry keys from `base_key` (two uint32
    words), and the sweeps [ns, R] each ran: every ray traced side by side.
    Gradients reach the scene's fields that require one."""
    ar = Arith(dtype)
    scene = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in scene.items()}
    r = pix.numel()
    pixel_keys = fold_in(base_key, pix)
    s_idx = torch.arange(s0, s0 + ns, device=pix.device).repeat_interleave(r)
    keys = fold_in((pixel_keys[0].repeat(ns), pixel_keys[1].repeat(ns)), s_idx)
    o, d = camera_rays(cam, pix.repeat(ns), fold_in(keys, 0), ar)
    rad, work = trace(scene, o, d, fold_in(keys, 1), max_depth, ar)
    return rad.view(ns, r, 3), work.view(ns, r)


def fold(rad, spp: int):
    """The samples' radiance [spp, R, 3] added in sample order and divided by
    spp (a true division, as the kernel divides)."""
    total = torch.zeros_like(rad[0])
    for s in range(rad.shape[0]):
        total = total + rad[s]
    return total / torch.full_like(total, float(spp))


def render_pixels(scene: dict, cam: dict, pix, base_key, spp: int, sample_offset: int, max_depth: int,
                  dtype=torch.float32):
    """Samples [sample_offset, sample_offset + spp) of global pixels `pix`
    [R] -> (the mean [R, 3], the sweeps [R] each pixel ran)."""
    rad, work = sample_radiance(scene, cam, pix, base_key, sample_offset, spp, max_depth, dtype)
    return fold(rad, spp), work.sum(0)
