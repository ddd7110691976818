"""Book-milestone scenes, cameras and shading modes, on tensors.

The PyTorch counterpart of ray_tracing_in_one_weekend_tpu/models/milestones.py.
The reference ships one committed render per book milestone
(gallery/cpu/image1..21.png, code in archive/listing1..70). This module
builds the milestones' scenes and cameras, which the final integrator
(`ops/cuda_render.render_cuda`) renders, and the shading modes the final
integrator no longer has: the boolean hit flag, normals shading, the
interim hemisphere diffuse and the pre-Schlick dielectric.

The builders are deterministic and give the JAX package's arrays. Like
the other builders they build on the card unless the caller passes
`device="cpu"`, and without a GPU the default raises.

The shading renders are plain PyTorch on the camera's device, built from
the render kernel's device functions (`ops/cuda_render.py`): the primary
ray and its 64-bit stream come from `_camera_ray_block` (jitter from
draw counters 0-1, the lens from 2-3), so a shading render's primary
rays are `render_cuda`'s for the same seed; the closest hit and its
signed-radius normal from `_sweep_ts` / `_select_hit` / `_surface`; bounce
i draws from counter `8 + 16*i`, as the kernel's bounce does. Two
differences from the JAX package are known and kept:

* the draws: JAX draws from threefry (`ops/sampling.py` there), the port
  from its PCG streams, so the two agree in law, not sample by sample;
* exact t ties: the lowest sphere index wins in the port, where JAX
  averages the tied spheres' parameters (a measure-zero case).
"""

from __future__ import annotations

import math

import torch

from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.models.camera import Camera, make_camera
from ray_tracing_in_one_weekend_tpu_torch.models.scene import (
    DIELECTRIC,
    LAMBERTIAN,
    METAL,
    Scene,
    resolve_device,
)
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr

# The slot count of every milestone scene (the JAX builders' pad_to).
MILESTONE_SLOTS = 128


def book_camera(image_width: int = 400, spp: int = 100, max_depth: int = 50,
                aspect_ratio: float = 16.0 / 9.0, device="cuda") -> Camera:
    """The book's fixed pre-positionable camera: origin at 0 looking down
    -z, viewport height 2, focal length 1 (vfov 90 degrees), no lens
    (reference: archive/listing62/camera.h:6-24). `aspect_ratio=2.0` gives
    the 200x100 framing of the close-up golden (gallery/cpu/image13)."""
    return make_camera(
        image_width=image_width,
        aspect_ratio=aspect_ratio,
        samples_per_pixel=spp,
        max_depth=max_depth,
        vfov_degrees=90.0,
        lookfrom=(0.0, 0.0, 0.0),
        lookat=(0.0, 0.0, -1.0),
        defocus_angle_degrees=0.0,
        focus_dist=1.0,
        device=device,
    )


def positioned_camera(
    image_width: int = 400, spp: int = 100, max_depth: int = 50,
    vfov_degrees: float = 90.0, lookfrom=(-2.0, 2.0, 1.0),
    lookat=(0.0, 0.0, -1.0), defocus_angle_degrees: float = 0.0,
    aperture: float | None = None, focus_dist: float = 1.0, device="cuda",
) -> Camera:
    """The positionable-camera milestones' cameras, 16:9:

    * wide view: lookfrom (-2,2,1), lookat (0,0,-1), vfov 90
      (reference: archive/listing65/main.cc:65; golden image18);
    * zoomed: the same with vfov 20 (archive/listing66; golden image19);
    * defocus: lookfrom (3,3,2), vfov 20, aperture 2.0 (the CPU tree's
      lens, lens_radius = aperture/2), focus_dist = |lookfrom - lookat|
      (archive/listing69/main.cc:65-71; golden image20).
    """
    return make_camera(
        image_width=image_width,
        aspect_ratio=16.0 / 9.0,
        samples_per_pixel=spp,
        max_depth=max_depth,
        vfov_degrees=vfov_degrees,
        lookfrom=lookfrom,
        lookat=lookat,
        vup=(0.0, 1.0, 0.0),
        defocus_angle_degrees=defocus_angle_degrees,
        aperture=aperture,
        focus_dist=focus_dist,
        device=device,
    )


def sphere_ground_scene(pad_to: int = MILESTONE_SLOTS, device="cuda") -> Scene:
    """Sphere (0,0,-1) r=0.5 over the ground sphere (0,-100.5,-1) r=100, both
    0.5-gray lambertian: the geometry of every pre-material milestone
    (reference: archive/listing24/main.cc, archive/listing30/main.cc)."""
    return scene_lib.from_spheres(
        centers=[[0.0, 0.0, -1.0], [0.0, -100.5, -1.0]],
        radii=[0.5, 100.0],
        mat_types=[LAMBERTIAN, LAMBERTIAN],
        albedos=[[0.5, 0.5, 0.5], [0.5, 0.5, 0.5]],
        pad_to=pad_to,
        device=device,
    )


_TRIO_CENTERS = [[0.0, -100.5, -1.0], [0.0, 0.0, -1.0], [-1.0, 0.0, -1.0], [1.0, 0.0, -1.0]]
_TRIO_RADII = [100.0, 0.5, 0.5, 0.5]


def metal_trio_scene(fuzz_left: float = 0.0, fuzz_right: float = 0.0,
                     pad_to: int = MILESTONE_SLOTS, device="cuda") -> Scene:
    """The first-metal tableau: yellow ground, diffuse (0.7,0.3,0.3) center,
    silver (0.8,0.8,0.8) left, gold (0.8,0.6,0.2) right
    (reference: archive/listing50/main.cc:15-23; the fuzzed variant, fuzz
    0.3 / 1.0, archive/listing52/main.cc:55-56)."""
    return scene_lib.from_spheres(
        centers=_TRIO_CENTERS,
        radii=_TRIO_RADII,
        mat_types=[LAMBERTIAN, LAMBERTIAN, METAL, METAL],
        albedos=[[0.8, 0.8, 0.0], [0.7, 0.3, 0.3], [0.8, 0.8, 0.8], [0.8, 0.6, 0.2]],
        fuzzes=[0.0, 0.0, fuzz_left, fuzz_right],
        pad_to=pad_to,
        device=device,
    )


def glass_trio_scene(hollow: bool = False, pad_to: int = MILESTONE_SLOTS, device="cuda") -> Scene:
    """The dielectric tableau: yellow ground, blue (0.1,0.2,0.5) diffuse
    center, glass (ior 1.5) left, gold sharp metal right
    (reference: archive/listing59/main.cc:53-61). `hollow=True` appends the
    inner sphere of radius -0.45 at the glass sphere's center: the signed
    radius turns the normal inward (`ops/cuda_render._surface`), making the
    book's hollow glass bubble."""
    centers = list(_TRIO_CENTERS)
    radii = list(_TRIO_RADII)
    mats = [LAMBERTIAN, LAMBERTIAN, DIELECTRIC, METAL]
    albedos = [[0.8, 0.8, 0.0], [0.1, 0.2, 0.5], [1.0, 1.0, 1.0], [0.8, 0.6, 0.2]]
    if hollow:
        centers.append([-1.0, 0.0, -1.0])
        radii.append(-0.45)
        mats.append(DIELECTRIC)
        albedos.append([1.0, 1.0, 1.0])
    return scene_lib.from_spheres(
        centers=centers, radii=radii, mat_types=mats, albedos=albedos, pad_to=pad_to, device=device,
    )


def two_sphere_wide_scene(pad_to: int = MILESTONE_SLOTS, device="cuda") -> Scene:
    """The wide-angle fov test: two touching spheres of radius cos(pi/4),
    blue left, red right, filling the 90-degree viewport
    (reference: archive/listing63/main.cc:51-57; golden image17)."""
    r = math.cos(math.pi / 4.0)
    return scene_lib.from_spheres(
        centers=[[-r, 0.0, -1.0], [r, 0.0, -1.0]],
        radii=[r, r],
        mat_types=[LAMBERTIAN, LAMBERTIAN],
        albedos=[[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]],
        pad_to=pad_to,
        device=device,
    )


def refract_trio_scene(pad_to: int = MILESTONE_SLOTS, device="cuda") -> Scene:
    """The dielectric chapter's tableau: yellow ground, glass center and
    left, fuzz-1.0 gold metal right (reference: archive/listing55/main.cc:53-61;
    the 200x100 close-up golden image13 renders it with the pre-Schlick
    dielectric, see `render_v2_dielectric`)."""
    return scene_lib.from_spheres(
        centers=_TRIO_CENTERS,
        radii=_TRIO_RADII,
        mat_types=[LAMBERTIAN, DIELECTRIC, DIELECTRIC, METAL],
        albedos=[[0.8, 0.8, 0.0], [1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [0.8, 0.6, 0.2]],
        fuzzes=[0.0, 0.0, 0.0, 1.0],
        pad_to=pad_to,
        device=device,
    )


def single_sphere_sky_scene(pad_to: int = MILESTONE_SLOTS, device="cuda") -> Scene:
    """The lone r=0.5 sphere at (0,0,-1) of the earliest ray-tracing
    milestones, no ground yet (reference: archive/listing10/main.cc:17,
    archive/listing11/main.cc:21)."""
    return scene_lib.from_spheres(
        centers=[[0.0, 0.0, -1.0]],
        radii=[0.5],
        mat_types=[LAMBERTIAN],
        albedos=[[0.5, 0.5, 0.5]],
        pad_to=pad_to,
        device=device,
    )


# The milestones the final integrator (`render_cuda`) renders, by the
# reference gallery image each reproduces (tests/test_milestones.py pairs
# them with gallery/cpu/image<N>.png).
MILESTONE_RENDERS = (
    "image2_sky",
    "image9_sphere_ground",
    "image11_metal_trio",
    "image12_fuzzed_metal_trio",
    "image15_glass_trio",
    "image16_hollow_glass_trio",
    "image17_two_sphere_wide",
    "image18_positioned_wide",
    "image19_positioned_zoom",
    "image20_defocus",
)


def milestone_render(name: str, image_width: int = 400, spp: int = 100, max_depth: int = 50,
                     device="cuda") -> tuple[Scene, Camera]:
    """The scene and camera of milestone `name` (one of MILESTONE_RENDERS),
    at the book's own size by default: `book_camera`, or a positioned
    camera over the hollow glass trio for images 18-20. image2 is the sky
    alone: the sphere-and-ground slots, every one inactive.

        scene, cam = milestone_render("image16_hollow_glass_trio")
        img = render_cuda(scene, cam)  # on the card: the render kernel
    """
    if name not in MILESTONE_RENDERS:
        raise ValueError(f"unknown milestone {name!r}; one of {MILESTONE_RENDERS}")
    if name.startswith(("image18", "image19", "image20")):
        lens = {"image18_positioned_wide": dict(vfov_degrees=90.0),
                "image19_positioned_zoom": dict(vfov_degrees=20.0),
                "image20_defocus": dict(vfov_degrees=20.0, lookfrom=(3.0, 3.0, 2.0), aperture=2.0,
                                        focus_dist=math.sqrt(27.0))}[name]
        cam = positioned_camera(image_width, spp, max_depth, device=device, **lens)
        return glass_trio_scene(hollow=True, device=device), cam
    cam = book_camera(image_width, spp, max_depth, device=device)
    if name == "image2_sky":
        scene = sphere_ground_scene(device=device)
        return scene.replace(active=torch.zeros_like(scene.active)), cam
    build = {
        "image9_sphere_ground": sphere_ground_scene,
        "image11_metal_trio": metal_trio_scene,
        "image12_fuzzed_metal_trio": lambda device: metal_trio_scene(0.3, 1.0, device=device),
        "image15_glass_trio": glass_trio_scene,
        "image16_hollow_glass_trio": lambda device: glass_trio_scene(hollow=True, device=device),
        "image17_two_sphere_wide": two_sphere_wide_scene,
    }[name]
    return build(device=device), cam


# ---------------------------------------------------------------------------
# Milestone shading modes the final integrator no longer has.
# ---------------------------------------------------------------------------


def first_gradient_image(width: int, height: int, device="cuda") -> torch.Tensor:
    """The book's very first output, before any ray: r = i/(w-1), g = j/(h-1)
    with j counted from the TOP (scanline h-1 is written first), b = 0.25,
    each quantized by int(255.999 * x) (reference: archive/listing1/main.cc:15-23;
    golden gallery/cpu/image1). Returns the exact u8 image [H, W, 3]. The
    float32 operations are the JAX function's, a true division included
    (a tensor divisor: CUDA divides by a scalar as a product with its
    reciprocal, which rounds otherwise)."""
    device = resolve_device(device)
    f32 = torch.float32
    i = torch.arange(width, dtype=f32, device=device).expand(height, width)
    j = torch.arange(height - 1, -1, -1, dtype=f32, device=device)[:, None].expand(height, width)
    r = (255.999 * i / torch.full_like(i, width - 1)).to(torch.uint8)
    g = (255.999 * j / torch.full_like(j, height - 1)).to(torch.uint8)
    b = torch.full((height, width), int(255.999 * 0.25), dtype=torch.uint8, device=device)
    return torch.stack([r, g, b], dim=-1)


def _closest(p_mat, o, d):
    """Closest hit of unit rays over the packed scene, at the shadow-acne
    t_min (the JAX `hit_scene` default) -> (hit [1,L], p, n_vec facing the
    ray, front_face, params [16,L])."""
    t_best, params, _ = cr._select_hit(p_mat, cr._sweep_ts(o, d, p_mat, cr.T_MIN_EPS))
    hit = t_best < cr.T_MISS * 0.5
    p, n_vec, front_face = cr._surface(o, d, torch.where(hit, t_best, 1.0), params)
    return hit, p, n_vec, front_face, params


# Lanes (pixel, sample pairs) per vectorized step of a shading render: a
# [128, lanes] sweep temporary is 128 MB on the card, 2 MB on the CPU.
_SHADE_LANES = {"cuda": 1 << 18, "cpu": 1 << 12}


def _shade(scene: Scene, cam: Camera, seed: int, spp: int, sample_fn) -> torch.Tensor:
    """Mean over `spp` samples of `sample_fn(p_mat, o, d, stream)` -> [3, L]
    radiance for every pixel, as [H, W, 3] on the camera's device. Sample s
    of pixel k starts from `_camera_ray_block` with the kernel's stream of
    (seed, k, s), whatever else runs beside it: a step runs every sample of
    a chunk of pixels as lanes, and the samples are added in order."""
    p_mat = cr.pack_scene(scene)
    cam_vec = cr.pack_camera(cam)
    camc = cr._unpack_cam(cam_vec)
    width = camc[-1]
    n, device = cam.num_pixels, cam_vec.device
    out = torch.empty((3, n), dtype=torch.float32, device=device)
    per = max(1, _SHADE_LANES.get(device.type, _SHADE_LANES["cpu"]) // spp)
    for a in range(0, n, per):
        m = min(n, a + per) - a
        # Lane s*m + i runs sample s of pixel a + i.
        pix = torch.arange(a, a + m, dtype=torch.int64, device=device).repeat(spp)[None]
        sample = torch.arange(spp, dtype=torch.int64, device=device).repeat_interleave(m)[None]
        px, py = (pix % width).to(torch.float32), (pix // width).to(torch.float32)
        h0 = cr._pcg(pix ^ cr._pcg(seed & cr._U32))
        o, d, lo, hi = cr._camera_ray_block(camc, h0, px, py, sample)
        rad = sample_fn(p_mat, o, d, (lo, hi)).reshape(3, spp, m)
        acc = torch.zeros((3, m), dtype=torch.float32, device=device)
        for s in range(spp):
            acc = acc + rad[:, s]
        out[:, a : a + m] = acc / spp
    return out.T.reshape(cam.image_height, cam.image_width, 3)


def _trace(p_mat, o, d, stream, max_depth, scatter_fn):
    """Paths of up to `max_depth` bounces -> radiance [3, L]. Each bounce
    of a live lane finds its closest hit; a miss adds att * sky and
    retires; a hit calls `scatter_fn(d, n_vec, front_face, params, stream,
    ctr)` -> (new unit dir, attenuation [3 or 1, L], ok) with the draw
    counter 8 + 16*i of bounce i, and the lane goes on while ok. Only live
    lanes are computed; a lane still live after `max_depth` bounces adds
    nothing."""
    rad = torch.zeros_like(o)
    lane = torch.arange(o.shape[1], device=o.device)
    att = torch.ones_like(o)
    lo, hi = stream
    for i in range(max_depth):
        if lane.numel() == 0:
            break
        hit, p, n_vec, front_face, params = _closest(p_mat, o, d)
        miss = ~hit[0]
        rad[:, lane[miss]] += att[:, miss] * cr._sky(d[:, miss])
        new_dir, mat_att, ok = scatter_fn(d, n_vec, front_face, params, (lo, hi), 8 + 16 * i)
        keep = (hit & ok)[0]
        lane, o, d = lane[keep], p[:, keep], new_dir[:, keep]
        att = (att * mat_att)[:, keep]
        lo, hi = lo[:, keep], hi[:, keep]
    return rad


def render_hit_flag(scene: Scene, cam: Camera, seed: int = 0, spp: int = 4,
                    flag_color=(1.0, 0.0, 0.0)) -> torch.Tensor:
    """The first ray-sphere image: solid `flag_color` on ANY hit, the sky
    gradient otherwise, primary rays only: the book's boolean `hit_sphere`
    shading (reference: archive/listing10/main.cc:7-21; golden
    gallery/cpu/image3). Returns [H, W, 3] linear radiance."""
    flag = torch.tensor(flag_color, dtype=torch.float32, device=cam.center.device)[:, None]

    def sample(p_mat, o, d, stream):
        hit, *_ = _closest(p_mat, o, d)
        return torch.where(hit, flag, cr._sky(d))

    return _shade(scene, cam, seed, spp, sample)


def render_normals(scene: Scene, cam: Camera, seed: int = 0, spp: int = 4) -> torch.Tensor:
    """Normals shading: 0.5 * (n + 1) on a hit, with n the unit normal
    facing the ray, the sky otherwise; primary rays only, at the JAX
    `hit_scene` default t_min (reference: archive/listing24/main.cc
    ray_color; golden gallery/cpu/image5). The listing writes colors
    before gamma, so compare it quantized linearly. Returns [H, W, 3]
    linear radiance."""

    def sample(p_mat, o, d, stream):
        hit, _, n_vec, _, _ = _closest(p_mat, o, d)
        return torch.where(hit, 0.5 * (n_vec + 1.0), cr._sky(d))

    return _shade(scene, cam, seed, spp, sample)


_V2_MODES = ("always_refract", "tir_reflect")


def render_v2_dielectric(scene: Scene, cam: Camera, seed: int = 0, spp: int = 16,
                         max_depth: int = 50, mode: str = "always_refract") -> torch.Tensor:
    """The pre-Schlick dielectric milestones, two modes:

    * `mode="always_refract"`: a dielectric always refracts, with
      sqrt(|1 - |r_perp|^2|) in the parallel term (reference:
      archive/listing54/material.h:57-67, archive/listing53/vec3.h:126-131),
      no TIR branch and no Schlick term, so beyond the critical angle a lane
      takes the listing's bogus direction (golden gallery/cpu/image14);
    * `mode="tir_reflect"`: refract unless ratio * sin_theta > 1, then
      mirror-reflect; still no Schlick term (reference:
      archive/listing58/material.h:53-80; the close-up golden image13).

    A dielectric always scatters, with attenuation 1. Lambertian and metal
    scatter as in the final integrator (`_scatter_block`). Returns
    [H, W, 3] linear radiance."""
    if mode not in _V2_MODES:
        raise ValueError(f"mode {mode!r} is not one of {_V2_MODES}")

    def scatter(d, n_vec, front_face, params, stream, ctr):
        new_dir, mat_att, ok = cr._scatter_block(d, n_vec, front_face, params, stream, ctr)
        ior = params[cr._IOR : cr._IOR + 1]
        ratio = torch.where(front_face, 1.0 / ior, ior)
        cos_t = torch.clamp(cr._dot3(-d, n_vec), max=1.0)
        r_perp = ratio * (d + cos_t * n_vec)
        k = 1.0 - cr._dot3(r_perp, r_perp)
        if mode == "always_refract":
            diel_dir = r_perp - cr._sqrt(k.abs()) * n_vec
        else:
            refracted = r_perp - cr._sqrt(torch.clamp(k, min=0.0)) * n_vec
            sin_t = cr._sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
            reflected = d - 2.0 * cr._dot3(d, n_vec) * n_vec
            diel_dir = torch.where(ratio * sin_t > 1.0, reflected, refracted)
        is_diel = params[cr._MAT : cr._MAT + 1] >= 1.5
        new_dir = torch.where(is_diel, cr._normalize3(diel_dir), new_dir)
        return new_dir, mat_att, ok | is_diel

    def sample(p_mat, o, d, stream):
        return _trace(p_mat, o, d, stream, max_depth, scatter)

    return _shade(scene, cam, seed, spp, sample)


def render_hemisphere_diffuse(scene: Scene, cam: Camera, seed: int = 0, spp: int = 16,
                              max_depth: int = 50) -> torch.Tensor:
    """The book's interim hemisphere-diffuse model: on a hit, every
    material scatters uniformly on the hemisphere of the normal (a uniform
    unit vector from `_unit_vectors`, flipped onto it) and attenuates by
    0.5 (reference: archive/listing40/main.cc ray_color,
    archive/listing39/vec3.h:110-116 random_in_hemisphere). Returns
    [H, W, 3] linear radiance."""

    def scatter(d, n_vec, front_face, params, stream, ctr):
        u = cr._unit_vectors(stream, ctr)
        hemi = torch.where(cr._dot3(u, n_vec) < 0.0, -u, u)
        return hemi, torch.full_like(d[0:1], 0.5), torch.ones_like(front_face)

    def sample(p_mat, o, d, stream):
        return _trace(p_mat, o, d, stream, max_depth, scatter)

    return _shade(scene, cam, seed, spp, sample)
