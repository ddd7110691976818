"""The port's book milestones against the JAX package's `models/milestones.py`.

Builders, cameras and the first gradient image are deterministic and held
exactly (cameras to float32 rounding). The milestone scenes go through the
port's plain render and the JAX kernel in interpret mode on the same PCG
streams, held as tests/test_torch_render.py holds the cover scene. The
four shading renders draw from threefry in JAX and from PCG streams in the
port, so they are held in block means on the 12x6 grid of
tests/test_milestones.py, each against a gate calibrated on JAX against
itself, and each gate is shown to reject a wrong pairing; and, where the
draws cancel, per pixel to a closed form.
"""

import functools
import math

import jax
import numpy as np
import pytest
import torch

from ray_tracing_in_one_weekend_tpu.models import milestones as JM
from ray_tracing_in_one_weekend_tpu.ops import pallas_render as pr
from ray_tracing_in_one_weekend_tpu_torch.models import milestones as M
from ray_tracing_in_one_weekend_tpu_torch.models.camera import camera_from_numpy
from ray_tracing_in_one_weekend_tpu_torch.models.scene import scene_from_numpy
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
from ray_tracing_in_one_weekend_tpu_torch.probes import closed_form as cf
from ray_tracing_in_one_weekend_tpu_torch.utils import compare

torch.set_num_threads(2)

FIELDS = ("center", "radius", "albedo", "fuzz", "ior", "mat_type", "active")
CAMERA_VECTORS = ("center", "pixel00_loc", "pixel_delta_u", "pixel_delta_v",
                  "defocus_disk_u", "defocus_disk_v", "defocus_angle")
DEFOCUS = dict(vfov_degrees=20.0, lookfrom=(3.0, 3.0, 2.0), aperture=2.0, focus_dist=math.sqrt(27.0))

# (builder name, arguments): every builder and variant of the module.
SCENES = [
    ("sphere_ground_scene", ()),
    ("metal_trio_scene", ()),
    ("metal_trio_scene", (0.3, 1.0)),
    ("glass_trio_scene", ()),
    ("glass_trio_scene", (True,)),
    ("two_sphere_wide_scene", ()),
    ("refract_trio_scene", ()),
    ("single_sphere_sky_scene", ()),
]
# (camera name, keyword arguments): the book camera and the three positioned ones.
CAMERAS = [
    ("book_camera", {}),
    ("book_camera", dict(image_width=200, aspect_ratio=2.0)),
    ("positioned_camera", dict(vfov_degrees=90.0)),
    ("positioned_camera", dict(vfov_degrees=20.0)),
    ("positioned_camera", DEFOCUS),
]


def _numpy(obj, fields):
    return {f: np.asarray(getattr(obj, f)) for f in fields}


@pytest.mark.parametrize(
    "kind,name,args",
    [("scene", n, a) for n, a in SCENES] + [("camera", n, a) for n, a in CAMERAS],
    ids=[f"{n}{a}" for n, a in SCENES] + [f"{n}-{'-'.join(map(str, a.values())) or 'default'}"
                                           for n, a in CAMERAS],
)
def test_builders_and_cameras_equal_jax(kind, name, args):
    """Scene arrays equal the JAX builder's; camera constants equal JAX's
    `make_camera` to float32 rounding (rtol 1e-6, as
    test_torch_scene_camera.py holds the cover camera)."""
    if kind == "scene":
        ours, theirs = getattr(M, name)(*args, device="cpu"), getattr(JM, name)(*args)
        assert ours.num_slots == M.MILESTONE_SLOTS
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(theirs, f)),
                                          err_msg=f)
    else:
        ours, theirs = getattr(M, name)(**args, device="cpu"), getattr(JM, name)(**args)
        assert (ours.image_width, ours.image_height, ours.samples_per_pixel, ours.max_depth) == (
            theirs.image_width, theirs.image_height, theirs.samples_per_pixel, theirs.max_depth)
        np.testing.assert_allclose(cr.pack_camera(ours).numpy(), pr.pack_camera(theirs),
                                   rtol=1e-6, atol=1e-7)


# MILESTONE_RENDERS -> the JAX scene and camera tests/test_milestones.py
# renders through the final integrator for that gallery image.
JAX_PAIRINGS = {
    "image2_sky": (lambda: JM.sphere_ground_scene().replace(active=np.zeros(128, bool)), "book_camera", {}),
    "image9_sphere_ground": (JM.sphere_ground_scene, "book_camera", {}),
    "image11_metal_trio": (JM.metal_trio_scene, "book_camera", {}),
    "image12_fuzzed_metal_trio": (lambda: JM.metal_trio_scene(0.3, 1.0), "book_camera", {}),
    "image15_glass_trio": (JM.glass_trio_scene, "book_camera", {}),
    "image16_hollow_glass_trio": (lambda: JM.glass_trio_scene(hollow=True), "book_camera", {}),
    "image17_two_sphere_wide": (JM.two_sphere_wide_scene, "book_camera", {}),
    "image18_positioned_wide": (lambda: JM.glass_trio_scene(hollow=True), "positioned_camera",
                                dict(vfov_degrees=90.0)),
    "image19_positioned_zoom": (lambda: JM.glass_trio_scene(hollow=True), "positioned_camera",
                                dict(vfov_degrees=20.0)),
    "image20_defocus": (lambda: JM.glass_trio_scene(hollow=True), "positioned_camera", DEFOCUS),
}


@pytest.mark.parametrize("name", M.MILESTONE_RENDERS)
def test_milestone_render_is_the_gallery_pairing(name):
    """`milestone_render(name)` builds the scene and camera (400 wide, 100
    spp, depth 50) that the JAX package renders for that gallery image."""
    assert set(JAX_PAIRINGS) == set(M.MILESTONE_RENDERS)
    make_scene, cam_name, cam_args = JAX_PAIRINGS[name]
    scene, cam = M.milestone_render(name, device="cpu")
    theirs, jcam = make_scene(), getattr(JM, cam_name)(**cam_args)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(scene, f).numpy(), np.asarray(getattr(theirs, f)), err_msg=f)
    assert (cam.image_width, cam.image_height, cam.samples_per_pixel, cam.max_depth) == (400, 225, 100, 50)
    np.testing.assert_allclose(cr.pack_camera(cam).numpy(), pr.pack_camera(jcam), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("width,height", [(1920, 1080), (400, 225), (200, 100), (3, 2)])
def test_first_gradient_image_equals_jax(width, height):
    ours = M.first_gradient_image(width, height, device="cpu")
    assert ours.dtype == torch.uint8 and ours.shape == (height, width, 3)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(JM.first_gradient_image(width, height)))


@pytest.mark.parametrize(
    "scene_args,camera",
    [
        (("glass_trio_scene", (True,)), ("book_camera", {})),
        (("metal_trio_scene", (0.3, 1.0)), ("book_camera", {})),
        (("glass_trio_scene", (True,)), ("positioned_camera", DEFOCUS)),
    ],
    ids=["hollow_glass", "fuzzed_metal", "hollow_glass_defocus"],
)
def test_milestone_render_matches_render_pallas(scene_args, camera):
    """The milestone scene through the port's plain render against
    render_pallas in interpret mode, on the same scene and camera arrays
    and PCG streams (32 wide, spp 2, depth 8, tile 128): pixels off by
    > 1e-3 under 3% (measured: none at seeds 0-2), block means as in
    test_torch_render.py."""
    name, args = scene_args
    cam_name, cam_args = camera
    theirs = getattr(JM, name)(*args)
    jcam = getattr(JM, cam_name)(**{**cam_args, "image_width": 32, "spp": 2, "max_depth": 8})
    ours = scene_from_numpy(_numpy(theirs, FIELDS), device="cpu")
    tcam = camera_from_numpy(_numpy(jcam, CAMERA_VECTORS), jcam.image_width, jcam.image_height,
                             jcam.samples_per_pixel, jcam.max_depth, device="cpu")
    img_j = np.array(pr.render_pallas(theirs, jcam, seed=0, tile=128, interpret=True, warm=False))
    img_t = cr.render_cuda(ours, tcam, seed=0, tile=128, warm=False)
    assert bool(torch.isfinite(img_t).all())
    agree = compare.images(img_t, torch.from_numpy(img_j), block=6, atol=1e-3)
    assert agree.flipped_frac < 0.03, agree
    assert agree.blocks_agree, agree


# ---------------------------------------------------------------------------
# The shading renders.
# ---------------------------------------------------------------------------

SHAPE = dict(image_width=192, spp=8, max_depth=8)  # 192x108


def _block_mad(a, b) -> float:
    """Block-mean MAD on the 12x6 grid of tests/test_milestones.py."""
    return compare.grid_mad(torch.tensor(np.asarray(a)), torch.tensor(np.asarray(b)))


def _render(ours, name, scene, cam, key_or_seed):
    """The shading render `name` ('hit_flag', 'normals', 'hemisphere' or a
    v2 dielectric mode) of the port (ours) or JAX, at SHAPE's spp and depth."""
    mod = M if ours else JM
    spp, depth = SHAPE["spp"], SHAPE["max_depth"]
    if name == "hit_flag":
        return mod.render_hit_flag(scene, cam, key_or_seed, spp=spp)
    if name == "normals":
        return mod.render_normals(scene, cam, key_or_seed, spp=spp)
    if name == "hemisphere":
        return mod.render_hemisphere_diffuse(scene, cam, key_or_seed, spp=spp, max_depth=depth)
    return mod.render_v2_dielectric(scene, cam, key_or_seed, spp=spp, max_depth=depth, mode=name)


@functools.lru_cache(maxsize=None)
def _port(name, scene_name):
    return _render(True, name, getattr(M, scene_name)(device="cpu"), M.book_camera(**SHAPE, device="cpu"),
                   0).numpy()


@functools.lru_cache(maxsize=None)
def _port_lambertian(scene_name):
    """The final integrator (`render_cuda`: lambertian, metal, the Schlick
    dielectric) on the same scene and camera."""
    cam = M.book_camera(**SHAPE, device="cpu")
    return cr.render_cuda(getattr(M, scene_name)(device="cpu"), cam, seed=0).numpy()


# name -> (scene, gate, wrong pairing). Gates: block MAD at 192x108, spp 8,
# depth 8, calibrated on JAX against itself under keys 0-3 (the six pairs'
# largest reading, then about 2.5x it), with the port's reading at seeds
# 0-2 against JAX key 0 and the wrong pairing's against JAX key 0:
#   hit_flag    JAX 1.7e-4-3.0e-4, port 2.1e-4-3.1e-4, gate 7.5e-4; normals of the scene 0.095
#   normals     JAX 1.5e-4-2.6e-4, port 1.8e-4-2.3e-4, gate 6.5e-4; the scene without ground 0.118
#   hemisphere  JAX 1.24e-3-1.65e-3, port 1.31e-3-1.54e-3, gate 4.0e-3; render_cuda 8.2e-3
#   v2 modes    JAX 1.15e-3-1.79e-3, port 1.38e-3-1.52e-3, gate 4.5e-3; render_cuda 1.30e-2
# (On solid spheres the two v2 modes render alike: a chord meets its exit at
# its entry angle, so no lane reaches total internal reflection, and they
# are no wrong pairing of each other. The hollow trio tells them apart:
# test_v2_modes_part_at_total_internal_reflection.)
SHADING = {
    "hit_flag": ("single_sphere_sky_scene", 7.5e-4, lambda: _port("normals", "single_sphere_sky_scene")),
    "normals": ("sphere_ground_scene", 6.5e-4, lambda: _port("normals", "single_sphere_sky_scene")),
    "hemisphere": ("sphere_ground_scene", 4.0e-3, lambda: _port_lambertian("sphere_ground_scene")),
    "always_refract": ("refract_trio_scene", 4.5e-3, lambda: _port_lambertian("refract_trio_scene")),
    "tir_reflect": ("refract_trio_scene", 4.5e-3, lambda: _port_lambertian("refract_trio_scene")),
}


@pytest.mark.parametrize("name", list(SHADING))
def test_shading_render_matches_jax_in_block_means(name):
    """The port's render against JAX's (key 0) within the calibrated gate,
    and a wrong pairing (another milestone's render, or the final
    integrator's where the milestone differs from it) beyond it."""
    scene_name, gate, wrong = SHADING[name]
    theirs = np.asarray(_render(False, name, getattr(JM, scene_name)(), JM.book_camera(**SHAPE),
                                jax.random.key(0)))
    ours = _port(name, scene_name)
    assert ours.shape == theirs.shape == (108, 192, 3)
    assert np.isfinite(ours).all()
    mad = _block_mad(ours, theirs)
    assert mad < gate, f"{name}: block MAD {mad:.5f} against JAX, gate {gate}"
    miss = _block_mad(wrong(), theirs)
    assert miss > gate, f"{name}: the wrong pairing is {miss:.5f} off JAX, inside the gate {gate}"


@functools.lru_cache(maxsize=None)
def _hollow_v2(ours, mode):
    if ours:
        return _render(True, mode, M.glass_trio_scene(hollow=True, device="cpu"),
                       M.book_camera(**SHAPE, device="cpu"), 0).numpy()
    return np.asarray(_render(False, mode, JM.glass_trio_scene(hollow=True), JM.book_camera(**SHAPE),
                              jax.random.key(0)))


def _bubble_rim():
    """Pixels whose center ray meets the hollow trio's glass sphere (r 0.5)
    but not the disc of its bubble (r 0.45, both about (-1, 0, -1)): the
    rim where a ray in the glass meets the bubble beyond the critical
    angle (glass to air, ratio 1.5), the modes' only difference."""
    cam = M.book_camera(**SHAPE, device="cpu")
    f = {k: getattr(cam, k).double().numpy() for k in ("center", "pixel00_loc", "pixel_delta_u", "pixel_delta_v")}
    ys, xs = np.mgrid[0 : cam.image_height, 0 : cam.image_width]
    d = f["pixel00_loc"] + xs[..., None] * f["pixel_delta_u"] + ys[..., None] * f["pixel_delta_v"] - f["center"]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    oc = f["center"] - np.array([-1.0, 0.0, -1.0])
    half_b = d @ oc
    return (half_b * half_b > oc @ oc - 0.5**2) & ~(half_b * half_b > oc @ oc - 0.45**2)


# The rim's mean radiance, largest channel gap, at SHAPE (596 pixels).
# Calibrated on JAX against itself under keys 0-3: 6.3e-4-5.5e-3 over the
# six pairs of each mode; the port's same mode at seeds 0-2 against JAX key
# 0: 1.0e-3-6.9e-3; the port's other mode: 4.65e-2-5.42e-2.
RIM_GATE = 1.5e-2
V2_MODES = ("always_refract", "tir_reflect")


@pytest.mark.parametrize("mode", V2_MODES)
def test_v2_modes_part_at_total_internal_reflection(mode):
    """On the hollow glass trio light inside the glass meets the bubble
    beyond the critical angle: `tir_reflect` mirrors it and
    `always_refract` bends it by sqrt(|k|). The port's render of each mode
    matches JAX's same mode on the bubble's rim within RIM_GATE, and its
    other mode misses it; over the whole image both stay in the block-mean
    gate of the v2 renders."""
    other = V2_MODES[1 - V2_MODES.index(mode)]
    rim = _bubble_rim()
    theirs = _hollow_v2(False, mode)[rim].mean(axis=0)
    gap = np.abs(_hollow_v2(True, mode)[rim].mean(axis=0) - theirs).max()
    miss = np.abs(_hollow_v2(True, other)[rim].mean(axis=0) - theirs).max()
    assert gap < RIM_GATE, f"{mode}: the rim's mean is {gap:.4f} off JAX's, gate {RIM_GATE}"
    assert miss > RIM_GATE, f"{mode}: the port's {other} is {miss:.4f} off JAX's {mode}, inside the gate"
    mad = _block_mad(_hollow_v2(True, mode), _hollow_v2(False, mode))
    assert mad < SHADING[mode][1], f"{mode}: block MAD {mad:.5f} against JAX"


def test_hit_flag_is_the_flag_inside_the_silhouette():
    """Every pixel whose four corners' rays hit the sphere lies wholly
    inside its (convex) silhouette, so every jittered sample hits and the
    pixel is `flag_color` exactly; every pixel whose corners all miss the
    sphere's bounding disc is sky."""
    cam = M.book_camera(**SHAPE, device="cpu")
    img = _port("hit_flag", "single_sphere_sky_scene")
    h, w = cam.image_height, cam.image_width
    ys, xs = np.mgrid[0 : h + 1, 0 : w + 1]
    f = {k: getattr(cam, k).double().numpy() for k in ("center", "pixel00_loc", "pixel_delta_u", "pixel_delta_v")}
    corners = (f["pixel00_loc"] + (xs[..., None] - 0.5) * f["pixel_delta_u"]
               + (ys[..., None] - 0.5) * f["pixel_delta_v"] - f["center"])
    d = corners / np.linalg.norm(corners, axis=-1, keepdims=True)
    oc = f["center"] - np.array([0.0, 0.0, -1.0])
    half_b = d @ oc
    disc = half_b * half_b - (oc @ oc - 0.5 * 0.5)
    inside = disc > 1e-6
    every = inside[:-1, :-1] & inside[1:, :-1] & inside[:-1, 1:] & inside[1:, 1:]
    none = ~(inside[:-1, :-1] | inside[1:, :-1] | inside[:-1, 1:] | inside[1:, 1:])
    assert every.sum() > 1000
    assert (img[every] == np.array([1.0, 0.0, 0.0], np.float32)).all()
    assert (img[none][:, 0] < 1.0).all() and (img[none][:, 2] == 1.0).all()


def test_normals_center_pixel_closed_form():
    """The center pixel of the lone sphere shades 0.5 * (n + 1) of the
    analytic normal along the pixel's center ray, to 3e-3 (the jitter's
    normal variation averages over the samples; measured 4.2e-4)."""
    cam = M.book_camera(**SHAPE, device="cpu")
    img = _port("normals", "single_sphere_sky_scene")
    cy, cx = cam.image_height // 2, cam.image_width // 2
    d = cf.pixel_dir(cam, cx, cy)
    c = np.array([0.0, 0.0, -1.0])
    half_b = -d @ c
    t = -half_b - math.sqrt(half_b * half_b - (c @ c - 0.25))
    n = (t * d - c) / 0.5
    np.testing.assert_allclose(img[cy, cx], 0.5 * (n + 1.0), atol=3e-3)


def test_always_refract_ior1_passes_the_sky():
    """On the ior-1 probe (probes/closed_form.py), always-refract bends
    nothing (|k| = cos^2 theta), so the central 3x3 pixels are sky(d) to
    3e-3, as the final integrator's are."""
    reading, _ = cf.evaluate(
        "ior1", lambda s, c: M.render_v2_dielectric(s, c, 0, spp=c.samples_per_pixel, max_depth=c.max_depth),
        "cpu")
    assert reading.holds, reading.line()


def test_v2_dielectric_refuses_an_unknown_mode():
    cam = M.book_camera(8, 1, 1, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        M.render_v2_dielectric(M.refract_trio_scene(device="cpu"), cam, mode="schlick")
