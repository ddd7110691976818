"""The JAX package's closed-form render probes, through the port's plain render.

tests/test_pallas.py holds its kernel to five closed forms where the
random draws cancel: hollow glass transmits, defocus lowers the largest
horizontal gradient, a fuzz-0 mirror's center pixel is albedo *
sky(reflect(d)), an ior-1 sphere passes the sky through, and a black
lambertian gives exactly 0. The port's plain render (`render_cuda` on
the CPU) is held to the same closed forms and limits
(`probes/closed_form.py`), and, where the JAX test compares pixels with
`render_pallas`, to `render_pallas` in interpret mode on the same scene,
camera and PCG streams.
"""

import jax.numpy as jnp
import numpy as np
import torch

from ray_tracing_in_one_weekend_tpu.models.camera import Camera as JaxCamera
from ray_tracing_in_one_weekend_tpu.models.scene import Scene as JaxScene
from ray_tracing_in_one_weekend_tpu.ops import pallas_render as pr
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
from ray_tracing_in_one_weekend_tpu_torch.probes import closed_form as cf
from ray_tracing_in_one_weekend_tpu_torch.utils import compare

torch.set_num_threads(2)

FIELDS = ("center", "radius", "albedo", "fuzz", "ior", "mat_type", "active")
CAMERA_VECTORS = ("center", "pixel00_loc", "pixel_delta_u", "pixel_delta_v",
                  "defocus_disk_u", "defocus_disk_v", "defocus_angle")


def _jax_render(scene, cam):
    """`render_pallas` in interpret mode on the port's scene and camera,
    carried over as arrays -> numpy [H, W, 3]."""
    jscene = JaxScene(**{f: jnp.asarray(getattr(scene, f).numpy()) for f in FIELDS})
    jcam = JaxCamera(image_width=cam.image_width, image_height=cam.image_height,
                     samples_per_pixel=cam.samples_per_pixel, max_depth=cam.max_depth,
                     **{f: jnp.asarray(getattr(cam, f).numpy()) for f in CAMERA_VECTORS})
    return np.array(pr.render_pallas(jscene, jcam, seed=0, tile=128, interpret=True, warm=False))


def _plain(scene, cam):
    return cr.render_cuda(scene, cam, seed=0, warm=False)


def test_probe_scenes_are_the_jax_tests():
    """The probes' scenes pack as tests/test_pallas.py's do (hollow glass,
    mirror, ior 1, black lambertian, and the single sphere of defocus)."""
    from ray_tracing_in_one_weekend_tpu.models import scene as jax_scene

    jax_scenes = {
        "hollow_glass": jax_scene.from_spheres(
            centers=[[0, -100.5, -1], [0, 0, -1], [0, 0, -1], [-1, 0, -1], [1, 0, -1]],
            radii=[100.0, 0.5, -0.45, 0.5, 0.5], mat_types=[0, 2, 2, 0, 1],
            albedos=[[0.8, 0.8, 0.0], [1, 1, 1], [1, 1, 1], [0.1, 0.2, 0.5], [0.8, 0.6, 0.2]],
            pad_to=128),
        "defocus": jax_scene.single_sphere_scene(pad_to=128),
        "mirror": jax_scene.from_spheres(centers=[[0.0, 0.0, -3.0]], radii=[1.0], mat_types=[1],
                                         albedos=[[0.8, 0.6, 0.2]], fuzzes=[0.0], pad_to=128),
        "ior1": jax_scene.from_spheres(centers=[[0.0, 0.0, -10.0]], radii=[1.0], mat_types=[2],
                                       albedos=[[1.0, 1.0, 1.0]], iors=[1.0], pad_to=128),
        "black": jax_scene.from_spheres(centers=[[0.0, 0.0, -3.0]], radii=[1.0], mat_types=[0],
                                        albedos=[[0.0, 0.0, 0.0]], pad_to=128),
    }
    assert tuple(jax_scenes) == cf.PROBES
    for name, theirs in jax_scenes.items():
        ours, _ = cf.probe_setup(name, "cpu")
        np.testing.assert_array_equal(cr.pack_scene(ours).numpy(), np.asarray(pr.pack_scene(theirs)),
                                      err_msg=name)


def test_hollow_glass_transmits():
    """tests/test_pallas.py:129. The negative-radius inner sphere turns the
    normal inward; the shell transmits (center pixel > 0.1), and the image
    agrees with render_pallas on the same streams: channel means within
    that test's 0.015, and at most 3% of pixels off by > 1e-3 (measured:
    none, the largest difference 8.0e-6)."""
    reading, images = cf.evaluate("hollow_glass", _plain, "cpu")
    assert reading.holds, reading.line()
    scene, cams = cf.probe_setup("hollow_glass", "cpu")
    theirs = _jax_render(scene, cams["image"])
    ours = images["image"].numpy()
    np.testing.assert_allclose(ours.mean(axis=(0, 1)), theirs.mean(axis=(0, 1)), atol=0.015)
    agree = compare.images(images["image"], torch.from_numpy(theirs), block=8, atol=1e-3)
    assert agree.flipped_frac < 0.03, agree


def test_defocus_lowers_the_largest_gradient():
    """tests/test_pallas.py:154: the defocused render's largest horizontal
    gradient is below the sharp one's."""
    reading, _ = cf.evaluate("defocus", _plain, "cpu")
    assert reading.holds, reading.line()


def test_fuzz0_mirror_closed_form():
    """tests/test_pallas.py:194: the center pixel equals albedo *
    sky(reflect(d)) to 3e-3, and the 5x5 block around it agrees with
    render_pallas per pixel to 3e-3."""
    reading, images = cf.evaluate("mirror", _plain, "cpu")
    assert reading.holds, reading.line()
    scene, cams = cf.probe_setup("mirror", "cpu")
    cam = cams["image"]
    theirs = _jax_render(scene, cam)
    cy, cx = cam.image_height // 2, cam.image_width // 2
    np.testing.assert_allclose(images["image"].numpy()[cy - 2 : cy + 3, cx - 2 : cx + 3],
                               theirs[cy - 2 : cy + 3, cx - 2 : cx + 3], atol=cf.PIXEL_ATOL)


def test_ior1_passthrough_closed_form():
    """tests/test_pallas.py:238: an ior-1 dielectric bends nothing, so the
    central 3x3 pixels equal sky(d) to 3e-3, as render_pallas's do."""
    reading, _ = cf.evaluate("ior1", _plain, "cpu")
    assert reading.holds, reading.line()
    jax_reading, _ = cf.evaluate("ior1", lambda s, c: torch.from_numpy(_jax_render(s, c)), "cpu")
    assert jax_reading.holds, jax_reading.line()


def test_black_lambertian_absorbs_exactly():
    """tests/test_pallas.py:271: the first bounce off an albedo-0 lambertian
    zeroes the attenuation, so the central 7x7 pixels are exactly 0."""
    reading, _ = cf.evaluate("black", _plain, "cpu")
    assert reading.holds, reading.line()
    assert reading.value == 0.0

