"""The port's scene, camera and packing against the JAX package.

Exact where the arithmetic is the same (scene arrays, packed scene);
float32 rounding (rtol 1e-6) where the camera derivation runs through
two frameworks' float32 kernels.
"""

import os

import numpy as np
import pytest
import torch

from ray_tracing_in_one_weekend_tpu.models import scene as jax_scene
from ray_tracing_in_one_weekend_tpu.models.camera import make_camera as jax_make_camera
from ray_tracing_in_one_weekend_tpu.ops import pallas_render as pr
from ray_tracing_in_one_weekend_tpu_torch.models import milestones
from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.models.camera import (
    camera_from_numpy,
    make_camera,
)
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
    RenderConfig,
    make_camera_from_config,
    make_scene_from_config,
)

torch.set_num_threads(2)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
FIELDS = ("center", "radius", "albedo", "fuzz", "ior", "mat_type", "active")


def _numpy(scene):
    return {f: np.asarray(getattr(scene, f)) for f in FIELDS}


def test_cover_scene_reference_equals_jax_and_reference_table():
    ours = scene_lib.cover_scene_reference(device="cpu")
    theirs = _numpy(jax_scene.cover_scene_reference())
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ours, f).numpy(), theirs[f], err_msg=f)
    assert ours.num_slots == 512 and ours.num_active == 1 + 482 + 3

    # Every accepted grid sphere of the reference binary (test_golden.py).
    rows = [l.split() for l in open(os.path.join(GOLDEN_DIR, "ref_scene_table.txt"))]
    assert len(rows) == 482
    table = np.asarray([[float(x) for x in r] for r in rows])
    grid = slice(1, 483)
    np.testing.assert_array_equal(ours.mat_type[grid].numpy(), table[:, 0].astype(int))
    np.testing.assert_allclose(ours.center[grid][:, [0, 2]].numpy(), table[:, 1:3], atol=1e-6)
    np.testing.assert_allclose(ours.albedo[grid].numpy(), table[:, 3:6], atol=1e-6)
    np.testing.assert_allclose(ours.fuzz[grid].numpy(), table[:, 6], atol=1e-6)
    heroes = ours.mat_type[483:486].tolist()
    assert heroes == [scene_lib.DIELECTRIC, scene_lib.LAMBERTIAN, scene_lib.METAL]


@pytest.mark.parametrize(
    "make",
    [
        lambda: jax_scene.cover_scene(0),
        lambda: jax_scene.three_sphere_scene(pad_to=128),
        lambda: jax_scene.single_sphere_scene(pad_to=128),
    ],
    ids=["cover0", "three", "single"],
)
def test_pack_scene_equals_jax(make):
    """The carried-over JAX scene packs to the identical [16, N] matrix."""
    theirs = make()
    ours = scene_lib.scene_from_numpy(_numpy(theirs), device="cpu")
    np.testing.assert_array_equal(cr.pack_scene(ours).numpy(), np.asarray(pr.pack_scene(theirs)))


def test_builtin_scenes_equal_jax():
    for name in ("three_sphere_scene", "single_sphere_scene"):
        ours = getattr(scene_lib, name)(pad_to=128, device="cpu")
        theirs = _numpy(getattr(jax_scene, name)(pad_to=128))
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(ours, f).numpy(), theirs[f], err_msg=f"{name}.{f}")


@pytest.mark.parametrize("lens", ["defocus_angle", "aperture"])
def test_make_and_pack_camera_match_jax(lens):
    """Both lens parameterizations, at the __graft_entry__ framing and the
    CPU preset's (rtol 1e-6: float32 rounding of the derivation)."""
    for kw in (
        dict(image_width=64, aspect_ratio=2.0, samples_per_pixel=2, max_depth=8),
        dict(image_width=152, aspect_ratio=1.5, vfov_degrees=20.0, focus_dist=10.0),
    ):
        if lens == "aperture":
            kw = dict(kw, aperture=0.1)
        else:
            kw = dict(kw, defocus_angle_degrees=0.6)
        ours, theirs = make_camera(**kw, device="cpu"), jax_make_camera(**kw)
        assert (ours.image_width, ours.image_height) == (theirs.image_width, theirs.image_height)
        np.testing.assert_allclose(
            cr.pack_camera(ours, 2e-3).numpy(), pr.pack_camera(theirs, 2e-3), rtol=1e-6, atol=1e-7
        )
        carried = camera_from_numpy(
            {f: np.asarray(getattr(theirs, f)) for f in (
                "center", "pixel00_loc", "pixel_delta_u", "pixel_delta_v",
                "defocus_disk_u", "defocus_disk_v", "defocus_angle")},
            theirs.image_width, theirs.image_height,
            theirs.samples_per_pixel, theirs.max_depth, device="cpu",
        )
        np.testing.assert_array_equal(cr.pack_camera(carried).numpy(), pr.pack_camera(theirs))


def test_cover_scene_statistics():
    """The port's own cover_scene(seed) draws with numpy, not threefry, so
    it is held in law: slot layout, active count, material mix, and the
    0.9 exclusion radius around (4, 0.2, 0)."""
    mats, n_active = [], []
    for seed in range(8):
        sc = scene_lib.cover_scene(seed, device="cpu")
        assert sc.num_slots == 512
        assert sc.center.dtype == torch.float32 and sc.mat_type.dtype == torch.int32
        active = sc.active.numpy()
        assert active[:4].all() and not active[488:].any()
        grid = slice(4, 488)
        c = sc.center[grid].numpy()
        dist = np.linalg.norm(c - np.array([4.0, 0.2, 0.0]), axis=1)
        np.testing.assert_array_equal(active[grid], dist > 0.9)
        assert np.all(c[:, 1] == np.float32(0.2))
        n_active.append(int(active.sum()))
        mats.append(sc.mat_type[grid].numpy()[active[grid]])
        fuzz = sc.fuzz[grid].numpy()
        metal = sc.mat_type[grid].numpy() == scene_lib.METAL
        assert np.all((fuzz[metal] >= 0) & (fuzz[metal] < 0.5)) and np.all(fuzz[~metal] == 0)
        assert np.all(sc.albedo[grid].numpy()[metal] >= 0.5)
    # The exclusion disc removes about pi*0.9^2/0.81 ~ 3 of 484 cells.
    assert 480 <= np.mean(n_active) - 4 <= 484
    mix = np.bincount(np.concatenate(mats), minlength=3) / sum(len(m) for m in mats)
    np.testing.assert_allclose(mix, [0.8, 0.15, 0.05], atol=0.03)
    a, b = scene_lib.cover_scene(3, device="cpu"), scene_lib.cover_scene(3, device="cpu")
    assert torch.equal(a.center, b.center) and not torch.equal(a.center, scene_lib.cover_scene(4, device="cpu").center)


@pytest.mark.parametrize(
    "build",
    [
        lambda: scene_lib.scene_from_numpy(_numpy(scene_lib.single_sphere_scene(device="cpu"))),
        lambda: scene_lib.from_spheres([[0.0, 0.0, -1.0]], [0.5], [scene_lib.LAMBERTIAN]),
        lambda: scene_lib.single_sphere_scene(pad_to=128),
        lambda: scene_lib.three_sphere_scene(pad_to=128),
        lambda: scene_lib.cover_scene_reference(),
        lambda: scene_lib.cover_scene(0),
        lambda: make_camera(image_width=32),
        lambda: camera_from_numpy(
            {f: np.asarray(getattr(make_camera(image_width=32, device="cpu"), f)) for f in (
                "center", "pixel00_loc", "pixel_delta_u", "pixel_delta_v",
                "defocus_disk_u", "defocus_disk_v", "defocus_angle")}, 32, 21, 10, 50),
        lambda: make_scene_from_config(RenderConfig()),
        lambda: make_camera_from_config(RenderConfig()),
        lambda: milestones.book_camera(),
        lambda: milestones.positioned_camera(),
        lambda: milestones.sphere_ground_scene(),
        lambda: milestones.metal_trio_scene(),
        lambda: milestones.glass_trio_scene(hollow=True),
        lambda: milestones.two_sphere_wide_scene(),
        lambda: milestones.refract_trio_scene(),
        lambda: milestones.single_sphere_sky_scene(),
        lambda: milestones.first_gradient_image(4, 2),
    ],
    ids=["scene_from_numpy", "from_spheres", "single", "three", "cover_reference", "cover",
         "make_camera", "camera_from_numpy", "scene_from_config", "camera_from_config",
         "book_camera", "positioned_camera", "sphere_ground", "metal_trio", "glass_trio",
         "two_sphere_wide", "refract_trio", "single_sphere_sky", "first_gradient_image"],
)
def test_builders_default_to_the_card_and_never_fall_back(build, monkeypatch):
    """Called without `device`, every builder builds on the card; without a
    GPU it raises and names device='cpu', rather than returning CPU tensors."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
