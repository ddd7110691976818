"""The port's NaN guards (utils/debug.py), on the cases of tests/test_debug.py,
and their verdicts against the JAX package's checkify form on the same
poisoned scenes and cameras (its render traced once a case for the module)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tracing_in_one_weekend_tpu.models import scene as jax_scene
from ray_tracing_in_one_weekend_tpu.models.camera import make_camera as jax_make_camera
from ray_tracing_in_one_weekend_tpu.utils import debug as jax_debug
from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.models.camera import camera_from_numpy, make_camera
from ray_tracing_in_one_weekend_tpu_torch.utils import debug

torch.set_num_threads(2)


CAM = dict(image_width=16, aspect_ratio=2.0, samples_per_pixel=2, max_depth=4, vfov_degrees=90.0,
           lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0), defocus_angle_degrees=0.0,
           focus_dist=1.0)
FIELDS = ("center", "radius", "albedo", "fuzz", "ior", "mat_type", "active")
CAM_FIELDS = ("center", "pixel00_loc", "pixel_delta_u", "pixel_delta_v",
              "defocus_disk_u", "defocus_disk_v", "defocus_angle")
# (scene or camera, field, index, value) written into the arrays that both
# packages render. single_sphere_scene(pad_to=8) has slots 0-1 active.
POISON = {
    "clean": None,
    "nan_center": ("scene", "center", (0, 0), np.nan),
    "inf_camera": ("camera", "pixel_delta_u", (0,), np.inf),
    "nan_center_inactive_slot": ("scene", "center", (5, 0), np.nan),
}


def _cam():
    return make_camera(**CAM, device="cpu")


def _poisoned_arrays(case):
    """(scene arrays, camera arrays) of the JAX package's single-sphere scene
    and CAM, with POISON[case] written in."""
    js, jc = jax_scene.single_sphere_scene(pad_to=8), jax_make_camera(**CAM)
    arrays = {"scene": {f: np.array(getattr(js, f)) for f in FIELDS},
              "camera": {f: np.array(getattr(jc, f)) for f in CAM_FIELDS}}
    if POISON[case] is not None:
        which, field, index, value = POISON[case]
        arrays[which][field][index] = value
    return arrays["scene"], arrays["camera"]


@pytest.fixture(scope="module")
def jax_verdicts():
    """case -> whether the JAX package's checked_render raises on it."""
    verdicts = {}
    for case in POISON:
        sa, ca = _poisoned_arrays(case)
        js = jax_scene.single_sphere_scene(pad_to=8).replace(**{f: jnp.asarray(sa[f]) for f in FIELDS})
        jc = jax_make_camera(**CAM).replace(**{f: jnp.asarray(ca[f]) for f in CAM_FIELDS})
        err, _ = jax_debug.checked_render(js, jc, 0, chunk_size=128)
        verdicts[case] = err.get() is not None
    return verdicts


def _port_verdict(case):
    """(whether the port's checked_render raises, whether its image is finite)."""
    sa, ca = _poisoned_arrays(case)
    sc = scene_lib.scene_from_numpy(sa, device="cpu")
    cam = camera_from_numpy(ca, CAM["image_width"], CAM["image_width"] // 2, CAM["samples_per_pixel"],
                            CAM["max_depth"], device="cpu")
    err, img = debug.checked_render(sc, cam, 0)
    return err.get() is not None, bool(torch.isfinite(img).all())


@pytest.mark.parametrize("case", ["clean", "nan_center", "inf_camera"])
def test_verdict_matches_jax_checkify(jax_verdicts, case):
    """Clean inputs pass and a NaN scene center or an infinite camera delta
    raises, in both packages."""
    assert jax_verdicts[case] == (case != "clean")
    assert _port_verdict(case)[0] == jax_verdicts[case]


def test_inactive_slot_is_checked_by_jax_only(jax_verdicts):
    """Where the two differ by design: a NaN in an inactive slot. checkify
    sees the NaN that the JAX render's intersection test makes of it; the
    port never reads an inactive slot, so it checks none, and its image is
    finite."""
    assert jax_verdicts["nan_center_inactive_slot"]
    assert _port_verdict("nan_center_inactive_slot") == (False, True)


def test_clean_render_passes():
    sc = scene_lib.single_sphere_scene(pad_to=8, device="cpu")
    err, img = debug.checked_render(sc, _cam(), 0)
    err.throw()  # no error
    assert err.get() is None
    assert img.shape == (8, 16, 3) and bool(torch.isfinite(img).all())


def test_poisoned_scene_is_caught_where_the_image_is_finite():
    """A NaN center makes the sphere a miss, so the image is finite; the
    input check catches it all the same."""
    sc = scene_lib.single_sphere_scene(pad_to=8, device="cpu")
    center = sc.center.clone()
    center[0, 0] = float("nan")
    err, img = debug.checked_render(sc.replace(center=center), _cam(), 0)
    assert bool(torch.isfinite(img).all())
    with pytest.raises(FloatingPointError, match=r"scene\.center"):
        err.throw()


def test_poisoned_camera_is_caught():
    cam = _cam()
    cam = dataclasses.replace(cam, pixel_delta_u=torch.tensor([float("inf"), 0.0, 0.0]))
    err, _ = debug.checked_render(scene_lib.single_sphere_scene(pad_to=8, device="cpu"), cam, 0)
    with pytest.raises(FloatingPointError, match="camera"):
        err.throw()


def test_assert_finite_tree():
    debug.assert_finite_tree({"a": torch.ones(3)})
    with pytest.raises(AssertionError, match=r"non-finite values in params\['a'\]"):
        debug.assert_finite_tree({"a": torch.tensor([1.0, float("inf")])}, "params")
    sc = scene_lib.three_sphere_scene(pad_to=8, device="cpu")
    debug.assert_finite_tree([sc, _cam()], "inputs")
    radius = sc.radius.clone()
    radius[2] = float("nan")
    with pytest.raises(AssertionError, match=r"inputs\[1\]\.radius"):
        debug.assert_finite_tree([_cam(), sc.replace(radius=radius)], "inputs")
