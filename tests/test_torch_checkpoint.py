"""The port's progressive accumulation (utils/checkpoint.py): against one
render, against the JAX package's Pallas accumulation, and checkpoint
files that cross between the two packages.

The JAX side runs its Pallas kernel in interpret mode, as its own tests
do, once for the module.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tracing_in_one_weekend_tpu.models import scene as jax_scene
from ray_tracing_in_one_weekend_tpu.models.camera import make_camera as jax_make_camera
from ray_tracing_in_one_weekend_tpu.utils import checkpoint as jax_ckpt
from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.models.camera import camera_from_numpy
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
from ray_tracing_in_one_weekend_tpu_torch.utils import checkpoint as ckpt
from ray_tracing_in_one_weekend_tpu_torch.utils import compare

torch.set_num_threads(2)

FIELDS = ("center", "radius", "albedo", "fuzz", "ior", "mat_type", "active")
CAM_FIELDS = ("center", "pixel00_loc", "pixel_delta_u", "pixel_delta_v",
              "defocus_disk_u", "defocus_disk_v", "defocus_angle")
# tests/test_checkpoint.py's Pallas setup: 32x16, 8 spp, depth 4.
CAM = dict(image_width=32, aspect_ratio=2.0, samples_per_pixel=8, max_depth=4, vfov_degrees=90.0,
           lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0), defocus_angle_degrees=0.0,
           focus_dist=1.0)
BATCHES = (3, 1, 4)
SEED = 3


@pytest.fixture(scope="module")
def setup():
    """(JAX scene, JAX camera, the same scene and camera in the port on the
    CPU, JAX's Pallas accumulation over BATCHES)."""
    js, jc = jax_scene.single_sphere_scene(pad_to=128), jax_make_camera(**CAM)
    sc = scene_lib.scene_from_numpy({f: np.asarray(getattr(js, f)) for f in FIELDS}, device="cpu")
    cam = camera_from_numpy({f: np.asarray(getattr(jc, f)) for f in CAM_FIELDS}, jc.image_width,
                            jc.image_height, jc.samples_per_pixel, jc.max_depth, device="cpu")
    state = jax_ckpt.new_state(jc)
    for n in BATCHES:
        state = jax_ckpt.accumulate(state, js, jc, SEED, n, backend="pallas", tile=128, interpret=True)
    return js, jc, sc, cam, state


def _accumulate(sc, cam, batches=BATCHES):
    state = ckpt.new_state(cam, device="cpu")
    for n in batches:
        state = ckpt.accumulate(state, sc, cam, SEED, n, tile=128)
    return state


def test_batched_accumulation_matches_monolithic(setup):
    """Batches 3 + 1 + 4 cover the samples of one 8-spp render: equal to
    float rounding of the re-associated mean (the JAX test's gate, 1e-6)."""
    _, _, sc, cam, _ = setup
    state = _accumulate(sc, cam)
    assert state.spp_done == 8 and state.accum.dtype == torch.float32
    assert state.work.shape == (16, 32)
    mono = cr.render_cuda(sc, cam, seed=SEED, spp=8)
    np.testing.assert_allclose(state.image.numpy(), mono.numpy(), atol=1e-6)


def test_accumulation_matches_jax_pallas(setup):
    """The same batches through the JAX package's Pallas kernel (interpret
    mode): within the port's bound against that kernel (pixels off by more
    than 1e-3 under 3%, block means within the mode-check thresholds)."""
    _, _, sc, cam, theirs = setup
    ours = _accumulate(sc, cam)
    assert int(theirs.spp_done) == ours.spp_done == 8
    agree = compare.images(ours.image, torch.from_numpy(np.array(theirs.image)), block=8, atol=1e-3)
    assert agree.flipped_frac < 0.03, agree
    assert agree.blocks_agree, agree


def test_checkpoint_files_cross_packages(setup, tmp_path):
    """A file JAX's `save` wrote loads in the port with equal arrays, and
    the port's loads in JAX."""
    js, jc, sc, cam, theirs = setup
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save(theirs, path)
    loaded = ckpt.load(path, device="cpu")
    assert loaded.spp_done == 8
    np.testing.assert_array_equal(loaded.accum.numpy(), np.asarray(theirs.accum))
    np.testing.assert_array_equal(loaded.work.numpy(), np.asarray(theirs.work))

    ours = _accumulate(sc, cam, (3,))
    path = str(tmp_path / "torch.npz")
    ckpt.save(ours, path)
    back = jax_ckpt.load(path)
    assert int(back.spp_done) == 3 and back.spp_done.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(back.accum), ours.accum.numpy())
    np.testing.assert_array_equal(np.asarray(back.work), ours.work.numpy())


def test_resume_from_disk_is_bit_identical(setup, tmp_path):
    """Saving after 3 samples, loading and rendering the other 5 gives the
    bits of the run that never stopped."""
    _, _, sc, cam, _ = setup
    path = os.path.join(tmp_path, "state.npz")
    ckpt.save(_accumulate(sc, cam, (3,)), path)
    resumed = ckpt.accumulate(ckpt.load(path, device="cpu"), sc, cam, SEED, 5, tile=128)
    assert resumed.spp_done == 8
    assert torch.equal(resumed.image, _accumulate(sc, cam, (3, 5)).image)


def test_empty_state_image_is_zero(setup):
    state = ckpt.new_state(setup[3], device="cpu")
    assert state.spp_done == 0 and state.work is None
    assert state.image.shape == (16, 32, 3) and float(state.image.abs().max()) == 0.0


def test_state_and_scene_on_two_devices_raise(setup):
    """Nothing moves a state to the scene's device silently."""
    _, _, sc, cam, _ = setup
    with pytest.raises(ValueError, match="one device"):
        ckpt.accumulate(ckpt.new_state(cam, device="meta"), sc, cam, SEED, 1)
