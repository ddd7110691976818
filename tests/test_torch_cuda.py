"""The CUDA kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU with nvcc (they build csrc/ on first use)
and skip without one. They repeat phases 3-5 of chip_smoke.py, and check
that the wrapper refuses what the kernel does not take. On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch

from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.models.camera import make_camera
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
from ray_tracing_in_one_weekend_tpu_torch.utils import compare

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU interpret mode)")
    return torch.device("cuda", 0)


def _cam(dev, **kw):
    kw = {"image_width": 64, "aspect_ratio": 2.0, "samples_per_pixel": 4, "max_depth": 8, **kw}
    return make_camera(device=dev, **kw)


def _inputs(scene, cam):
    n = cam.image_width * cam.image_height
    sf, si = cr._init_state(0, -(-n // 128) * 128, n, cam.samples_per_pixel, scene.device)
    return cr.pack_scene(scene), cr.pack_camera(cam), sf, si, n


def test_kernel_matches_plain_one_pass(dev):
    """A budgeted pass from fresh state, then an unbudgeted one from where
    it stopped: at most 2% flipped lanes, block means within the mode-check
    thresholds. (Built without FMA contraction, they are bit-identical on
    an H100.)"""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    scene = scene_lib.cover_scene_reference(device=dev)
    cam = _cam(dev)
    spp, depth = cam.samples_per_pixel, cam.max_depth
    p_mat, cam_vec, sf, si, n = _inputs(scene, cam)
    for budget in (3, spp * depth):
        args = (cam_vec, (0, 0, 0, budget), sf, si, 128, spp, depth)
        before = build.LAUNCHES["render_kernel"]
        of_k, oi_k = build.render_pass(p_mat.T.contiguous(), *args)
        assert build.LAUNCHES["render_kernel"] == before + 1
        of_p, oi_p = cr._render_pass_plain(p_mat, *args)
        torch.cuda.synchronize()
        agree = compare.lane_states(of_k, oi_k, of_p, oi_p, n, spp)
        assert agree.flipped_frac <= 0.02, agree
        assert agree.blocks_agree, agree
        sf, si = of_p, oi_p


def test_sky_only_and_nan_as_miss(dev):
    scene = scene_lib.cover_scene_reference(device=dev)
    cam = _cam(dev)
    sky = scene.replace(active=torch.zeros_like(scene.active))
    img_k = cr.render_cuda(sky, cam)
    img_p = cr.render_with(cr._render_pass_plain, sky, cam)
    assert float((img_k - img_p).abs().max()) <= 1e-6
    up = _cam(dev, lookfrom=(0.0, 50.0, 0.0), lookat=(0.0, 100.0, 0.0), vup=(1.0, 0.0, 0.0))
    img, work = cr.render_cuda(scene, up, return_work=True)
    assert bool(torch.isfinite(img).all())
    assert bool((work == up.samples_per_pixel).all()), "a sky-bound ray hit a sphere"
    assert float((img[..., 2] - 1.0).abs().max()) < 1e-5


def test_passes_bit_identical(dev):
    scene = scene_lib.cover_scene_reference(device=dev)
    cam = _cam(dev)
    one = cr.render_cuda(scene, cam, n_passes=1)
    assert torch.equal(cr.render_cuda(scene, cam, n_passes=3, budget=3), one)
    assert torch.equal(cr.render_cuda(scene, cam, tile=256), one)


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    scene = scene_lib.three_sphere_scene(pad_to=128, device=dev)
    p_mat, cam_vec, sf, si, _ = _inputs(scene, _cam(dev))
    table = p_mat.T.contiguous()
    args = (cam_vec, (0, 0, 0, 4), sf, si, 128, 4, 8)
    with pytest.raises(ValueError, match="contiguous"):
        build.render_pass(p_mat.T, *args)
    with pytest.raises(TypeError, match="dtype"):
        build.render_pass(table, cam_vec, (0, 0, 0, 4), sf, si.float(), 128, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        build.render_pass(table.cpu(), cam_vec.cpu(), (0, 0, 0, 4), sf.cpu(), si.cpu(), 128, 4, 8)
    for tile in (100, 1024):
        with pytest.raises(ValueError, match="tile"):
            build.render_pass(table, cam_vec, (0, 0, 0, 4), sf, si, tile, 4, 8)
    big = cr.pack_scene(scene_lib.three_sphere_scene(pad_to=1024, device=dev)).T.contiguous()
    with pytest.raises(ValueError, match="shared-memory"):
        build.render_pass(big, *args)
