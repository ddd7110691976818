"""The yardstick and the plain reference at tiny sizes on the CPU: the
frozen scene is the port's cover_scene(0), the bound arithmetic gives the
records' figure, the reference agrees with itself however it is split,
and with the port's plain versions bit for bit."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rtbench import yardstick
from rtbench.reference import common, keyed, pcg

W, H, DEPTH = 24, 16, 8


@pytest.fixture(scope="module")
def scene():
    return common.scene_tensors(common.scene_arrays(), "cpu")


@pytest.fixture(scope="module")
def cam():
    return common.make_camera(W, H, (13.0, 2.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 20.0, 0.6, 10.0, "cpu")


def test_frozen_scene_is_the_ports_cover_scene_0():
    from ray_tracing_in_one_weekend_tpu_torch.models.scene import cover_scene

    port = cover_scene(0, device="cpu")
    arrays = common.scene_arrays()
    for f in common.FIELDS:
        assert np.array_equal(arrays[f], getattr(port, f).numpy()), f
    assert int(arrays["active"].sum()) == 485
    assert np.bincount(arrays["mat_type"][arrays["active"]]).tolist() == [396, 72, 17]


def test_bound_arithmetic_gives_the_keyed_sweeps_figure():
    # PERF.md: 27,290,362 sweeps x 485 spheres x 16 operations at 67 TFLOP/s.
    bound = yardstick.threefry_render_bound_s(27_290_362, 485, 512, 1200 * 800)
    assert round(bound * 1e3, 3) == 3.161
    assert yardstick.bound_s(67e12, 0.0) == 1.0 and yardstick.bound_s(0.0, 3.35e12) == 1.0


def test_kernel_names_are_told_apart():
    assert yardstick.kernel_of("render_kernel(float4 const*, int)") == "render_kernel"
    assert yardstick.kernel_of("void tfr::threefry_render_kernel(float4 const*)") == "threefry_render_kernel"
    assert yardstick.kernel_of("grad_reduce_partials(float const*)") == "grad_reduce"
    assert yardstick.kernel_of("void at::native::elementwise_kernel<128, 4>") is None
    assert not yardstick.HAND_WRITTEN.search("void at::native::radixSortKVInPlace")


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_pcg_reference_is_the_same_however_split(scene, cam, seed):
    p_mat = pcg.pack_scene(scene)
    pix = torch.arange(W * H)
    whole, work = pcg.render_pixels(p_mat, cam, pix, seed % 2**31, 4, 3, DEPTH)
    part, part_work = pcg.render_pixels(p_mat, cam, pix[5:40], seed % 2**31, 4, 3, DEPTH)
    assert torch.equal(whole[5:40], part) and torch.equal(work[5:40], part_work)
    assert bool((work >= 4).all()) and bool((work <= 4 * DEPTH).all())


def test_keyed_reference_is_the_same_however_split(scene, cam):
    pix = torch.arange(W * H)
    key = (7, 2**32 - 3)
    whole, work = keyed.render_pixels(scene, cam, pix, key, 4, 2, DEPTH)
    rad = torch.cat([keyed.sample_radiance(scene, cam, pix, key, s, 1, DEPTH)[0] for s in range(2, 6)])
    part, part_work = keyed.render_pixels(scene, cam, pix[100:130], key, 4, 2, DEPTH)
    assert torch.equal(whole, keyed.fold(rad, 4))
    assert torch.equal(whole[100:130], part) and torch.equal(work[100:130], part_work)


def test_reference_is_the_ports_plain_versions_bit_for_bit(scene, cam):
    from ray_tracing_in_one_weekend_tpu_torch.models.camera import make_camera
    from ray_tracing_in_one_weekend_tpu_torch.models.scene import scene_from_numpy
    from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_render import render_cuda
    from ray_tracing_in_one_weekend_tpu_torch.ops.render import render_flat_threefry

    port_scene = scene_from_numpy(common.scene_arrays(), device="cpu")
    port_cam = make_camera(image_width=W, aspect_ratio=W / H, samples_per_pixel=4, max_depth=DEPTH, device="cpu")
    for f in ("center", "pixel00_loc", "pixel_delta_u", "pixel_delta_v", "defocus_disk_u", "defocus_disk_v"):
        assert torch.equal(getattr(port_cam, f), cam[f]), f
    pix = torch.arange(W * H)
    img, work = render_cuda(port_scene, port_cam, seed=9, spp=4, sample_offset=2, return_work=True, warm=False)
    ref, ref_work = pcg.render_pixels(pcg.pack_scene(scene), cam, pix, 9, 4, 2, DEPTH)
    assert torch.equal(img.reshape(-1, 3), ref) and torch.equal(work.reshape(-1).long(), ref_work)
    colors, kwork = render_flat_threefry(port_scene, port_cam, pix, (5, 6), spp=4, sample_offset=2, return_work=True)
    kref, kref_work = keyed.render_pixels(scene, cam, pix, (5, 6), 4, 2, DEPTH)
    assert torch.equal(colors, kref) and torch.equal(kwork.long(), kref_work)


def test_keyed_reference_gradient_is_the_ports(scene, cam):
    from ray_tracing_in_one_weekend_tpu_torch.models.camera import make_camera
    from ray_tracing_in_one_weekend_tpu_torch.models.scene import scene_from_numpy
    from ray_tracing_in_one_weekend_tpu_torch.parallel import dist

    port_scene = scene_from_numpy(common.scene_arrays(), device="cpu")
    port_cam = make_camera(image_width=W, aspect_ratio=W / H, samples_per_pixel=2, max_depth=DEPTH, device="cpu")
    target = torch.full((H, W, 3), 0.25)
    params = {k: getattr(port_scene, k) for k in ("center", "radius", "albedo", "fuzz", "ior")}
    loss, grads = dist.render_grads(params, port_scene, port_cam, target, (3, 4))
    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    colors, _ = keyed.render_pixels(dict(scene, **leaves), cam, torch.arange(W * H), (3, 4), 2, 0, DEPTH)
    ref_loss = torch.mean((colors.reshape(H, W, 3) - target) ** 2)
    ref_loss.backward()
    assert float(abs(ref_loss.detach() - loss)) <= 1e-7 * float(loss)
    for k, g in grads.items():
        scale = float(leaves[k].grad.norm()) or 1.0
        assert float((g - leaves[k].grad).norm()) <= 1e-5 * scale, k


def test_the_control_is_far_from_the_reference(scene, cam):
    pix = torch.arange(W * H)
    ref, _ = pcg.render_pixels(pcg.pack_scene(scene), cam, pix, 3, 4, 0, DEPTH)
    low, _ = pcg.render_pixels(pcg.pack_scene(scene, torch.bfloat16), cam, pix, 3, 4, 0, DEPTH, torch.bfloat16)
    assert float((low.float() - ref).abs().mean()) > 0.01
    kref, _ = keyed.render_pixels(scene, cam, pix, (1, 2), 4, 0, DEPTH)
    klow, _ = keyed.render_pixels(scene, cam, pix, (1, 2), 4, 0, DEPTH, torch.bfloat16)
    assert float((klow.float() - kref).abs().mean()) > 0.01
