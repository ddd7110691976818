"""The port's render (plain PyTorch on the CPU) against the JAX kernel.

The JAX kernel runs in Pallas interpret mode, as its own tests run it.
Both sides share the streams bit for bit, so lanes agree to float32
rounding, except a few whose path a last-ulp difference (sin, cos and
rsqrt differ between the frameworks) turns at a bounce off a small
sphere. The tests bound that fraction, with margin over what was
measured, and hold block means to the JAX package's mode-check
thresholds (MAD < 0.02, mean difference < 0.01).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tracing_in_one_weekend_tpu.models import scene as jax_scene
from ray_tracing_in_one_weekend_tpu.models.camera import make_camera as jax_make_camera
from ray_tracing_in_one_weekend_tpu.ops import pallas_render as pr
from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.models.camera import make_camera
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
from ray_tracing_in_one_weekend_tpu_torch.utils import compare

torch.set_num_threads(2)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
FIELDS = ("center", "radius", "albedo", "fuzz", "ior", "mat_type", "active")
# The __graft_entry__ camera: the cover-scene view at 64x32.
CAM = dict(image_width=64, aspect_ratio=2.0, samples_per_pixel=2, max_depth=8)


def _carried_cover_scene():
    """The JAX cover_scene(0) and the same layout in the port."""
    theirs = jax_scene.cover_scene(0)
    ours = scene_lib.scene_from_numpy({f: np.asarray(getattr(theirs, f)) for f in FIELDS}, device="cpu")
    return theirs, ours


def test_one_pass_matches_jax_kernel():
    """One budgeted pass from identical fresh lane state. Busy lanes at the
    budget carry their mid-path o, d, att, depth and streams, all compared.

    Measured (seeds 0 and 7): integer rows differ on 0.3-0.4% of lanes and
    busy depth on 0.1-0.2%; radiance by > 1e-4 on 1.9-2.1%; the float
    rows' relative error has median 3e-6 and 90th percentile 3e-4 —
    chaotic growth of last-ulp differences along the paths. Bounds: 2%
    (integer rows, and the work counter), 5%, 1e-4 and 1e-2."""
    theirs, ours = _carried_cover_scene()
    spp, depth, budget, tile = CAM["samples_per_pixel"], CAM["max_depth"], 5, 128
    cam_vec = pr.pack_camera(jax_make_camera(**CAM))
    n = 64 * 32
    sf, si = pr._init_state(0, n, n, spp)
    p_mat = np.asarray(pr.pack_scene(theirs))
    of_j, oi_j = pr._render_pallas_core(
        jnp.asarray(p_mat), jnp.asarray(p_mat.T), jnp.asarray(cam_vec),
        jnp.asarray([7, 0, 0, budget], jnp.int32), sf, si, tile, spp, depth, True,
    )
    of_j, oi_j = torch.from_numpy(np.array(of_j)), torch.from_numpy(np.array(oi_j))
    of_t, oi_t = cr._render_pass_plain(
        cr.pack_scene(ours), torch.from_numpy(cam_vec), (7, 0, 0, budget),
        torch.from_numpy(np.array(sf)), torch.from_numpy(np.array(si)), tile, spp, depth,
    )
    assert int(oi_t[cr._SI_BUSY].sum()) > n // 4, "the budget must stop lanes mid-path"
    busy = oi_j[cr._SI_BUSY] > 0
    int_rows = [cr._SI_PIX, cr._SI_STARTED, cr._SI_STREAM, cr._SI_STREAM2, cr._SI_BUSY]
    int_diff = (oi_t[int_rows] != oi_j[int_rows]).any(dim=0)
    int_diff |= busy & (oi_t[cr._SI_DEPTH] != oi_j[cr._SI_DEPTH])
    assert float(int_diff.double().mean()) < 0.02
    agree = compare.lane_states(of_t, oi_t, of_j, oi_j, n, spp, depth_rows="busy")
    assert agree.flipped_frac < 0.05, agree
    assert agree.blocks_agree, agree
    rows = list(range(cr._SF_O, cr._SF_ATT + 3))
    rel = ((of_t[rows] - of_j[rows]).abs() / (of_j[rows].abs() + 1.0)).amax(dim=0).double()
    assert float(rel.median()) < 1e-4 and float(rel.quantile(0.9)) < 1e-2
    assert float((of_t[cr._SF_WORK] != of_j[cr._SF_WORK]).double().mean()) < 0.02


def test_render_matches_jax_render_pallas():
    """The whole render_cuda (plain, CPU) against render_pallas in interpret
    mode on the identical scene and packed camera: pixels off by > 1e-3
    (measured 0.3-0.7% over seeds 0-2; bound 3%), 8x8 block-mean MAD
    < 0.02 and mean difference < 0.01."""
    theirs, ours = _carried_cover_scene()
    jcam, tcam = jax_make_camera(**CAM), make_camera(**CAM, device="cpu")
    np.testing.assert_array_equal(cr.pack_camera(tcam).numpy(), pr.pack_camera(jcam))
    img_j = np.array(pr.render_pallas(theirs, jcam, seed=0, tile=128, interpret=True,
                                        warm=False, n_passes=1))
    img_t = cr.render_cuda(ours, tcam, seed=0)
    assert img_t.shape == (32, 64, 3) and img_t.dtype == torch.float32
    agree = compare.images(img_t, torch.from_numpy(img_j), block=8, atol=1e-3)
    assert agree.flipped_frac < 0.03, agree
    assert agree.blocks_agree, agree


def test_passes_budget_and_tile_change_no_pixel():
    sc = scene_lib.three_sphere_scene(pad_to=128, device="cpu")
    cam = make_camera(device="cpu", lookfrom=(0.0, 0.0, 0.5), lookat=(0.0, 0.0, -1.0), vfov_degrees=90.0,
                      focus_dist=1.5, defocus_angle_degrees=0.0, **dict(CAM, samples_per_pixel=4))
    base = cr.render_cuda(sc, cam, n_passes=1)
    for kw in (dict(n_passes=4, budget=3), dict(n_passes=2, budget=1), dict(tile=256)):
        assert torch.equal(cr.render_cuda(sc, cam, **kw), base), kw
    img, work = cr.render_cuda(sc, cam, return_work=True)
    assert torch.equal(img, base)
    assert work.shape == (32, 64) and float(work.min()) >= 4.0  # >= one bounce per sample
    with pytest.raises(ValueError, match="multiple of 128"):
        cr.render_cuda(sc, cam, tile=100)


def test_sample_offset_progressive_equality():
    """Rendering samples [0, 3) then [3, 5) and averaging equals one
    5-sample render, to float32 rounding of the re-associated mean."""
    _, sc = _carried_cover_scene()
    cam = make_camera(**CAM, device="cpu")
    full = cr.render_cuda(sc, cam, spp=5)
    a = cr.render_cuda(sc, cam, spp=3)
    b = cr.render_cuda(sc, cam, spp=2, sample_offset=3)
    np.testing.assert_allclose(((3 * a + 2 * b) / 5).numpy(), full.numpy(), atol=1e-6)
    assert not torch.equal(a, cr.render_cuda(sc, cam, spp=3, seed=1))


def test_shadow_acne_negative_example():
    """Without the t_min epsilon (reference: src/cpu/main.cc:19),
    scattered rays re-hit their own sphere at rounding distance and the
    image darkens into speckle — as the JAX kernel's own test shows."""
    sc = scene_lib.three_sphere_scene(pad_to=128, device="cpu")
    cam = make_camera(device="cpu", image_width=48, aspect_ratio=2.0, samples_per_pixel=8, max_depth=6,
                      lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0), vfov_degrees=90.0,
                      defocus_angle_degrees=0.0, focus_dist=1.0)
    good = cr.render_cuda(sc, cam)
    acne = cr.render_cuda(sc, cam, t_min=0.0)
    diff = float((acne - good).abs().mean())
    assert diff > 0.02, f"disabling t_min changed the image by only {diff:.4f}"
    assert float(acne.mean()) < float(good.mean()) - 0.01


def test_cover_scene_golden_image_parity():
    """The reference-exact scene with the reference CPU camera, against the
    reference's own 500-spp render, at tests/test_golden.py's framing and
    thresholds (152x101, 12 spp, depth 16; block-averaged to 38x25)."""
    pil = pytest.importorskip("PIL.Image")

    sc = scene_lib.cover_scene_reference(device="cpu")
    cam = make_camera(device="cpu", image_width=152, aspect_ratio=1.5, samples_per_pixel=12, max_depth=16,
                      vfov_degrees=20.0, lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
                      aperture=0.1, focus_dist=10.0)
    ours = cr.render_cuda(sc, cam).sqrt().numpy()
    golden = pil.open(os.path.join(GOLDEN_DIR, "ref_cpu_cover_1200x800_500spp.png"))
    size = (38, 25)
    a = np.asarray(
        pil.fromarray((np.clip(ours, 0, 1) * 255).astype(np.uint8)).resize(size, pil.BOX),
        np.float32,
    ) / 255.0
    b = np.asarray(golden.resize(size, pil.BOX), np.float32) / 255.0
    d = a - b
    assert np.abs(d).mean() < 0.02, f"MAD {np.abs(d).mean():.4f}"
    assert abs(d.mean()) < 0.01, f"bias {d.mean():.4f}"
    assert np.percentile(np.abs(d), 99) < 0.08
