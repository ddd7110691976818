"""The port's lane scheduler (tail compaction, cost-sorted permutations, the
warm-start cache) against the JAX package's, on the CPU.

`_compact` and `_perm_from_hint` are integer permutations and must equal
the JAX functions index for index on the same inputs. Every schedule is a
pure lane permutation, so the image must be the same bits for any tile,
pass count, budget, hint or cache state. The whole compacted render is
held against JAX `render_pallas` in interpret mode with the flipped-lane
bounds of tests/test_torch_render.py (sin, cos and rsqrt differ in the
last ulp between the frameworks, and a bounce off a small sphere turns
such a difference into another path).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tracing_in_one_weekend_tpu.models import scene as jax_scene
from ray_tracing_in_one_weekend_tpu.models.camera import make_camera as jax_make_camera
from ray_tracing_in_one_weekend_tpu.ops import pallas_render as pr
from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.models.camera import make_camera
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
from ray_tracing_in_one_weekend_tpu_torch.utils import compare

torch.set_num_threads(2)

FIELDS = ("center", "radius", "albedo", "fuzz", "ior", "mat_type", "active")
# The __graft_entry__ camera: the cover-scene view at 64x32.
CAM = dict(image_width=64, aspect_ratio=2.0, samples_per_pixel=2, max_depth=8)


@pytest.fixture(scope="module")
def cover():
    """The JAX cover_scene(0) and the same layout in the port."""
    theirs = jax_scene.cover_scene(0)
    ours = scene_lib.scene_from_numpy({f: np.asarray(getattr(theirs, f)) for f in FIELDS}, device="cpu")
    return theirs, ours


@pytest.fixture
def small():
    """Three spheres (lambertian, dielectric, metal) seen close up at 64x32,
    spp 4, depth 6: paths of very different lengths side by side."""
    sc = scene_lib.three_sphere_scene(pad_to=128, device="cpu")
    cam = make_camera(device="cpu", image_width=64, aspect_ratio=2.0, samples_per_pixel=4, max_depth=6,
                      lookfrom=(0.0, 0.0, 0.5), lookat=(0.0, 0.0, -1.0), vfov_degrees=90.0,
                      focus_dist=1.5, defocus_angle_degrees=0.0)
    return sc, cam


@pytest.fixture(autouse=True)
def empty_cache():
    cr._WORK_CACHE.clear()
    yield
    cr._WORK_CACHE.clear()


def _state_after_one_pass(scene, spp, budget, seed=0):
    """The lane state of the cover view at 64x32 after one budgeted plain
    pass: busy lanes mid-path, finished lanes, lanes with samples left."""
    cam = make_camera(**dict(CAM, samples_per_pixel=spp), device="cpu")
    n = cam.num_pixels
    sf, si = cr._init_state(0, n, n, spp)
    return cr._render_pass_plain(cr.pack_scene(scene), cr.pack_camera(cam), (seed, 0, 0, budget),
                                 sf, si, 128, spp, CAM["max_depth"])


@pytest.mark.parametrize("tile,spp,budget", [(128, 2, 3), (256, 4, 5), (512, 3, 4)])
def test_compact_matches_jax_index_for_index(cover, tile, spp, budget):
    _, ours = cover
    sf, si = _state_after_one_pass(ours, spp, budget)
    unfinished = (si[cr._SI_BUSY] > 0) | (si[cr._SI_STARTED] < spp)
    assert 0 < int(unfinished.sum()) < sf.shape[1], "the pass must leave a mixed state"
    sf_j, si_j, inv_j = pr._compact(jnp.asarray(sf.numpy()), jnp.asarray(si.numpy()), tile, spp)
    sf_t, si_t, inv_t = cr._compact(sf, si, tile, spp)
    np.testing.assert_array_equal(inv_t.numpy(), np.asarray(inv_j))
    np.testing.assert_array_equal(si_t.numpy(), np.asarray(si_j))
    np.testing.assert_array_equal(sf_t.numpy(), np.asarray(sf_j))
    # A permutation whose inverse gathers the state back.
    assert torch.equal(sf_t[:, inv_t], sf) and torch.equal(si_t[:, inv_t], si)
    # Unfinished lanes are packed into the front blocks.
    moved = (si_t[cr._SI_BUSY] > 0) | (si_t[cr._SI_STARTED] < spp)
    n_blocks = -(-int(unfinished.sum()) // 128) + sf.shape[1] // tile
    assert not bool(moved[n_blocks * 128 :].any())


def test_compact_refuses_a_partial_block(cover):
    _, ours = cover
    sf, si = _state_after_one_pass(ours, 2, 3)
    with pytest.raises(ValueError, match="multiple of 128"):
        cr._compact(sf, si, 64, 2)


@pytest.mark.parametrize("n_slabs", [1, 2])
def test_perm_from_hint_matches_jax(n_slabs):
    hint = np.random.default_rng(0).uniform(0.0, 10.0, 512).astype(np.float32)
    hint[100:140] = 0.0  # dead lanes: ties that the stable sort keeps in order
    hint[300:310] = 4.0
    ours = cr._perm_from_hint(torch.from_numpy(hint), n_slabs=n_slabs)
    theirs = np.asarray(pr._perm_from_hint(jnp.asarray(hint), n_slabs=n_slabs))
    assert ours.shape == theirs.shape == (2, n_slabs, 512 // n_slabs)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    if n_slabs == 1:
        # What the differentiable render's warm carry uses.
        perm, inv = ours.reshape(2, -1)
        assert torch.equal(perm, cr._cost_perm(torch.from_numpy(hint)))
        assert torch.equal(perm[inv], torch.arange(512))


@pytest.mark.parametrize(
    "kw",
    [
        dict(n_passes=3),
        dict(n_passes=4, budget=3),
        dict(n_passes=2, budget=1),
        dict(n_passes=3, budget=(9, 2)),
        dict(n_passes=3, budget=[1, 30]),
        dict(tile=256),
        dict(tile=384, n_passes=2, budget=2),
        dict(hint="work"),
        dict(hint="random"),
        dict(hint="random", n_passes=3, budget=2),
        dict(warm=True),
    ],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()),
)
def test_schedule_changes_no_pixel(small, kw):
    sc, cam = small
    base, work = cr.render_cuda(sc, cam, n_passes=1, warm=False, return_work=True)
    kw = dict(kw)
    hint = kw.pop("hint", None)
    if hint == "work":
        kw["work_hint"] = work
    elif hint == "random":
        kw["work_hint"] = torch.from_numpy(
            np.random.default_rng(1).uniform(0, 40, work.shape).astype(np.float32))
    if kw.pop("warm", False):
        assert torch.equal(cr.render_cuda(sc, cam), base)  # cold, fills the cache
        assert cr.warm_cache_hit(sc, cam)
    else:
        kw["warm"] = False
    img, work2 = cr.render_cuda(sc, cam, return_work=True, **kw)
    assert torch.equal(img, base)
    assert torch.equal(work2, work)  # the cost map comes back in pixel order


def test_multipass_work_hint_compacts_before_the_first_pass(small):
    """`_multipass`'s own `work_hint`: the hint seeds the compaction's
    estimate, the lanes are compacted before pass 1, and the work row is
    cleared, so the image and the cost map are those of pixel order."""
    sc, cam = small
    spp, depth, n = cam.samples_per_pixel, cam.max_depth, cam.num_pixels
    p_mat, cam_vec = cr.pack_scene(sc), cr.pack_camera(cam)
    runs = []
    for hint in (None, torch.from_numpy(np.random.default_rng(2).uniform(0, 9, n).astype(np.float32))):
        sf, si = cr._init_state(0, n, n, spp)
        runs.append(cr._multipass(p_mat, cam_vec, (0, 0, 0, 0), sf, si, 128, spp, depth, 3, 2,
                                  cr._render_pass_plain, work_hint=hint))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


def test_budget_schedule_must_cover_the_passes(small):
    sc, cam = small
    with pytest.raises(ValueError, match="budget schedule"):
        cr.render_cuda(sc, cam, budget=(6,), n_passes=3, warm=False)
    with pytest.raises(ValueError, match="n_passes"):
        cr.render_cuda(sc, cam, n_passes=0, warm=False)


def test_warm_cache_hits_only_the_filled_realization(small):
    sc, cam = small
    cold = {s: cr.render_cuda(sc, cam, seed=s, warm=False) for s in (3, 5)}
    assert len(cr._WORK_CACHE) == 0, "warm=False must not fill the cache"
    assert not cr.warm_cache_hit(sc, cam, seed=3)
    assert torch.equal(cr.render_cuda(sc, cam, seed=3), cold[3])
    assert len(cr._WORK_CACHE) == 1 and cr.warm_cache_hit(sc, cam, seed=3)
    (perm_inv, fill_seed, fill_offset), = cr._WORK_CACHE.values()
    assert (fill_seed, fill_offset) == (3, 0) and perm_inv.shape == (2, cam.num_pixels)
    assert torch.equal(cr.render_cuda(sc, cam, seed=3), cold[3])  # the hit
    # Another seed or sample window misses, runs cold and refills in place.
    assert not cr.warm_cache_hit(sc, cam, seed=5)
    assert not cr.warm_cache_hit(sc, cam, seed=3, sample_offset=4)
    assert torch.equal(cr.render_cuda(sc, cam, seed=5), cold[5])
    assert len(cr._WORK_CACHE) == 1 and next(iter(cr._WORK_CACHE.values()))[1] == 5
    assert cr.warm_cache_hit(sc, cam, seed=5) and not cr.warm_cache_hit(sc, cam, seed=3)
    # spp and tile are part of the key.
    assert not cr.warm_cache_hit(sc, cam, seed=5, spp=2)
    assert not cr.warm_cache_hit(sc, cam, seed=5, tile=256)


def test_warm_cache_evicts_the_oldest_beyond_eight(small):
    sc, cam = small
    for spp in range(1, cr._WORK_CACHE_MAX + 4):
        cr.render_cuda(sc, cam, spp=spp, max_depth=2)
    assert len(cr._WORK_CACHE) == cr._WORK_CACHE_MAX == 8
    kept = [key[-1] for key in cr._WORK_CACHE]
    assert kept == list(range(4, cr._WORK_CACHE_MAX + 4))  # spp 1-3 went first
    cr.render_cuda(sc, cam, spp=4, max_depth=2)  # a hit moves nothing out
    assert [key[-1] for key in cr._WORK_CACHE] == kept


def test_no_cache_under_autograd(small):
    sc, cam = small
    base = cr.render_cuda(sc, cam, warm=False)
    params = {k: v.detach().clone().requires_grad_() for k, v in cg.scene_params(sc).items()}
    graded = cg.scene_with_params(sc, params)
    assert torch.equal(cr.render_cuda(graded, cam).detach(), base)
    assert len(cr._WORK_CACHE) == 0, "a scene that requires grad filled the cache"
    assert not cr.warm_cache_hit(graded, cam)
    # The differentiable render neither reads nor fills the cache, and its
    # value is the render's, also after a warm render of the same scene.
    img, work = cg.render_cuda_diff(graded, cam, return_work=True)
    assert len(cr._WORK_CACHE) == 0
    assert torch.equal(img.detach(), base)
    assert torch.equal(cr.render_cuda(sc, cam), base) and len(cr._WORK_CACHE) == 1
    assert torch.equal(cg.render_cuda_diff(sc, cam).detach(), base)
    assert torch.equal(cg.render_cuda_diff(graded, cam, work_hint=work, n_passes=3).detach(), base)


def test_compacted_render_matches_jax_render_pallas(cover):
    """The cold 3-pass compacted render against JAX render_pallas in
    interpret mode with n_passes=3: pixels off by > 1e-3 below 3%, 8x8
    block-mean MAD < 0.02 and mean difference < 0.01 (the bounds of
    tests/test_torch_render.py), and the port's own one-pass render
    bit-identical."""
    theirs, ours = cover
    jcam, tcam = jax_make_camera(**CAM), make_camera(**CAM, device="cpu")
    img_j = np.array(pr.render_pallas(theirs, jcam, seed=0, tile=128, interpret=True,
                                        warm=False, n_passes=3))
    img_t = cr.render_cuda(ours, tcam, seed=0, n_passes=3, warm=False)
    assert torch.equal(img_t, cr.render_cuda(ours, tcam, seed=0, n_passes=1, warm=False))
    agree = compare.images(img_t, torch.from_numpy(img_j), block=8, atol=1e-3)
    assert agree.flipped_frac < 0.03, agree
    assert agree.blocks_agree, agree
