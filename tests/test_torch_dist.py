"""The port's pixel x sample sharding (parallel/dist.py) on the CPU.

Two local launches through `parallel/worker.py`, 2 and 4 gloo ranks on
localhost, one torch thread a rank (the suite's other workers keep their
cores) and a 120 s timeout each, run every sharded case once; the tests
read their results. The references run here
in one process: the port on one device, and the JAX package's
single-device kernels in interpret mode (this file makes no multi-device
JAX call).

* images: the __graft_entry__ camera (32x16, spp 4, depth 4, tile 128) on
  the JAX cover scene carried over as numpy arrays, and 24x16, whose slabs
  on (4, 1) are 128 pixels each, so slab 3 starts at pixel 384, past the
  image (on (2, 1) slab 1 is half past it);
* gradients: tests/test_torch_grad.py's scene and camera at spp 4 (seed
  3), and the same at 24x16, by the backward kernels' plain versions
  ("step"), by torch.autograd through the plain render ("autograd_step"),
  and the keyed gradient on threefry key 3 ("keyed_step": JAX's
  `render_grads`, autograd through the plain keyed render on the CPU).

Pixel meshes must give one device's image bit for bit, sample meshes the
sample windows rendered on one device and averaged in rank order (and
within 1e-6 of one render, tests/test_pallas_dist.py:43); gradients within
rtol 2e-5, atol 1e-6 of one device's and the loss within 1e-6 relative
(tests/test_pallas_grad.py:171-181); the autograd gradients, PCG and
keyed, within rtol 1e-4, atol 1e-6 of one process's
(tests/test_dist.py:108-125).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tracing_in_one_weekend_tpu.models import scene as jax_scene
from ray_tracing_in_one_weekend_tpu.models.camera import make_camera as jax_make_camera
from ray_tracing_in_one_weekend_tpu.ops import pallas_grad as pg
from ray_tracing_in_one_weekend_tpu.ops import pallas_render as pr
from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.models.camera import camera_from_numpy
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
from ray_tracing_in_one_weekend_tpu_torch.ops import render as port_render
from ray_tracing_in_one_weekend_tpu_torch.parallel import dist, worker
from ray_tracing_in_one_weekend_tpu_torch.utils import checkpoint as ckpt
from ray_tracing_in_one_weekend_tpu_torch.utils import compare

torch.set_num_threads(2)

FIELDS = ("center", "radius", "albedo", "fuzz", "ior", "mat_type", "active")
CAM_FIELDS = ("center", "pixel00_loc", "pixel_delta_u", "pixel_delta_v", "defocus_disk_u",
              "defocus_disk_v", "defocus_angle")
GRAD_SEED = 3
BATCHES = (2, 2)
# (mesh, camera): the render and step cases; "24" is the 24x16 camera.
CASES = [((2, 1), "32"), ((1, 2), "32"), ((2, 2), "32"), ((4, 1), "32"), ((2, 1), "24"),
         ((4, 1), "24")]
IDS = [f"{p}x{s}-{w}" for (p, s), w in CASES]
ACCUMULATE = [(2, 1), (1, 2), (2, 2)]


def _carry_scene(js):
    return scene_lib.scene_from_numpy({f: np.asarray(getattr(js, f)) for f in FIELDS}, device="cpu")


def _carry_cam(jc):
    return camera_from_numpy({f: np.asarray(getattr(jc, f)) for f in CAM_FIELDS},
                             jc.image_width, jc.image_height, jc.samples_per_pixel, jc.max_depth,
                             device="cpu")


def _render_cam(width):
    """The __graft_entry__ camera at `width` x 16."""
    return jax_make_camera(image_width=width, aspect_ratio=width / 16, samples_per_pixel=4,
                           max_depth=4)


def _grad_cam(width):
    """tests/test_torch_grad.py's camera at `width` x 16, spp 4."""
    return jax_make_camera(
        image_width=width, aspect_ratio=width / 16, samples_per_pixel=4, max_depth=4,
        vfov_degrees=90.0, lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0),
        defocus_angle_degrees=0.0, focus_dist=1.0,
    )


def _grad_scene():
    return jax_scene.from_spheres(
        centers=[[0.0, -100.5, -1.0], [0.0, 0.0, -1.0], [-1.0, 0.0, -1.0], [1.0, 0.0, -1.0]],
        radii=[100.0, 0.5, 0.5, 0.5],
        mat_types=[0, 0, 2, 1],
        albedos=[[0.8, 0.8, 0.0], [0.1, 0.2, 0.5], [1.0, 1.0, 1.0], [0.8, 0.6, 0.2]],
        fuzzes=[0.0, 0.0, 0.0, 0.2],
        iors=[1.5, 1.5, 1.5, 1.5],
        pad_to=128,
    )


@pytest.fixture(scope="module")
def world():
    """The JAX and port scenes and cameras of every case."""
    cover, grad = jax_scene.cover_scene(0), _grad_scene()
    w = {"cover": (cover, _carry_scene(cover)), "grad": (grad, _carry_scene(grad))}
    for width in ("32", "24"):
        for kind, make in (("render", _render_cam), ("grad_cam", _grad_cam)):
            jc = make(int(width))
            w[kind, width] = (jc, _carry_cam(jc))
    return w


def _jobs(world, meshes, accumulate=()):
    cover, grad = world["cover"][1], world["grad"][1]
    jobs = []
    for mesh, width in meshes:
        cam, gcam = world["render", width][1], world["grad_cam", width][1]
        jobs.append({"job": "render", "mesh": mesh, "scene": worker.scene_spec(cover),
                     "camera": worker.camera_spec(cam), "repeat": 2})
        jobs.append({"job": "step", "mesh": mesh, "scene": worker.scene_spec(grad),
                     "camera": worker.camera_spec(gcam), "kw": {"seed": GRAD_SEED},
                     "repeat": 2 if mesh[0] * mesh[1] == 2 else 1})
        jobs.append({"job": "autograd_step", "mesh": mesh, "scene": worker.scene_spec(grad),
                     "camera": worker.camera_spec(gcam), "kw": {"seed": GRAD_SEED}})
        jobs.append({"job": "keyed_step", "mesh": mesh, "scene": worker.scene_spec(grad),
                     "camera": worker.camera_spec(gcam), "kw": {"base_key": GRAD_SEED}})
    for mesh in accumulate:
        jobs.append({"job": "accumulate", "mesh": mesh, "scene": worker.scene_spec(cover),
                     "camera": worker.camera_spec(world["render", "32"][1]), "batches": BATCHES})
    return jobs


@pytest.fixture(scope="module")
def sharded(world, tmp_path_factory):
    """{(job, mesh, width): every rank's result} from one launch of 2 ranks
    and one of 4."""
    out = {}
    for n_ranks in (2, 4):
        meshes = [c for c in CASES if c[0][0] * c[0][1] == n_ranks]
        acc = [m for m in ACCUMULATE if m[0] * m[1] == n_ranks]
        jobs = _jobs(world, meshes, acc)
        ranks = worker.launch(jobs, n_ranks, tmp_path_factory.mktemp(f"ranks{n_ranks}"), device="cpu",
                              timeout=120.0, threads=1)
        for i, job in enumerate(jobs):
            width = str(job["camera"]["image_width"])
            out[job["job"], tuple(job["mesh"]), width] = [r[i] for r in ranks]
    return out


def _composite(scene, cam, spp, n_smp, sample_offset=0):
    """The sample windows of an n_smp-way sample axis rendered on one device
    and averaged in rank order."""
    part = spp // n_smp
    wins = [cr.render_cuda(scene, cam, spp=part, sample_offset=sample_offset + s * part)
            for s in range(n_smp)]
    out = wins[0]
    for w in wins[1:]:
        out = out + w
    return out / n_smp


def _same_on_every_rank(values):
    return all(torch.equal(v, values[0]) for v in values[1:])


@pytest.mark.parametrize("mesh,width", CASES, ids=IDS)
def test_image_matches_one_device(sharded, world, mesh, width):
    """Pixel meshes: `render_cuda`'s image bit for bit; sample meshes: the
    rank-order composite bit for bit and within 1e-6 of one render. Every
    rank holds the whole image, the same bits."""
    scene, cam = world["cover"][1], world["render", width][1]
    ranks = sharded["render", mesh, width]
    images = [r["image"] for r in ranks]
    assert _same_on_every_rank(images)
    one = cr.render_cuda(scene, cam)
    if mesh[1] == 1:
        assert torch.equal(images[0], one)
    else:
        assert torch.equal(images[0], _composite(scene, cam, 4, mesh[1]))
        np.testing.assert_allclose(images[0].numpy(), one.numpy(), atol=1e-6)
    # The cost map, averaged over the sample axis, keeps each pixel's slot.
    assert ranks[0]["work"].shape == (cam.image_height, cam.image_width)
    assert float(ranks[0]["work"].min()) >= 1.0


@pytest.fixture(scope="module")
def jax_images(world):
    out = {}
    for width in ("32",):
        jc = world["render", width][0]
        out[width] = torch.from_numpy(np.array(pr.render_pallas(
            world["cover"][0], jc, seed=0, tile=128, interpret=True, warm=False, n_passes=1)))
    return out


@pytest.mark.parametrize("mesh", [c[0] for c in CASES if c[1] == "32"],
                         ids=[i for c, i in zip(CASES, IDS) if c[1] == "32"])
def test_image_matches_jax_kernel(sharded, jax_images, mesh):
    """Against the JAX package's single-device `render_pallas` in interpret
    mode, at tests/test_torch_render.py's bounds: pixels off by > 1e-3 under
    3% (measured 0.59% on one device), 8x8 block means within the mode
    check's thresholds."""
    img = sharded["render", mesh, "32"][0]["image"]
    agree = compare.images(img, jax_images["32"], block=8, atol=1e-3)
    assert agree.flipped_frac < 0.03, agree
    assert agree.blocks_agree, agree


@pytest.mark.parametrize("mesh,width", CASES, ids=IDS)
def test_gradients_match_one_device(sharded, world, mesh, width):
    """Sharded loss and gradients against `render_grads_cuda` on one device:
    loss within 1e-6 relative (bit for bit on pixel meshes, whose image is),
    gradients within rtol 2e-5, atol 1e-6. Every rank holds the same bits,
    and a second run gives them again."""
    scene, cam = world["grad"][1], world["grad_cam", width][1]
    target = torch.zeros(cam.image_height, cam.image_width, 3)
    loss, grads = cg.render_grads_cuda(cg.scene_params(scene), scene, cam, target, seed=GRAD_SEED)
    ranks = sharded["step", mesh, width]
    losses = [r["loss"] for r in ranks]
    assert _same_on_every_rank(losses)
    if mesh[1] == 1:
        assert torch.equal(losses[0], loss)
    assert abs(float(losses[0]) - float(loss)) <= 1e-6 * float(loss)
    for k in cg.DIFF_FIELDS:
        assert _same_on_every_rank([r["grads"][k] for r in ranks]), k
        np.testing.assert_allclose(ranks[0]["grads"][k].numpy(), grads[k].numpy(), rtol=2e-5,
                                   atol=1e-6, err_msg=k)
    assert all(all(r["same"]) for r in ranks)


@pytest.mark.parametrize("mesh,width", CASES, ids=IDS)
def test_autograd_gradients_match_one_process(sharded, world, mesh, width):
    """`dist.render_grads_pcg` (torch.autograd through the plain render) on the
    mesh against the same on one process (tests/test_dist.py:108-125):
    gradients within rtol 1e-4, atol 1e-6, the same bits on every rank,
    and the loss within 1e-6 relative (bit for bit on pixel meshes, whose
    image is one process's)."""
    scene, cam = world["grad"][1], world["grad_cam", width][1]
    target = torch.zeros(cam.image_height, cam.image_width, 3)
    loss, grads = dist.render_grads_pcg(cg.scene_params(scene), scene, cam, target, seed=GRAD_SEED)
    ranks = sharded["autograd_step", mesh, width]
    losses = [r["loss"] for r in ranks]
    assert _same_on_every_rank(losses)
    if mesh[1] == 1:
        assert torch.equal(losses[0], loss)
    assert abs(float(losses[0]) - float(loss)) <= 1e-6 * float(loss)
    for k in cg.DIFF_FIELDS:
        assert _same_on_every_rank([r["grads"][k] for r in ranks]), k
        np.testing.assert_allclose(ranks[0]["grads"][k].numpy(), grads[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert all(sum(r["launches"].values()) == 0 for r in ranks)


def _keyed_composite(scene, cam, spp, n_smp):
    """The keyed sample windows of an n_smp-way sample axis rendered in one
    process and averaged in rank order."""
    part = spp // n_smp
    pix = torch.arange(cam.num_pixels)
    wins = [port_render.render_keyed(scene, cam, pix, GRAD_SEED, part, s * part) for s in range(n_smp)]
    out = wins[0]
    for w in wins[1:]:
        out = out + w
    return (out / n_smp).reshape(cam.image_height, cam.image_width, 3)


@pytest.mark.parametrize("mesh,width", CASES, ids=IDS)
def test_keyed_step_matches_one_process(sharded, world, mesh, width):
    """The keyed `dist.render_grads` (threefry key 3; torch.autograd through
    the plain keyed render on the CPU) on the mesh against the same in one
    process. The step's image (`render_distributed(..., differentiable=True)`)
    is one process's bits on a pixel mesh, and on a sample mesh the windows'
    rank-order mean bit for bit, within 1e-6 of one render; the loss is one
    process's bits on a pixel mesh, within 1e-6 relative on a sample mesh;
    the gradients within rtol 1e-4, atol 1e-6 of one process's
    (tests/test_dist.py:108-125), the same bits on every rank. No kernel is
    launched."""
    scene, cam = world["grad"][1], world["grad_cam", width][1]
    target = torch.zeros(cam.image_height, cam.image_width, 3)
    loss, grads = dist.render_grads(cg.scene_params(scene), scene, cam, target, GRAD_SEED)
    ranks = sharded["keyed_step", mesh, width]
    images = [r["image"] for r in ranks]
    assert _same_on_every_rank(images)
    one = dist.render_distributed(scene, cam, GRAD_SEED)
    if mesh[1] == 1:
        assert torch.equal(images[0], one)
    else:
        assert torch.equal(images[0], _keyed_composite(scene, cam, cam.samples_per_pixel, mesh[1]))
        np.testing.assert_allclose(images[0].numpy(), one.numpy(), atol=1e-6)
    losses = [r["loss"] for r in ranks]
    assert _same_on_every_rank(losses)
    if mesh[1] == 1:
        assert torch.equal(losses[0], loss)
    assert abs(float(losses[0]) - float(loss)) <= 1e-6 * float(loss)
    for k in cg.DIFF_FIELDS:
        assert _same_on_every_rank([r["grads"][k] for r in ranks]), k
        np.testing.assert_allclose(ranks[0]["grads"][k].numpy(), grads[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert all(sum(r["launches"].values()) == 0 for r in ranks)


@pytest.fixture(scope="module")
def jax_grads(world):
    js, jc = world["grad"][0], world["grad_cam", "32"][0]
    target = jnp.zeros((jc.image_height, jc.image_width, 3), jnp.float32)
    loss, grads = pg.render_grads_pallas(
        {k: getattr(js, k) for k in pg.DIFF_FIELDS}, js, jc, target,
        seed=GRAD_SEED, tile=128, bwd_tile=128, interpret=True, n_passes=1,
    )
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("mesh", [c[0] for c in CASES if c[1] == "32"],
                         ids=[i for c, i in zip(CASES, IDS) if c[1] == "32"])
def test_gradients_match_jax_kernel(sharded, jax_grads, mesh):
    """Against the JAX package's single-device `render_grads_pallas` in
    interpret mode, at tests/test_torch_grad.py's bounds: per field relative
    L2 under 5e-3, the loss within 1e-5 relative."""
    loss_j, grads_j = jax_grads
    res = sharded["step", mesh, "32"][0]
    assert abs(float(res["loss"]) - loss_j) <= 1e-5 * loss_j
    for k in cg.DIFF_FIELDS:
        ours = res["grads"][k].numpy()
        rel = np.linalg.norm(ours - grads_j[k]) / np.linalg.norm(grads_j[k])
        assert rel < 5e-3, f"{k}: relative L2 {rel:.2e}"


@pytest.mark.parametrize("mesh", [c[0] for c in CASES if c[1] == "32"],
                         ids=[i for c, i in zip(CASES, IDS) if c[1] == "32"])
def test_warm_cache_hits_per_slab_with_the_same_image(sharded, mesh):
    """The first render fills each rank's cache with its slab's permutation;
    the second, of the same realization, hits it on every rank and gives
    the same image."""
    for r in sharded["render", mesh, "32"]:
        assert r["hits"] == [False, True]
        assert r["same"] == [True]


@pytest.mark.parametrize("mesh", ACCUMULATE, ids=[f"{p}x{s}" for p, s in ACCUMULATE])
def test_accumulate_on_a_mesh_matches_one_device(sharded, world, mesh):
    """`checkpoint.accumulate(mesh=...)` folds the sharded batch images:
    the same bits as one device folding `render_cuda`'s batches (pixel
    meshes) or the batches' rank-order composites (sample meshes)."""
    scene, cam = world["cover"][1], world["render", "32"][1]
    state = ckpt.new_state(cam, device="cpu")
    want = []
    for n in BATCHES:
        if mesh[1] == 1:
            state = ckpt.accumulate(state, scene, cam, 0, n)
        else:
            colors = _composite(scene, cam, n, mesh[1], sample_offset=state.spp_done)
            state = ckpt.RenderState(state.accum + colors * float(n), state.spp_done + n)
        want.append(state.accum)
    for r in sharded["accumulate", mesh, "32"]:
        assert r["spp_done"] == [2, 4]
        for got, exp in zip(r["accums"], want):
            assert torch.equal(got, exp)


def test_spp_must_divide_the_sample_axis():
    """The JAX package's error, from the share arithmetic every rank runs
    before it renders; a pixel mesh takes any spp."""
    with pytest.raises(ValueError, match="must divide evenly over the 'samples' mesh axis of size 2"):
        cr._rank_share(512, 128, 3, 0, dist.Mesh(1, 2, rank=1))
    assert cr._rank_share(512, 128, 3, 0, dist.Mesh(2, 1, rank=1)) == (256, 256, 3, 0)


def test_one_process_mesh_and_its_rules():
    """Without a process group the default mesh is one rank, (1, 1), whose
    collectives are the identity: the sharded render is `render_cuda`'s
    image bit for bit. A mesh of more ranks than the group has, or of
    another rank, raises."""
    mesh = dist.make_mesh()
    assert mesh.shape == {dist.PIXEL_AXIS: 1, dist.SAMPLE_AXIS: 1}
    assert (mesh.pixel_index, mesh.sample_index) == (0, 0)
    assert dist.make_mesh((1,)).samples == 1
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        dist.make_mesh((2,))
    with pytest.raises(ValueError, match=r"\(P,\) or \(P, S\)"):
        dist.make_mesh((1, 1, 1))
    sc = scene_lib.three_sphere_scene(pad_to=128, device="cpu")
    cam = _carry_cam(_grad_cam(32))
    img = cr.render_cuda_distributed(sc, cam, seed=1, warm=False)
    assert torch.equal(img, cr.render_cuda(sc, cam, seed=1, warm=False))
    assert dist.fetch_image(img).shape == (16, 32, 3)


def test_slab_layout_matches_jax():
    """The slab arithmetic of ops/pallas_render.py:1365: tile-aligned slabs
    of ceil(n / (P * tile)) * tile pixels, the last ones possibly past the
    image; rank s of a pixel group starts its window at offset + s spp / S.
    -> (first pixel, lanes, samples, first sample)."""
    assert cr._rank_share(384, 128, 4, 8, None) == (0, 384, 4, 8)
    assert cr._rank_share(384, 128, 4, 0, dist.Mesh(4, 1, rank=3)) == (384, 128, 4, 0)  # past the image
    assert cr._rank_share(512, 128, 4, 8, dist.Mesh(2, 2, rank=3)) == (256, 256, 2, 10)
    assert cr._rank_share(384, 128, 4, 0, dist.Mesh(2, 1, rank=1)) == (256, 256, 4, 0)  # half past it
