"""The keyed gradient (`parallel.dist.render_loss`/`render_grads`/`train_step`
on threefry keys) against the JAX package's on the CPU.

JAX's `render_grads` and `train_step` (parallel/dist.py:225-282) differentiate
the jnp render on a `base_key`; the port's take the same signature and, on a
CPU scene, differentiate `render_flat_threefry` by torch.autograd, one chunk
at a time (`_DiffRenderKeyed`). The JAX side runs on a one-device mesh
(`make_mesh((1, 1))`): this file makes no multi-device JAX call.

Small sizes: the __graft_entry__ camera at 16x8 (spp 2, depth 4), the
size at which tests/test_torch_jnp_render.py measured the keyed trace's
gradient against jax.grad (`GRAD_BOUNDS`, per field, just above that
distance), on `three_sphere_scene(pad_to=128)` and `cover_scene(0)`, with
a fixed random target from numpy.

Also here: the keyed backward kernels' plain versions
(`ops/cuda_threefry.replay_records_plain`, `reverse_records_plain`)
against `render_grads_autograd`, the inverse-render example's default
branch, and `ray_color` against JAX's on the keyed rays. The kernels
themselves are tested on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The jnp path's module-scoped JAX fixtures and helpers.
from test_torch_jnp_render import FLIP_MAX, GRAD_BOUNDS, _carry_cam, _lanes, _t, cams, rays, scenes  # noqa: F401

from ray_tracing_in_one_weekend_tpu.models import camera as jax_camera
from ray_tracing_in_one_weekend_tpu.models import scene as jax_scene
from ray_tracing_in_one_weekend_tpu.ops import integrator as jax_integrator
from ray_tracing_in_one_weekend_tpu.parallel import dist as jax_dist
from ray_tracing_in_one_weekend_tpu_torch.examples import inverse_render
from ray_tracing_in_one_weekend_tpu_torch.kernels import build
from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_threefry as ct
from ray_tracing_in_one_weekend_tpu_torch.ops import render as port_render
from ray_tracing_in_one_weekend_tpu_torch.ops.integrator import ray_color, trace_rays_threefry
from ray_tracing_in_one_weekend_tpu_torch.parallel import dist

torch.set_num_threads(2)

GRAD_CAM = dict(image_width=16, aspect_ratio=2.0, samples_per_pixel=2, max_depth=4)
FIELDS = ("center", "radius", "albedo", "fuzz", "ior")
SCENE_FIELDS = ("center", "radius", "albedo", "fuzz", "ior", "mat_type", "active")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def jax_camera_to_port(**kw):
    """The __graft_entry__ camera (aspect 2) built by JAX and carried over."""
    return _carry_cam(jax_camera.make_camera(aspect_ratio=2.0, **kw))


def _port_scene(js):
    return scene_lib.scene_from_numpy({f: np.asarray(getattr(js, f)) for f in SCENE_FIELDS}, device="cpu")


@pytest.fixture(scope="module")
def worlds():
    """{name: (JAX scene, port scene)} and the camera of both packages."""
    out = {}
    for name, js in (("three", jax_scene.three_sphere_scene(pad_to=128)), ("cover0", jax_scene.cover_scene(0))):
        out[name] = (js, _port_scene(js))
    jc = jax_camera.make_camera(**GRAD_CAM)
    target = np.random.default_rng(0).random((jc.image_height, jc.image_width, 3)).astype(np.float32)
    return out, (jc, _carry_cam(jc)), target


@pytest.fixture(scope="module")
def jax_grads(worlds):
    """JAX's `render_grads` on a one-device mesh, key 0, for each scene."""
    scenes_, (jc, _), target = worlds
    mesh = jax_dist.make_mesh((1, 1))
    out = {}
    for name, (js, _) in scenes_.items():
        loss, grads = jax_dist.render_grads(jax_dist.scene_params(js), js, jc, jnp.asarray(target),
                                            jax.random.key(0), mesh, chunk_size=64)
        out[name] = (float(loss), {k: np.asarray(v) for k, v in grads.items()})
    return out


@pytest.fixture(scope="module")
def port_grads(worlds):
    scenes_, (_, tc), target = worlds
    return {name: dist.render_grads(dist.scene_params(ts), ts, tc, torch.from_numpy(target), 0)
            for name, (_, ts) in scenes_.items()}


def _weighted_grads_jax(js, jc, w):
    """jax.grad of sum(render_distributed(..., differentiable=True) * w) on a
    one-device mesh: the loss GRAD_BOUNDS were measured on."""
    mesh = jax_dist.make_mesh((1, 1))

    def loss(params):
        img = jax_dist.render_distributed(js.replace(**params), jc, jax.random.key(0), mesh, 64,
                                          differentiable=True)
        return jnp.sum(img * w)

    return jax.jit(jax.grad(loss))(jax_dist.scene_params(js))


# The squared error's gradient on cover_scene(0) (GRAD_CAM, random target),
# port against JAX's jit, was measured at center 2.4e-4, radius 3.6e-4,
# albedo 6.8e-7, fuzz 1.6e-4, ior 3.1e-4: radius and albedo above
# GRAD_BOUNDS, which were measured for sum(image * w). JAX's own jit
# against op by op (jax.disable_jit) differs there by 1.2e-3, 2.1e-3,
# 5.4e-6, 3.5e-4 and 5.5e-4. The bounds of that check are GRAD_BOUNDS with
# radius and albedo set from the port's readings.
COVER0_SQUARED_ERROR_BOUNDS = dict(GRAD_BOUNDS, radius=5e-4, albedo=1e-6)


def _check_grads(grads, grads_j, bounds):
    for k in FIELDS:
        assert np.isfinite(grads[k].numpy()).all(), k
        err = _rel(grads[k].numpy(), grads_j[k])
        assert err <= bounds[k], (k, err, bounds[k])


@pytest.mark.parametrize("name", ["three", "cover0"])
def test_render_grads_matches_jax(worlds, jax_grads, port_grads, name):
    """Keyed `render_grads` on a CPU scene against JAX's `render_grads` on a
    one-device mesh (random target): the loss within 1e-5 relative, each
    field of the gradient within GRAD_BOUNDS on three spheres (measured:
    4.4e-6 on ior and below) and within COVER0_SQUARED_ERROR_BOUNDS on
    cover_scene(0) (see there). On cover_scene(0) also the gradient of the
    render under `render_loss` (`render_distributed(..., differentiable=True)`)
    for the loss GRAD_BOUNDS were measured on, sum(image * w) with
    tests/test_torch_jnp_render.py's weights, against JAX's on the same
    mesh, within GRAD_BOUNDS (measured: center 2.0e-4, radius 1.8e-4,
    albedo 1.8e-7, fuzz 4.5e-4, ior 4.0e-4). No kernel is launched."""
    scenes_, (jc, tc), _ = worlds
    js, ts = scenes_[name]
    loss_j, grads_j = jax_grads[name]
    loss, grads = port_grads[name]
    assert abs(float(loss) - loss_j) <= 1e-5 * abs(loss_j)
    _check_grads(grads, grads_j, COVER0_SQUARED_ERROR_BOUNDS if name == "cover0" else GRAD_BOUNDS)
    if name == "cover0":
        w = np.random.default_rng(0).random((jc.image_height, jc.image_width, 3)).astype(np.float32)
        grads_j = {k: np.asarray(v) for k, v in _weighted_grads_jax(js, jc, w).items()}
        leaves = {k: v.clone().requires_grad_() for k, v in dist.scene_params(ts).items()}
        img = dist.render_distributed(ts.replace(**leaves), tc, 0, differentiable=True)
        grads = dict(zip(leaves, torch.autograd.grad((img * torch.from_numpy(w)).sum(), list(leaves.values()))))
        _check_grads(grads, grads_j, GRAD_BOUNDS)
    assert sum(build.LAUNCHES.values()) == 0


def test_train_step_matches_jax(worlds):
    """One SGD step of the keyed `train_step` against JAX's (lr 1e-2):
    the loss within 1e-5 relative, each new field within 1e-6 relative L2
    of JAX's (the step moves each field by lr x its gradient, whose gate
    is GRAD_BOUNDS), and the fields that take no gradient unchanged."""
    scenes_, (jc, tc), target = worlds
    js, ts = scenes_["cover0"]
    loss_j, params_j = jax_dist.train_step(jax_dist.scene_params(js), js, jc, jnp.asarray(target),
                                           jax.random.key(0), jax_dist.make_mesh((1, 1)), chunk_size=64)
    params = dist.scene_params(ts)
    loss, new = dist.train_step(params, ts, tc, torch.from_numpy(target), 0)
    assert abs(float(loss) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    for k in FIELDS:
        assert _rel(new[k].numpy(), np.asarray(params_j[k])) <= 1e-6, k
        assert not new[k].requires_grad
    moved = {k: float((new[k] - params[k]).abs().max()) for k in FIELDS}
    assert moved["albedo"] > 0.0 and moved["center"] > 0.0, moved


def test_differentiable_render_is_the_same_bits_for_any_chunk(worlds, port_grads):
    """`render_distributed(differentiable=True)` is the bits of
    `differentiable=False` (and of `render_image`), with a gradient; the
    loss is the same bits for any chunk size, and the gradients, whose
    chunks add in another order, within rtol 1e-5 (atol 1e-8) of the
    default chunk's. A one-process mesh is mesh=None bit for bit."""
    scenes_, (_, tc), target = worlds
    _, ts = scenes_["cover0"]
    leaves = {k: v.clone().requires_grad_() for k, v in dist.scene_params(ts).items()}
    img = dist.render_distributed(ts.replace(**leaves), tc, 0, differentiable=True)
    assert img.grad_fn is not None
    assert torch.equal(img.detach(), dist.render_distributed(ts, tc, 0))
    assert torch.equal(img.detach(), port_render.render_image(ts, tc, 0))
    loss, grads = port_grads["cover0"]
    for chunk in (7, 40):
        loss_c, grads_c = dist.render_grads(dist.scene_params(ts), ts, tc, torch.from_numpy(target), 0,
                                            chunk_size=chunk)
        assert torch.equal(loss_c, loss)
        for k in FIELDS:
            np.testing.assert_allclose(grads_c[k].numpy(), grads[k].numpy(), rtol=1e-5, atol=1e-8, err_msg=k)
    loss_m, grads_m = dist.render_grads(dist.scene_params(ts), ts, tc, torch.from_numpy(target), 0,
                                        dist.make_mesh())
    assert torch.equal(loss_m, loss)
    assert all(torch.equal(grads_m[k], grads[k]) for k in FIELDS)
    loss_a, grads_a = dist.render_grads_autograd(dist.scene_params(ts), ts, tc, torch.from_numpy(target), 0)
    assert torch.equal(loss_a, loss)
    assert all(torch.equal(grads_a[k], grads[k]) for k in FIELDS)


@pytest.mark.parametrize("name", ["three", "cover0"])
def test_plain_replay_and_reverse_match_autograd(name):
    """The keyed backward kernels' plain versions at 32x16, spp 2, depth 8:
    `replay_records_plain` counts each pixel's sweeps as the forward's work
    map does, and `reverse_records_plain`'s events, reduced in the kernel's
    order and taken through `pack_scene`, give `render_grads_autograd`'s
    gradient within 1e-5 relative L2 per field. Measured: three spheres
    center 3.1e-7, radius 1.9e-7, albedo 7.0e-7, fuzz 2.7e-6, ior 2.1e-7;
    cover_scene(0) 6.1e-7, 2.1e-7, 7.5e-7, 9.1e-8, 4.7e-7."""
    sc = (scene_lib.three_sphere_scene(pad_to=128, device="cpu") if name == "three"
          else scene_lib.cover_scene(0, device="cpu"))
    cam = jax_camera_to_port(image_width=32, samples_per_pixel=2, max_depth=8)
    target = torch.from_numpy(np.random.default_rng(1).random((cam.image_height, cam.image_width, 3),
                                                              dtype=np.float32))
    _, want = dist.render_grads_autograd(dist.scene_params(sc), sc, cam, target, 0)
    img, work = port_render.render_flat_threefry(sc, cam, torch.arange(cam.num_pixels), 0, return_work=True)
    g_img = 2.0 * (img - target.reshape(-1, 3)) / img.numel()
    g = (g_img.T / cam.samples_per_pixel).contiguous()
    pix = torch.arange(cam.num_pixels)
    replay = ct.replay_records_plain(sc, cam, pix, 0)
    assert torch.equal(replay.ev_count, work.to(torch.int32))
    assert replay.records.shape[0] == int(work.sum())
    p_mat = cr.pack_scene(sc)
    events = ct.reverse_records_plain(p_mat, cr.pack_camera(cam), replay, g)
    got = cg.params_vjp(sc, cg._reduce_events_ordered(events, sc.num_slots))
    for k in FIELDS:
        assert _rel(got[k].numpy(), want[k].numpy()) <= 1e-5, k


def test_records_follow_pixel_ids_in_any_order():
    """The plain replay's slots follow the pixel ids, so a permuted subset
    of pixels gives the same records, and events, in the same slots."""
    sc = scene_lib.cover_scene(0, device="cpu")
    cam = jax_camera_to_port(image_width=16, samples_per_pixel=2, max_depth=6)
    pix = torch.arange(10, 90, 3)
    perm = pix[torch.randperm(pix.numel(), generator=torch.Generator().manual_seed(0))]
    a = ct.replay_records_plain(sc, cam, pix, 5, pixel_offset=0, n_live=cam.num_pixels)
    b = ct.replay_records_plain(sc, cam, perm, 5, pixel_offset=0, n_live=cam.num_pixels)
    assert torch.equal(a.records.view(torch.int32), b.records.view(torch.int32))
    g = torch.from_numpy(np.random.default_rng(2).standard_normal((3, pix.numel()), dtype=np.float32))
    where = {int(p): i for i, p in enumerate(pix)}
    gp = g[:, torch.tensor([where[int(p)] for p in perm])]  # each pixel keeps its cotangent
    p_mat, cam_vec = cr.pack_scene(sc), cr.pack_camera(cam)
    ea = ct.reverse_records_plain(p_mat, cam_vec, a, g)
    eb = ct.reverse_records_plain(p_mat, cam_vec, b, gp)
    assert torch.equal(ea.view(torch.int32), eb.view(torch.int32))


def test_inverse_render_default_branch_recovers_the_albedo(tmp_path, capsys):
    """`inverse_render --device cpu` with the JAX example's default,
    `--backend jnp` (threefry key 0, render_image_distributed and
    dist.render_grads at chunks of 2048), in this process at width 32 and
    6 steps: it exits 0 (sphere 1's albedo error at least halved) and
    writes both images."""
    rc = inverse_render.main(["--device", "cpu", "--width", "32", "--steps", "6", "--outdir", str(tmp_path)])
    err = capsys.readouterr().err
    assert rc == 0, err
    for name in ("target", "recovered"):
        assert (tmp_path / f"inverse_{name}.ppm").read_bytes().startswith(b"P3\n32 16\n255\n")
    assert sum(build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("name", ["cover0", "reference"])
def test_ray_color_matches_jax(scenes, rays, name):
    """`ray_color` (the alias of `trace_rays_threefry`, default depth 50)
    against JAX's `ray_color` on the keyed camera rays of every pixel at
    32x16, under the gate of test_trace_rays_threefry_matches_jax: rays more
    than 1e-3 apart in any channel under 3%, mean radiance within 1e-3; and
    the port's alias gives the trace's bits."""
    js, ts = scenes[name]
    theirs = np.asarray(jax.jit(lambda o, d, k: jax_integrator.ray_color(js, o, d, k))(
        rays["o"], rays["d"], rays["trace_keys"]))
    o, d, k = _t(rays["o"]), _t(rays["d"]), _lanes(rays["trace_keys"])
    ours = ray_color(ts, o, d, k)
    assert torch.equal(ours, trace_rays_threefry(ts, o, d, k, 50))
    ours = ours.numpy()
    assert ours.shape == theirs.shape
    flipped = np.mean(np.abs(ours - theirs).max(axis=1) > 1e-3)
    assert flipped < FLIP_MAX, flipped
    assert abs(ours.mean() - theirs.mean()) < 1e-3
