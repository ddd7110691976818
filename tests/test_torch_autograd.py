"""The port's differentiable render under torch.autograd (ops/integrator.py,
ops/render.py, parallel/dist.py) on the CPU.

The counterpart of the JAX package's jnp `differentiable=True` path, on the
port's own PCG streams. Its references here:

* (a) the value: `render_cuda`'s bits (the plain render on the CPU);
* (b) JAX's own jnp bounce (`hit_scene`, `scatter_sampled`, `sky_color`,
  looped as ray_tracing_in_one_weekend_tpu/ops/integrator.py:81-105 loops
  them) driven on the port's camera rays and PCG draws, under jax.grad;
* (c) the hand-written adjoint's plain backward (`render_grads_cuda`);
* (d) central finite differences with tests/test_grad.py's cases, eps and
  tolerances; (e) forward-mode against reverse-mode derivatives;
* (f) the 512-slot cover scene; (g) `train_step` and the example.

Scenes and cameras are tests/test_pallas_grad.py's (32x16, spp 2, depth 4,
seed 3) and tests/test_grad.py's (24x12, pad 8), built with the JAX package
and carried over as numpy arrays. The file makes no multi-device JAX call
and starts no process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

from ray_tracing_in_one_weekend_tpu.models import scene as jax_scene
from ray_tracing_in_one_weekend_tpu.models.camera import make_camera as jax_make_camera
from ray_tracing_in_one_weekend_tpu.ops.integrator import sky_color
from ray_tracing_in_one_weekend_tpu.ops.intersect import hit_scene
from ray_tracing_in_one_weekend_tpu.ops.materials import scatter_sampled
from ray_tracing_in_one_weekend_tpu_torch.examples import inverse_render
from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.models.camera import camera_from_numpy, make_camera
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
from ray_tracing_in_one_weekend_tpu_torch.ops import integrator, render
from ray_tracing_in_one_weekend_tpu_torch.parallel import dist

torch.set_num_threads(2)

FIELDS = ("center", "radius", "albedo", "fuzz", "ior", "mat_type", "active")
CAM_FIELDS = ("center", "pixel00_loc", "pixel_delta_u", "pixel_delta_v", "defocus_disk_u",
              "defocus_disk_v", "defocus_angle")
SEED = 3


def _jax_scene(pad_to=128):
    """tests/test_pallas_grad.py's scene (pad 128); tests/test_grad.py's at pad 8."""
    return jax_scene.from_spheres(
        centers=[[0.0, -100.5, -1.0], [0.0, 0.0, -1.0], [-1.0, 0.0, -1.0], [1.0, 0.0, -1.0]],
        radii=[100.0, 0.5, 0.5, 0.5],
        mat_types=[0, 0, 2, 1],
        albedos=[[0.8, 0.8, 0.0], [0.1, 0.2, 0.5], [1.0, 1.0, 1.0], [0.8, 0.6, 0.2]],
        fuzzes=[0.0, 0.0, 0.0, 0.2],
        iors=[1.5, 1.5, 1.5, 1.5],
        pad_to=pad_to,
    )


def _jax_cam(width=32, spp=2, depth=4):
    return jax_make_camera(
        image_width=width, aspect_ratio=2.0, samples_per_pixel=spp, max_depth=depth,
        vfov_degrees=90.0, lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0),
        defocus_angle_degrees=0.0, focus_dist=1.0,
    )


def _carry_scene(js):
    return scene_lib.scene_from_numpy({f: np.asarray(getattr(js, f)) for f in FIELDS}, device="cpu")


def _carry_cam(jc):
    return camera_from_numpy({f: np.asarray(getattr(jc, f)) for f in CAM_FIELDS},
                             jc.image_width, jc.image_height, jc.samples_per_pixel, jc.max_depth,
                             device="cpu")


def _zero_target(cam):
    return torch.zeros(cam.image_height, cam.image_width, 3)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def grad_world():
    js, jc = _jax_scene(), _jax_cam()
    return js, jc, _carry_scene(js), _carry_cam(jc)


@pytest.fixture(scope="module")
def cover():
    """The port's 512-slot cover scene and tests/test_grad.py's cover camera
    (the default lens: defocus on), 32x16, spp 1, depth 6."""
    return (scene_lib.cover_scene(0, device="cpu"),
            make_camera(image_width=32, aspect_ratio=2.0, samples_per_pixel=1, max_depth=6,
                        device="cpu"))


# ---------------------------------------------------------------------------
# (a) the value.
# ---------------------------------------------------------------------------


def test_value_bit_identical_to_render_cuda(grad_world):
    _, _, sc, cam = grad_world
    img = render.render(sc, cam, seed=SEED, differentiable=True)
    assert img.requires_grad is False  # no scene leaf requires grad: nothing recorded
    assert torch.equal(img, cr.render_cuda(sc, cam, seed=SEED))


@pytest.mark.parametrize("chunk_size", [64, 512])
def test_cover_value_bit_identical_for_any_chunk(cover, chunk_size):
    sc, cam = cover
    img = render.render(sc, cam, seed=SEED, chunk_size=chunk_size, differentiable=True)
    assert torch.equal(img, cr.render_cuda(sc, cam, seed=SEED))


def test_pixel_subset_and_sample_window_bit_identical(cover):
    """Pixels drawn across the image in any order, samples [2, 4) of a
    4-spp camera: `render_cuda`'s window at those pixels."""
    sc, _ = cover
    cam = make_camera(image_width=32, aspect_ratio=2.0, samples_per_pixel=4, max_depth=6,
                      device="cpu")
    pix = torch.from_numpy(np.random.default_rng(0).choice(cam.num_pixels, 100, replace=False))
    want = cr.render_cuda(sc, cam, seed=SEED, spp=2, sample_offset=2).reshape(-1, 3)[pix]
    got = render.render_pixels(sc, cam, pix, seed=SEED, spp=2, sample_offset=2)
    assert torch.equal(got, want)
    flat = render.render_flat(sc, cam, pix, seed=SEED, chunk_size=7, spp=2, sample_offset=2)
    assert torch.equal(flat, want)


def test_not_differentiable_records_nothing(grad_world):
    """`differentiable=False` runs under no_grad even with scene leaves that
    require grad; True records the bounces, and the value is the same."""
    _, _, sc, cam = grad_world
    leaves = {k: v.clone().requires_grad_() for k, v in cg.scene_params(sc).items()}
    leafy = cg.scene_with_params(sc, leaves)
    off = render.render(leafy, cam, seed=SEED)
    on = render.render(leafy, cam, seed=SEED, differentiable=True)
    assert off.grad_fn is None and on.grad_fn is not None
    assert torch.equal(off, on.detach())


# ---------------------------------------------------------------------------
# (b) against JAX's jnp bounce on the port's rays and draws.
# ---------------------------------------------------------------------------


def _port_rays(sc, cam, seed):
    """Every (pixel, sample) ray of the image, sample-major, with its draws:
    (o, d [L, 3], unit samples [depth, L, 3], reflect uniforms [depth, L])
    as numpy, the draws of bounce k at counter 8 + 16k."""
    cam_vec = cr.pack_camera(cam)
    camc = cr._unpack_cam(cam_vec)
    n, spp = cam.num_pixels, cam.samples_per_pixel
    px, py, h0 = cg._lanes(camc, seed, torch.arange(n).repeat(spp)[None])
    o, d, lo, hi = cr._camera_ray_block(camc, h0, px, py, torch.arange(spp).repeat_interleave(n)[None])
    us = torch.stack([cr._unit_vectors((lo, hi), 8 + 16 * k).T for k in range(cam.max_depth)])
    ru = torch.stack([cr._u01((lo, hi), 8 + 16 * k + 4)[0] for k in range(cam.max_depth)])
    return o.T.contiguous().numpy(), d.T.numpy(), us.numpy(), ru.numpy()


def _jax_image(js, jc, rays, params):
    """The image of JAX's jnp bounce loop (integrator.py:81-105) on `rays`."""
    o, d, us, ru = (jnp.asarray(x) for x in rays)
    sc = js.replace(**params)
    rad = jnp.zeros_like(o)
    att = jnp.ones_like(o)
    live = jnp.ones(o.shape[0], bool)
    for i in range(jc.max_depth):
        rec = hit_scene(sc, o, d)
        miss = live & ~rec.hit
        rad = rad + jnp.where(miss[:, None], att * sky_color(d), 0.0)
        new_dir, mat_atten, ok = scatter_sampled(rec, d, us[i], ru[i])
        cont = live & rec.hit & ok
        att = jnp.where(cont[:, None], att * mat_atten, att)
        o = jnp.where(cont[:, None], rec.point, o)
        d = jnp.where(cont[:, None], new_dir, d)
        live = cont
    return rad.reshape(jc.samples_per_pixel, jc.image_height, jc.image_width, 3).mean(0)


@pytest.fixture(scope="module")
def jnp_bounce(grad_world):
    js, jc, sc, cam = grad_world
    rays = _port_rays(sc, cam, SEED)
    params = {k: getattr(js, k) for k in cg.DIFF_FIELDS}

    def loss(p):
        return jnp.mean(_jax_image(js, jc, rays, p) ** 2)

    img = np.asarray(jax.jit(lambda p: _jax_image(js, jc, rays, p))(params))
    lj, gj = jax.jit(jax.value_and_grad(loss))(params)
    return img, float(lj), {k: np.asarray(v) for k, v in gj.items()}


@pytest.fixture(scope="module")
def autograd_grads(grad_world):
    _, _, sc, cam = grad_world
    return dist.render_grads_pcg(cg.scene_params(sc), sc, cam, _zero_target(cam), seed=SEED)


def test_image_matches_jax_jnp_bounce(grad_world, jnp_bounce):
    """Within 1e-5 absolute; measured 6.6e-7 (sin, cos and rsqrt differ in
    the last ulp between the frameworks, and JAX's dielectric floors
    sin_theta at 1e-6)."""
    _, _, sc, cam = grad_world
    img = render.render(sc, cam, seed=SEED, differentiable=True)
    np.testing.assert_allclose(img.numpy(), jnp_bounce[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("field", cg.DIFF_FIELDS)
def test_gradients_match_jax_jnp_bounce(autograd_grads, jnp_bounce, field):
    """jax.grad of the same loss through JAX's jnp bounce on the same rays
    and draws, per field relative L2 under 5e-4, the loss within 1e-5
    relative. Measured: center 3.0e-5, radius 8.0e-5, albedo 3.1e-7, fuzz
    7.0e-6, ior 7.3e-7; the loss 1.9e-7."""
    loss, grads = autograd_grads
    _, loss_j, grads_j = jnp_bounce
    assert abs(float(loss) - loss_j) <= 1e-5 * loss_j
    rel = _rel_l2(grads[field].numpy(), grads_j[field])
    assert rel < 5e-4, f"{field}: relative L2 {rel:.2e}"


# ---------------------------------------------------------------------------
# (c) against the hand-written adjoint's plain backward.
# ---------------------------------------------------------------------------


def test_gradients_match_hand_adjoint(grad_world, autograd_grads):
    """`render_grads_cuda` on the CPU (the replay and `_bounce_vjp` of the
    same bounce functions, ±1e6 clip): the loss equal, each field within
    1e-5 relative L2. Measured: the loss's bits; at most 3.2e-7 (center)."""
    _, _, sc, cam = grad_world
    loss, grads = autograd_grads
    loss_k, grads_k = cg.render_grads_cuda(cg.scene_params(sc), sc, cam, _zero_target(cam), seed=SEED)
    assert abs(float(loss) - float(loss_k)) <= 1e-6 * float(loss_k)
    for k in cg.DIFF_FIELDS:
        rel = _rel_l2(grads[k].numpy(), grads_k[k].numpy())
        assert rel <= 1e-5, f"{k}: relative L2 {rel:.2e}"


def test_chunking_and_a_one_rank_mesh_change_no_gradient(grad_world, autograd_grads):
    """Chunks of 16 pixels sum the cotangent in another order (within
    float32 rounding), and the first ones, in the top row, see only the
    sky: their radiance does not depend on the scene. A one-process mesh
    is mesh=None bit for bit."""
    _, _, sc, cam = grad_world
    loss, grads = autograd_grads
    loss_c, grads_c = dist.render_grads_pcg(cg.scene_params(sc), sc, cam, _zero_target(cam), seed=SEED,
                                        chunk_size=16)
    assert torch.equal(loss_c, loss)
    for k in cg.DIFF_FIELDS:
        np.testing.assert_allclose(grads_c[k].numpy(), grads[k].numpy(), rtol=1e-5, atol=1e-8)
    loss_m, grads_m = dist.render_grads_pcg(cg.scene_params(sc), sc, cam, _zero_target(cam), seed=SEED,
                                        mesh=dist.make_mesh())
    assert torch.equal(loss_m, loss)
    assert all(torch.equal(grads_m[k], grads[k]) for k in cg.DIFF_FIELDS)


# ---------------------------------------------------------------------------
# (d) finite differences, (e) forward against reverse mode.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fd_world():
    """tests/test_grad.py's scene (pad 8) and camera (24x12, spp 2, depth 4);
    f(p) = the image's mean, as there, and the image itself.

    The seed is the PCG streams' of tests/test_pallas_grad.py (3), not
    test_grad.py's threefry key 11: its cases were chosen so that no
    perturbation flips a discrete decision on ITS sample paths. Under the
    port's seed 11, ±eps moves one or two pixels across a silhouette (pixel
    (7, 8) or (11, 4) jumps by ~1 for the center and radius cases), where
    the true derivative has a Dirac part that neither autodiff nor FD of a
    fixed sample set can see. The test checks that premise itself."""
    sc, cam = _carry_scene(_jax_scene(pad_to=8)), _carry_cam(_jax_cam(width=24))
    params = cg.scene_params(sc)

    def f(p, differentiable=False):
        return render.render(cg.scene_with_params(sc, p), cam, seed=SEED, chunk_size=512,
                             differentiable=differentiable)

    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    grads = dict(zip(leaves, torch.autograd.grad(f(leaves, True).mean(), list(leaves.values()))))
    return params, grads, f


# tests/test_grad.py:86-107: field, index, eps, atol and rtol per case.
FD_CASES = (
    [("albedo", i, 1e-3, 1e-5, 0.02) for i in [(0, 0), (0, 1), (1, 2), (3, 0)]]
    + [("center", i, 3e-4, 2e-4, 0.2) for i in [(1, 0), (1, 1), (1, 2)]]
    + [("radius", i, 3e-4, 2e-4, 0.2) for i in [(1,), (0,)]]
    + [("fuzz", (3,), 1e-3, 1e-4, 0.1), ("ior", (2,), 1e-3, 1e-4, 0.1)]
)


@pytest.mark.parametrize("field,idx,eps,atol,rtol", FD_CASES,
                         ids=[f"{c[0]}{list(c[1])}" for c in FD_CASES])
def test_gradients_match_finite_differences(fd_world, field, idx, eps, atol, rtol):
    params, grads, f = fd_world
    assert bool(torch.isfinite(grads[field]).all())
    xp, xm = params[field].clone(), params[field].clone()
    xp[idx] += eps
    xm[idx] -= eps
    img_p, img_m = f({**params, field: xp}), f({**params, field: xm})
    # The premise: no pixel crosses a discontinuity (a flipped decision
    # moves a pixel by a sizeable fraction of its value).
    assert float((img_p - img_m).abs().max()) < 0.05, "a decision flipped: FD is not a derivative here"
    fd = (float(img_p.mean()) - float(img_m.mean())) / (2 * eps)
    ad = float(grads[field][idx])
    assert np.isclose(ad, fd, atol=atol, rtol=rtol), f"{field}[{idx}]: autograd {ad:.6f} vs FD {fd:.6f}"


def test_jvp_vjp_consistency(fd_world):
    """Forward-mode (torch.autograd.forward_ad) and reverse-mode derivatives
    of the image's mean agree in a random direction (tests/test_grad.py:
    118-145: rtol 1e-3, atol 1e-6)."""
    params, grads, f = fd_world
    rng = np.random.default_rng(0)
    tangent = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
               for k, v in params.items()}
    with forward_ad.dual_level():
        duals = {k: forward_ad.make_dual(v, tangent[k]) for k, v in params.items()}
        jvp = float(forward_ad.unpack_dual(f(duals, True).mean()).tangent)
    vjp = sum(float((grads[k] * tangent[k]).sum()) for k in params)
    assert np.isclose(jvp, vjp, rtol=1e-3, atol=1e-6), f"jvp {jvp:.8f} vs vjp {vjp:.8f}"


# ---------------------------------------------------------------------------
# (f) the cover scene, (g) the train step and the example.
# ---------------------------------------------------------------------------


def test_gradients_finite_and_nonzero_on_cover_scene(cover):
    sc, cam = cover
    target = torch.full((cam.image_height, cam.image_width, 3), 0.5)
    _, grads = dist.render_grads_pcg(cg.scene_params(sc), sc, cam, target, seed=SEED, chunk_size=256)
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), f"non-finite gradient of {k}"
    assert sum(float(g.abs().sum()) for g in grads.values()) > 0.0


def test_train_step_lowers_the_loss(grad_world):
    """Albedo of the damaged sphere 1 back toward the target's (the other
    fields unchanged): the loss falls in three steps."""
    _, _, sc, cam = grad_world
    target = cr.render_cuda(sc, cam, seed=SEED)
    params = cg.scene_params(sc)
    damaged = params["albedo"].clone()
    damaged[1] = torch.tensor([0.6, 0.6, 0.6])
    params = {"albedo": damaged}
    losses = []
    for _ in range(3):
        loss, params = dist.train_step_pcg(params, sc, cam, target, seed=SEED, lr=5.0)
        losses.append(float(loss))
    assert losses[2] < losses[1] < losses[0], losses
    assert float((params["albedo"][1] - damaged[1]).abs().sum()) > 0.0


def test_inverse_render_autograd_recovers_the_albedo(tmp_path):
    """`inverse_render --grad autograd --device cpu` in this process, at
    width 32 and 6 steps: it exits 0 (sphere 1's albedo error at least
    halved) and writes both images."""
    rc = inverse_render.main(["--device", "cpu", "--backend", "pallas", "--grad", "autograd", "--width", "32",
                              "--steps", "6", "--outdir", str(tmp_path)])
    assert rc == 0
    for name in ("target", "recovered"):
        assert (tmp_path / f"inverse_{name}.ppm").read_bytes().startswith(b"P3\n32 16\n255\n")


def test_trace_rays_reaches_the_rays_and_the_scene():
    """A block of rays aimed at a sphere: gradients reach the packed scene
    and the rays' origins under `differentiable=True`, none under False."""
    sc = scene_lib.single_sphere_scene(device="cpu")
    p_mat = cr.pack_scene(sc).requires_grad_()
    o = torch.zeros(3, 8, requires_grad=True)
    d = cr._normalize3(torch.tensor([[0.01 * i for i in range(8)], [0.0] * 8, [-1.0] * 8]))
    stream = (torch.arange(8)[None], torch.arange(8, 16)[None])
    rad = integrator.trace_rays(p_mat, o, d, stream, cr.T_MIN_EPS, 4, differentiable=True)
    gp, go = torch.autograd.grad(rad.sum(), [p_mat, o])
    assert bool(torch.isfinite(gp).all()) and float(gp.abs().sum()) > 0.0
    assert bool(torch.isfinite(go).all())
    assert integrator.trace_rays(p_mat, o, d, stream, cr.T_MIN_EPS, 4).grad_fn is None
