"""The port's gradient path (plain PyTorch on the CPU) against the JAX one.

The scene and camera are tests/test_pallas_grad.py's: lambertian ground and
lambertian, dielectric and metal spheres, 32x16, spp 2, depth 4, seed 3,
built with the JAX package and carried over as numpy arrays. The JAX side
runs `render_grads_pallas` / `train_step_pallas` single-device in interpret
mode, once per module.

Why the port's gradients are not bit-equal to JAX's: the two frameworks'
sin, cos and rsqrt differ in the last ulp, which moves a few paths (a bounce
off a small sphere amplifies it), and the [16, N] sums are taken in another
order. The bounds below state the measured values and keep a margin.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tracing_in_one_weekend_tpu.models import scene as jax_scene
from ray_tracing_in_one_weekend_tpu.models.camera import make_camera as jax_make_camera
from ray_tracing_in_one_weekend_tpu.ops import pallas_grad as pg
from ray_tracing_in_one_weekend_tpu.ops import pallas_render as pr
from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.models.camera import camera_from_numpy, make_camera
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("center", "radius", "albedo", "fuzz", "ior", "mat_type", "active")
CAM_FIELDS = ("center", "pixel00_loc", "pixel_delta_u", "pixel_delta_v", "defocus_disk_u",
              "defocus_disk_v", "defocus_angle")
SEED = 3


def _jax_cam(spp=2, width=32, max_depth=4):
    return jax_make_camera(
        image_width=width, aspect_ratio=2.0, samples_per_pixel=spp, max_depth=max_depth, vfov_degrees=90.0,
        lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0), defocus_angle_degrees=0.0,
        focus_dist=1.0,
    )


def _jax_scene():
    return jax_scene.from_spheres(
        centers=[[0.0, -100.5, -1.0], [0.0, 0.0, -1.0], [-1.0, 0.0, -1.0], [1.0, 0.0, -1.0]],
        radii=[100.0, 0.5, 0.5, 0.5],
        mat_types=[0, 0, 2, 1],
        albedos=[[0.8, 0.8, 0.0], [0.1, 0.2, 0.5], [1.0, 1.0, 1.0], [0.8, 0.6, 0.2]],
        fuzzes=[0.0, 0.0, 0.0, 0.2],
        iors=[1.5, 1.5, 1.5, 1.5],
        pad_to=128,
    )


def _carry_scene(js):
    return scene_lib.scene_from_numpy({f: np.asarray(getattr(js, f)) for f in FIELDS}, device="cpu")


def _carry_cam(jc):
    return camera_from_numpy({f: np.asarray(getattr(jc, f)) for f in CAM_FIELDS},
                             jc.image_width, jc.image_height, jc.samples_per_pixel, jc.max_depth,
                             device="cpu")


def _zero_target(cam):
    return torch.zeros(cam.image_height, cam.image_width, 3)


# ---------------------------------------------------------------------------
# The repaired sqrt guards of the plain scatter.
# ---------------------------------------------------------------------------


def test_scatter_block_gradients_finite_at_the_sqrt_clamps():
    """Lambertian lanes built to hit the dielectric branch's clamps, which
    every lane evaluates: d = -n exactly (s2 = 0), a back-face ray past the
    critical angle (ratio * sin_theta > 1, k clamped to 0), and a grazing
    ray with |r_perp| = 1 exactly (k = 0 and its clamp passes the
    gradient). Backpropagating through the scatter must give finite
    gradients; the old single-where guard gives NaN at an exact 0."""
    n = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 0.0, 0.0]])  # [3, L]: +y normals
    s = float(np.sqrt(1.0 - 0.81))
    d = torch.tensor([[0.0, 0.9, 1.0], [-1.0, -s, 0.0], [0.0, 0.0, 0.0]])
    front = torch.tensor([[True, False, True]])
    params = torch.zeros(16, 3)
    params[cr._AR : cr._AB + 1] = 0.5
    params[cr._IOR] = torch.tensor([1.5, 1.5, 1.0])  # lane 2: ratio 1
    stream = (torch.tensor([[1, 2, 3]]), torch.tensor([[4, 5, 6]]))
    d.requires_grad_()
    n.requires_grad_()
    params.requires_grad_()
    new_dir, atten, ok = cr._scatter_block(d, n, front, params, stream, 8)
    (new_dir.sum() + atten.sum()).backward()
    for name, t in (("d", d), ("n", n), ("params", params)):
        assert bool(torch.isfinite(t.grad).all()), f"non-finite gradient of {name}"
    assert bool(ok.all())

    # The guard's primal is the single-where value bit for bit (0, tiny,
    # negative, NaN and random arguments); its gradient at 0 is finite
    # where the old form's is NaN.
    x = torch.cat([torch.tensor([0.0, 1e-45, 1e-30, -1.0, float("nan"), 1.0]),
                   torch.from_numpy(np.random.default_rng(0).uniform(-1, 2, 10_000).astype(np.float32))])
    old = torch.where(x > 0.0, cr._sqrt(x), 0.0)
    new = cr._sqrt(torch.where(x > 0.0, x, 1.0)) * (x > 0.0)
    assert torch.equal(old.view(torch.int32), new.view(torch.int32))
    zero = torch.zeros(1, requires_grad=True)
    torch.where(zero > 0.0, cr._sqrt(zero), 0.0).sum().backward()
    assert bool(torch.isnan(zero.grad).all())
    zero.grad = None
    (cr._sqrt(torch.where(zero > 0.0, zero, 1.0)) * (zero > 0.0)).sum().backward()
    assert float(zero.grad) == 0.0


# ---------------------------------------------------------------------------
# (a) the value, (d) pack_scene under autograd.
# ---------------------------------------------------------------------------


def test_value_bit_identical_to_render_cuda():
    sc, cam = _carry_scene(_jax_scene()), _carry_cam(_jax_cam())
    base = cr.render_cuda(sc, cam, seed=SEED)
    img, work = cg.render_cuda_diff(sc, cam, seed=SEED, return_work=True)
    assert torch.equal(img, base)
    assert torch.equal(cg.render_cuda_diff(sc, cam, seed=SEED, work_hint=work), base)
    assert torch.equal(cg.render_cuda_diff(sc, cam, seed=SEED, tile=256, bwd_tile=256), base)


def test_pack_scene_vjp_matches_jax():
    """Gradients reach center and radius through the fused rows (-2c,
    |c|^2 - r^2) and r^2: the row writes of pack_scene carry them. Same
    vector-Jacobian product as jax.vjp of the JAX pack_scene, to float32
    rounding."""
    js = _jax_scene()
    sc = _carry_scene(js)
    cot = np.random.default_rng(4).standard_normal((16, sc.num_slots)).astype(np.float32)
    jp = {k: getattr(js, k) for k in pg.DIFF_FIELDS}
    _, pull = jax.vjp(lambda p: pr.pack_scene(js.replace(**p)), jp)
    (theirs,) = pull(jnp.asarray(cot))
    ours = cg.params_vjp(sc, torch.from_numpy(cot))
    for k in pg.DIFF_FIELDS:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]), rtol=1e-6, atol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# (b) finite differences of the port's own render.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mean_grads():
    sc, cam = _carry_scene(_jax_scene()), _carry_cam(_jax_cam())
    params = cg.scene_params(sc)

    def loss(p):
        return cg.render_cuda_diff(cg.scene_with_params(sc, p), cam, seed=SEED).mean()

    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    grads = dict(zip(leaves, torch.autograd.grad(loss(leaves), list(leaves.values()))))
    return params, grads, loss


# tests/test_pallas_grad.py:107-117: index, step and tolerance per case.
# Measured: albedo 0.057524 vs 0.057518 and 0.023203 vs 0.023186; center
# 0.002663 vs 0.002682 and 0.000422 vs 0.000397; radius 0.000532 vs
# 0.000397; fuzz -0.000600 vs -0.000596; ior -0.002351 vs -0.002325.
@pytest.mark.parametrize(
    "field,idx,eps,atol,rtol",
    [
        ("albedo", (0, 0), 1e-3, 1e-5, 0.02),
        ("albedo", (1, 2), 1e-3, 1e-5, 0.02),
        ("center", (1, 1), 3e-4, 2e-4, 0.2),
        ("center", (1, 2), 3e-4, 2e-4, 0.2),
        ("radius", (1,), 3e-4, 2e-4, 0.2),
        ("fuzz", (3,), 1e-3, 1e-4, 0.1),
        ("ior", (2,), 1e-3, 1e-4, 0.1),
    ],
)
def test_gradients_match_finite_differences(mean_grads, field, idx, eps, atol, rtol):
    params, grads, loss = mean_grads
    xp, xm = params[field].clone(), params[field].clone()
    xp[idx] += eps
    xm[idx] -= eps
    fd = (float(loss({**params, field: xp})) - float(loss({**params, field: xm}))) / (2 * eps)
    ad = float(grads[field][idx])
    assert np.isclose(ad, fd, atol=atol, rtol=rtol), f"{field}[{idx}]: vjp {ad:.6f} vs FD {fd:.6f}"


# ---------------------------------------------------------------------------
# (c) against JAX render_grads_pallas, (e) against train_step_pallas.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_grads():
    js, jc = _jax_scene(), _jax_cam()
    target = jnp.zeros((jc.image_height, jc.image_width, 3), jnp.float32)
    loss, grads = pg.render_grads_pallas(
        {k: getattr(js, k) for k in pg.DIFF_FIELDS}, js, jc, target,
        seed=SEED, tile=512, bwd_tile=512, interpret=True, n_passes=1,
    )
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def test_gradients_agree_with_jax_kernel(jax_grads):
    """Per field, relative L2 of the port's gradient against the JAX
    kernel's. Measured at seed 3: center 3.5e-4, radius 9.4e-4, albedo
    3.1e-7, fuzz 1.2e-5, ior 1.3e-7 (seeds 0 and 1: at most 7.1e-5).
    Bound 5e-3. The loss agrees to 2e-7 relative (bound 1e-5)."""
    loss_j, grads_j = jax_grads
    sc, cam = _carry_scene(_jax_scene()), _carry_cam(_jax_cam())
    loss, grads = cg.render_grads_cuda(cg.scene_params(sc), sc, cam, _zero_target(cam), seed=SEED)
    assert abs(float(loss) - loss_j) <= 1e-5 * loss_j
    for k in cg.DIFF_FIELDS:
        ours, theirs = grads[k].numpy(), grads_j[k]
        rel = np.linalg.norm(ours - theirs) / np.linalg.norm(theirs)
        assert rel < 5e-3, f"{k}: relative L2 {rel:.2e}"


def test_train_step_matches_jax_and_warm_carry_is_invariant():
    """One SGD step against train_step_pallas (spp 4, tile 128, lr 1e-2):
    measured loss 1.9e-7 relative apart, params at most 1.7e-9 apart
    (bounds 1e-5 and 2e-6). Then the warm carry: a step whose forward
    starts from the previous step's cost map has the identical loss, and
    params within 2e-6 (tests/test_pallas_grad.py:230-257, single device)."""
    js, jc = _jax_scene(), _jax_cam(spp=4)
    target = jnp.zeros((jc.image_height, jc.image_width, 3), jnp.float32)
    loss_j, params_j = pg.train_step_pallas(
        {k: getattr(js, k) for k in pg.DIFF_FIELDS}, js, jc, target, tile=128, bwd_tile=128,
        interpret=True,
    )
    sc, cam = _carry_scene(js), _carry_cam(jc)
    params = cg.scene_params(sc)
    kw = dict(tile=128, bwd_tile=128)
    loss0, p0 = cg.train_step_cuda(params, sc, cam, _zero_target(cam), **kw)
    assert abs(float(loss0) - float(loss_j)) <= 1e-5 * float(loss_j)
    for k in p0:
        np.testing.assert_allclose(p0[k].numpy(), np.asarray(params_j[k]), atol=2e-6, err_msg=k)

    loss1, p1, work = cg.train_step_cuda(params, sc, cam, _zero_target(cam), return_work=True, **kw)
    loss2, p2 = cg.train_step_cuda(params, sc, cam, _zero_target(cam), work_hint=work, **kw)
    assert float(loss0) == float(loss1) == float(loss2)
    for k in p0:
        np.testing.assert_allclose(p2[k].numpy(), p0[k].numpy(), atol=2e-6, err_msg=k)
        assert torch.equal(p1[k], p0[k])


# ---------------------------------------------------------------------------
# (h) the plain versions of the two backward kernels: the replay's records
# and the reverse walk's events, at 64x32, spp 4, depth 8.
# ---------------------------------------------------------------------------


def _words(t):
    """A float tensor's bits: records and events hold int32 words (a winner
    of -1 reads as NaN), so they are compared as int32."""
    return t.contiguous().view(torch.int32)


@functools.lru_cache(maxsize=None)
def _split(seed, cot_seed):
    """The plain split at 64x32, spp 4, depth 8 for render seed `seed` and
    a radiance cotangent from numpy seed `cot_seed`."""
    sc, cam = _carry_scene(_jax_scene()), _carry_cam(_jax_cam(spp=4, width=64, max_depth=8))
    n = cam.num_pixels
    _, work = cr.render_cuda(sc, cam, seed=seed, return_work=True)
    work = work.reshape(-1)
    grad_rad = torch.from_numpy(np.random.default_rng(cot_seed).standard_normal((3, n)).astype(np.float32))
    p_mat, cam_vec = cr.pack_scene(sc), cr.pack_camera(cam)
    scalars = (seed, 0, 0, n)
    pix, g = cg._bwd_lanes(work, grad_rad, 4, 384)  # 256 pad lanes at the tail
    replay = cg._replay_records_plain(p_mat, cam_vec, scalars, pix, 4, 8)
    events = cg._reverse_records_plain(p_mat, cam_vec, replay, g)
    return dict(scene=sc, cam=cam, work=work, grad_rad=grad_rad, p_mat=p_mat, cam_vec=cam_vec,
                scalars=scalars, pix=pix, g=g, replay=replay, events=events)


@pytest.fixture(scope="module")
def split():
    return _split(SEED, 5)


def test_replay_records_count_each_lanes_bounces(split):
    """Each lane owns as many records as the forward's work map gives its
    pixel (pad lanes none), and the slots follow the pixel ids."""
    pix, work, replay = split["pix"], split["work"], split["replay"]
    n = work.numel()
    live = pix < n
    assert int((~live).sum()) == 256
    want = torch.where(live, work[torch.where(live, pix, 0).long()].long(), 0)
    assert torch.equal(replay.ev_count.long(), want)
    assert replay.records.shape == (int(work.sum()), 16)
    order = torch.argsort(torch.where(live, pix.long(), 1 << 40))
    starts = replay.ev_start[order][: n]
    assert int(starts[0]) == 0 and torch.equal(starts[1:], torch.cumsum(want[order][: n], 0)[:-1])
    # Every lane's range ends with the last bounce of its last path.
    last = (replay.ev_start + replay.ev_count.long() - 1)[live]
    assert bool((_words(replay.records)[last, cg._REC_END] != cg._END_NONE).all())


def test_replay_records_equal_record_bounces(split):
    """The records of bounces that continue hold the same o, d, att and
    winner as `record_bounces`, bit for bit, keyed by stream and depth."""
    replay = split["replay"]
    words = _words(replay.records).numpy()
    cont = words[:, cg._REC_END] == cg._END_NONE
    rec = cg.record_bounces(split["p_mat"], split["cam_vec"], SEED, torch.arange(split["work"].numel()), 4, 8)
    assert int(cont.sum()) == rec["o"].shape[1]

    def by_key(lo, hi, depth):
        return np.lexsort((depth, hi, lo))

    mine = words[cont][by_key(words[cont, cg._REC_LO], words[cont, cg._REC_HI], words[cont, cg._REC_DEPTH])]
    theirs_key = by_key(rec["lo"].numpy(), rec["hi"].numpy(), rec["depth"].numpy())
    theirs = np.concatenate([_words(rec[k]).numpy().T for k in ("o", "d", "att")], axis=1)[theirs_key]
    np.testing.assert_array_equal(mine[:, 0:9], theirs)
    np.testing.assert_array_equal(mine[:, cg._REC_WINNER], rec["winner"].numpy()[theirs_key])
    np.testing.assert_array_equal(mine[:, cg._REC_DEPTH], rec["depth"].numpy()[theirs_key])


def test_events_equal_for_sorted_and_permuted_lanes(split):
    """The records and events sit in slots fixed by the pixel ids: lanes in
    a random order (numpy seed 6) give the same bits as cost-sorted ones."""
    perm = torch.from_numpy(np.random.default_rng(6).permutation(split["pix"].numel()))
    pix, g = split["pix"][perm], split["g"][:, perm]
    replay = cg._replay_records_plain(split["p_mat"], split["cam_vec"], split["scalars"], pix, 4, 8)
    assert torch.equal(_words(replay.records), _words(split["replay"].records))
    events = cg._reverse_records_plain(split["p_mat"], split["cam_vec"], replay, g)
    assert torch.equal(_words(events), _words(split["events"]))
    assert torch.equal(_words(replay.records), _words(split["replay"].records))  # the records stay


def test_float64_walk_of_the_same_records(split):
    """`_reverse_records_plain(..., dtype=torch.float64)`, the reference of
    `probes/grad_exact.py`, walks the same records: each event has the
    float32 walk's winner (word 0 as a value), the records stay, and the
    albedo rows (products of attenuations, no geometry to condition them)
    agree with the float32 walk to float32 rounding (3.1e-8 here)."""
    from ray_tracing_in_one_weekend_tpu_torch.probes import rel_l2

    records = split["replay"].records.clone()
    e64 = cg._reverse_records_plain(split["p_mat"], split["cam_vec"], split["replay"], split["g"],
                                    dtype=torch.float64)
    assert e64.dtype == torch.float64
    assert torch.equal(_words(split["replay"].records), _words(records))
    assert torch.equal(e64[:, 0].long(), _words(split["events"])[:, 0].long())
    cols = [1 + cg._EVENT_ROWS.index(r) for r in (cr._AR, cr._AG, cr._AB)]
    assert bool(torch.isfinite(e64).all())
    assert rel_l2(split["events"][:, cols], e64[:, cols]) <= 1e-6


@pytest.mark.parametrize("reduce", ["index_add", "ordered"])
@pytest.mark.parametrize("seeds", [(SEED, 5), (0, 0), (1, 1), (7, 2), (11, 9)])
def test_plain_split_matches_grad_pass_plain(split, seeds, reduce):
    """The reduction of the split's events against `_grad_pass_plain` on
    the same lanes, for five (render seed, cotangent seed) pairs and both
    plain reductions (`_reduce_events_plain`'s index_add, and
    `_reduce_events_ordered`, the kernel's order over the events' chunks):
    per field within 2e-5 relative L2. Both add the same per-bounce
    cotangents in float32, in another order, and the fields' sums cancel:
    at most 6.2e-6 over these pairs."""
    if seeds != (SEED, 5):
        split = _split(*seeds)
    p_mat = split["p_mat"]
    events = split["events"]
    winners = _words(events)[:, 0]
    assert 0 < int((winners >= 0).sum()) < events.shape[0]
    assert events.shape[0] > 2 * cg.CHUNK_EVENTS  # the order spans more than two chunks
    fn = {"index_add": cg._reduce_events_plain, "ordered": cg._reduce_events_ordered}[reduce]
    split_grad = fn(events, p_mat.shape[1])
    plain = cg._grad_pass_plain(p_mat, split["cam_vec"], split["scalars"], split["pix"], split["g"], 4, 8)
    fs, fp = cg.params_vjp(split["scene"], split_grad), cg.params_vjp(split["scene"], plain)
    for k in cg.DIFF_FIELDS:
        rel = float((fs[k] - fp[k]).double().norm() / fp[k].double().norm())
        assert rel <= 2e-5, f"{k}: relative L2 {rel:.2e}"


# ---------------------------------------------------------------------------
# (f) the cover scene, (g) the entry point.
# ---------------------------------------------------------------------------


def test_cover_scene_gradients_finite_and_nonzero():
    """The 512-slot cover scene at 32x16, spp 1, depth 6 (the JAX kernel's
    test at tests/test_pallas_grad.py:184-200): every field finite, and
    each non-zero."""
    sc = scene_lib.cover_scene(0, device="cpu")
    cam = make_camera(image_width=32, aspect_ratio=2.0, samples_per_pixel=1, max_depth=6, device="cpu")
    loss, grads = cg.render_grads_cuda(cg.scene_params(sc), sc, cam, _zero_target(cam), seed=0)
    assert np.isfinite(float(loss)) and float(loss) > 0.0
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), f"non-finite gradient of {k}"
        assert float(g.abs().sum()) > 0.0, f"zero gradient of {k}"


def test_inverse_render_entry_point_loss_falls(tmp_path):
    """`python -m ray_tracing_in_one_weekend_tpu_torch.examples.inverse_render`
    on the CPU, 3 steps at width 32: the loss falls, and both PPMs are
    written. (Three steps need not halve the albedo error, so the exit
    code may be 1.)"""
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tracing_in_one_weekend_tpu_torch.examples.inverse_render",
         "--device", "cpu", "--backend", "pallas", "--steps", "3", "--width", "32", "--outdir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
    )
    assert proc.returncode in (0, 1), proc.stderr
    losses = [float(line.split()[-1]) for line in proc.stderr.splitlines() if line.startswith("step")]
    assert len(losses) == 2 and losses[1] < losses[0], proc.stderr
    for name in ("target", "recovered"):
        assert (tmp_path / f"inverse_{name}.ppm").read_bytes().startswith(b"P3\n32 16\n255\n")
