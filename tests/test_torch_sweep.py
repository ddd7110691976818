"""The sweep of `csrc/render_device.cuh` (`closest_hit`), emulated in torch,
against the plain version `_sweep_ts` + `_select_hit` and the JAX sweep.

The kernel's sweep reads one float4 a sphere, (cx, cy, cz, |c|^2 - r^2),
takes the ray's o2 = -2o once and forms c.(-2o) where the plain version
forms (-2c).o, tests spheres in groups of 8, takes the roots of a group
only when one of its discriminants has its sign bit clear, and updates
(t_best, best) in index order with the strict <. `_closest_hit_kernel`
below is that arithmetic, operation for operation, in float32 on the CPU;
it must give the plain version's bits (`torch.equal`), as the kernel must
on the card. The readings probe's SASS parser and occupancy rules are
tested here too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ray_tracing_in_one_weekend_tpu.models import scene as jax_scene
from ray_tracing_in_one_weekend_tpu.ops import pallas_render as pr
from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
from ray_tracing_in_one_weekend_tpu_torch.probes import sweep_readings as sr
from ray_tracing_in_one_weekend_tpu_torch.probes import (
    TIE_DUPLICATES,
    first_slots,
    tie_camera,
    tie_scene,
    without_duplicates,
)
from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
    PRESETS,
    make_camera_from_config,
    make_scene_from_config,
)

torch.set_num_threads(2)

GROUP = 8  # csrc/render_device.cuh's SWEEP_GROUP
CHUNK = 8192  # lanes per step of the plain sweep: bounds its [N, lanes] temporaries


def _sweep_table(p_mat):
    """The kernel's sweep table from the packed scene: [N, 4] rows (cx, cy,
    cz, |c|^2 - r^2), rows 4i and 4i+3 of the device table."""
    return torch.stack([p_mat[cr._CX], p_mat[cr._CY], p_mat[cr._CZ], p_mat[cr._CSQR2]], dim=1)


def _sphere_disc(c, o2, d, o_dot_d, o_sq):
    """`sphere_disc`: (half_b, disc) of one sphere row c [4] for every ray."""
    d_dot_c = c[0] * d[0:1] + c[1] * d[1:2] + c[2] * d[2:3]
    cc_part = c[3] + c[0] * o2[0:1] + c[1] * o2[1:2] + c[2] * o2[2:3]
    half_b = o_dot_d - d_dot_c
    cc = o_sq + cc_part
    return half_b, half_b * half_b - cc


def _root(half_b, disc, t_min):
    """`take_root`'s t for the rays whose disc >= 0 (the others' t is unused)."""
    sqrt_d = cr._sqrt(torch.where(disc >= 0.0, disc, 0.0))
    root_near = -half_b - sqrt_d
    return torch.where(root_near > t_min, root_near, -half_b + sqrt_d)


def _closest_hit_kernel(p_mat, o, d, t_min, group=GROUP):
    """`closest_hit` of csrc/render_device.cuh on [3, L] rays -> (t_best
    [1, L], best [1, L] int64)."""
    sweep = _sweep_table(p_mat)
    o_dot_d, o_sq = cr._dot3(o, d), cr._dot3(o, o)
    o2 = -2.0 * o
    t_best = torch.full_like(o_dot_d, cr.T_MISS)
    best = torch.zeros(o_dot_d.shape, dtype=torch.int64)

    def take(i, half_b, disc, enter):
        nonlocal t_best, best
        t = _root(half_b, disc, t_min)
        upd = enter & (disc >= 0.0) & (t > t_min) & (t < t_best)
        t_best = torch.where(upd, t, t_best)
        best = torch.where(upd, i, best)

    n, i = sweep.shape[0], 0
    while i + group <= n:
        tests = [_sphere_disc(sweep[i + k], o2, d, o_dot_d, o_sq) for k in range(group)]
        signs = torch.full(o_dot_d.shape, -1, dtype=torch.int32)
        for _, disc in tests:
            signs = signs & disc.view(torch.int32)
        enter = signs >= 0  # some disc has its sign bit clear
        for k, (half_b, disc) in enumerate(tests):
            take(i + k, half_b, disc, enter)
        i += group
    for i in range(i, n):
        take(i, *_sphere_disc(sweep[i], o2, d, o_dot_d, o_sq), True)
    return t_best, best


def _kernel_ts(p_mat, o, d, t_min):
    """Every (sphere, ray) pair's candidate t by the kernel's arithmetic ->
    [N, L], T_MISS where it has no root beyond t_min: `_sweep_ts`'s layout."""
    sweep = _sweep_table(p_mat)[:, :, None]  # [N, 4, 1]
    o2 = -2.0 * o
    d_dot_c = sweep[:, 0] * d[0:1] + sweep[:, 1] * d[1:2] + sweep[:, 2] * d[2:3]
    cc_part = sweep[:, 3] + sweep[:, 0] * o2[0:1] + sweep[:, 1] * o2[1:2] + sweep[:, 2] * o2[2:3]
    half_b = cr._dot3(o, d) - d_dot_c
    disc = half_b * half_b - (cr._dot3(o, o) + cc_part)
    t = _root(half_b, disc, t_min)
    return torch.where((disc >= 0.0) & (t > t_min), t, cr.T_MISS)


def _plain_hits(p_mat, o, d, t_min):
    """`_sweep_ts` + `_select_hit`, in lane chunks -> (t_best, best)."""
    out = [cr._select_hit(p_mat, cr._sweep_ts(o[:, s:s + CHUNK], d[:, s:s + CHUNK], p_mat, t_min))
           for s in range(0, o.shape[1], CHUNK)]
    return torch.cat([t for t, _, _ in out], 1), torch.cat([b for _, _, b in out], 1)


def _assert_same_hits(p_mat, o, d, t_min, group=GROUP):
    t_k, b_k = _closest_hit_kernel(p_mat, o, d, t_min, group)
    t_p, b_p = _plain_hits(p_mat, o, d, t_min)
    assert torch.equal(t_k, t_p)
    hit = t_p < cr.T_MISS
    assert torch.equal(b_k[hit], b_p[hit])
    return t_k, b_k


def _bench_rays(budget, n=1 << 16):
    """2^16 rays of the bench preset (cover_scene(0), 1200x800, 10 spp):
    lanes of pixels drawn with numpy (seed 0), after `budget` iterations of
    one plain pass: camera rays at 0, the next ray after each bounce."""
    config = PRESETS["bench"]
    scene, cam = make_scene_from_config(config, "cpu"), make_camera_from_config(config, "cpu")
    p_mat, cam_vec = cr.pack_scene(scene), cr.pack_camera(cam)
    pix = np.random.default_rng(0).choice(cam.num_pixels, size=n, replace=False)
    sf, si = cr._init_state(0, n, cam.num_pixels, cam.samples_per_pixel)
    si[cr._SI_PIX] = torch.from_numpy(pix.astype(np.int32))
    # A pass of budget 0 only starts every lane's first sample.
    sf, si = cr._render_pass_plain(p_mat, cam_vec, (0, 0, 0, budget), sf, si, 128,
                                   cam.samples_per_pixel, cam.max_depth)
    live = si[cr._SI_BUSY] > 0
    o = sf[cr._SF_O:cr._SF_O + 3][:, live].contiguous()
    d = sf[cr._SF_D:cr._SF_D + 3][:, live].contiguous()
    return p_mat, o, d, float(cam_vec[20])


@pytest.mark.parametrize("budget", [0, 1])
def test_kernel_sweep_bit_identical_on_bench_rays(budget):
    """The bench camera's rays (budget 0) and the rays after one bounce
    (budget 1, from points on the spheres, where t_min matters), against
    cover_scene(0)'s 512 slots: t_best and the winner bit for bit."""
    p_mat, o, d, t_min = _bench_rays(budget)
    assert o.shape[1] > 40000
    t, _ = _assert_same_hits(p_mat, o, d, t_min)
    assert float((t < cr.T_MISS).double().mean()) > 0.3  # many rays hit a sphere


def test_kernel_sweep_bit_identical_on_random_pairs():
    """10^6 (sphere, ray) pairs from numpy (seed 5): 1000 spheres with
    centers up to +-1e3 and radii from 1e-2 to 1e2, plus the r = 1000
    ground sphere, against 1000 rays from origins up to +-1e3: every pair's
    t by the kernel's arithmetic equals `_sweep_ts`'s bit for bit, and so
    do the closest hits, for t_min 1e-3 and 0."""
    rng = np.random.default_rng(5)
    n_sph, n_ray = 1000, 1000
    centers = rng.uniform(-1e3, 1e3, (n_sph, 3))
    radii = 10.0 ** rng.uniform(-2, 2, n_sph)
    centers[0], radii[0] = (0.0, -1000.0, 0.0), 1000.0
    scene = scene_lib.from_spheres(centers.tolist(), radii.tolist(), [0] * n_sph, device="cpu")
    p_mat = cr.pack_scene(scene)
    o = torch.from_numpy(rng.uniform(-1e3, 1e3, (3, n_ray)).astype(np.float32))
    # Half the rays aim at a sphere, so that many pairs have real roots.
    aim = torch.from_numpy(centers[rng.integers(0, n_sph, n_ray)].T.astype(np.float32)) - o
    spread = torch.from_numpy(rng.normal(size=(3, n_ray)).astype(np.float32))
    d = cr._normalize3(torch.where(torch.arange(n_ray) % 2 == 0, aim, spread))
    for t_min in (cr.T_MIN_EPS, 0.0):
        ts_k = _kernel_ts(p_mat, o, d, t_min)
        ts_p = cr._sweep_ts(o, d, p_mat, t_min)
        assert torch.equal(ts_k, ts_p)
        assert int((ts_p < cr.T_MISS).sum()) > 1000
        _assert_same_hits(p_mat, o, d, t_min)


def _rays_at_scene(n, seed):
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.2, 0.5, n), np.full(n, 1.0)])
    target = np.stack([rng.uniform(-1.8, 1.8, n), rng.uniform(-0.6, 0.6, n), np.full(n, -1.0)])
    d = cr._normalize3(torch.from_numpy((target - o).astype(np.float32)))
    return torch.from_numpy(o.astype(np.float32)), d


def test_exact_ties_pick_the_lowest_index():
    """`probes.tie_scene`: every tie goes to the lower index, whether the
    two slots share a group or not, in groups of 8 and of 4, and the plain
    render equals that of the scene without the duplicates."""
    p_mat = cr.pack_scene(tie_scene("cpu"))
    o, d = _rays_at_scene(8192, 6)
    for group in (8, 4):
        t, best = _assert_same_hits(p_mat, o, d, cr.T_MIN_EPS, group)
        won = set(best[t < cr.T_MISS].tolist())
        assert {1, 2, 4, 6, 7} <= won and not won & set(TIE_DUPLICATES), won
    # A duplicate is never hit, so the render is that of the scene without them.
    cam, scene = tie_camera("cpu"), tie_scene("cpu")
    assert torch.equal(cr.render_cuda(scene, cam), cr.render_cuda(without_duplicates(scene), cam))


@pytest.mark.parametrize("n_slots", [1, 2, 3, 5, 7, 9, 11])
def test_ragged_slot_counts_give_the_same_hits(n_slots):
    """Slot counts that are not a multiple of the group: the whole groups
    and the one-by-one remainder together give the plain version's hits,
    in groups of 8, 4 and 16."""
    p_mat = cr.pack_scene(first_slots(tie_scene("cpu"), n_slots))
    o, d = _rays_at_scene(2048, n_slots)
    for group in (8, 4, 16):
        _assert_same_hits(p_mat, o, d, cr.T_MIN_EPS, group)


def _jax_sweep(pt, o, d, t_min):
    """The JAX `_sweep_ts` in a minimal interpret-mode kernel -> [N, T]."""
    n, tile = pt.shape[0], o.shape[1]

    def kernel(pt_ref, o_ref, d_ref, out_ref, *, n_chunks):
        out_ref[:, :] = jnp.concatenate(
            pr._sweep_ts(o_ref[:, :], d_ref[:, :], pt_ref, n_chunks, t_min), axis=0)

    return np.array(pl.pallas_call(
        functools.partial(kernel, n_chunks=n // pr.CHUNK),
        out_shape=jax.ShapeDtypeStruct((n, tile), jnp.float32),
        interpret=pltpu.InterpretParams(),
    )(jnp.asarray(pt), jnp.asarray(o), jnp.asarray(d)))


def test_kernel_sweep_matches_jax_sweep():
    """Against the JAX kernel's sweep on the JAX cover scene (interpret
    mode, as tests/test_torch_device_fns.py runs it), at that test's
    bounds: the same misses, the best t within 4e-3 (near-tangent pairs
    and the r = 1000 ground sphere's cancelling |c|^2 - r^2 amplify the
    frameworks' last-ulp differences), and the same winner on every ray
    whose best t is clear of the runner-up's by more than 1e-3 relative."""
    rng = np.random.default_rng(7)
    p_mat = np.array(pr.pack_scene(jax_scene.cover_scene(0)))
    tile = 256
    o = np.stack([rng.uniform(-12, 12, tile), rng.uniform(0.05, 3, tile), rng.uniform(-12, 12, tile)])
    v = rng.normal(size=(3, tile))
    o, d = o.astype(np.float32), (v / np.linalg.norm(v, axis=0)).astype(np.float32)
    ts_j = _jax_sweep(p_mat.T.copy(), o, d, pr.T_MIN_EPS)
    t_k, b_k = _closest_hit_kernel(torch.from_numpy(p_mat), torch.from_numpy(o), torch.from_numpy(d),
                                   pr.T_MIN_EPS)
    t_k, b_k = t_k.numpy()[0], b_k.numpy()[0]
    t_j, b_j = ts_j.min(axis=0), ts_j.argmin(axis=0)
    np.testing.assert_array_equal(t_k < pr.T_MISS, t_j < pr.T_MISS)
    np.testing.assert_allclose(t_k, t_j, rtol=0, atol=4e-3)
    runner_up = np.sort(ts_j, axis=0)[1]
    clear = (t_j < pr.T_MISS) & (runner_up - t_j > 1e-3 * np.abs(t_j))
    assert clear.sum() > 50
    np.testing.assert_array_equal(b_k[clear], b_j[clear])


# ---------------------------------------------------------------------------
# The readings probe: ptxas' report, the SASS loop parser, the occupancy rules.
# ---------------------------------------------------------------------------

_PTXAS = """\
ptxas info    : Compiling entry function '_Z13render_kernelPK6float4iPKfS3_PKiPfPiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _Z13render_kernelPK6float4iPKfS3_PKiPfPiiiiiii
    8 bytes stack frame, 12 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 64 registers, 96 bytes smem, 440 bytes cmem[0]
ptxas info    : Compiling entry function '_Z18sweep_probe_kernelPK6float4iPKfS3_Pfiif' for 'sm_90a'
ptxas info    : Function properties for _Z18sweep_probe_kernelPK6float4iPKfS3_Pfiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 408 bytes cmem[0]
"""


def test_ptxas_resources_and_kernel_names():
    res = sr.ptxas_resources(_PTXAS)
    name = sr.find_kernel(res, "render_kernel")
    assert name.startswith("_Z13render_kernel")
    assert res[name] == sr.Resources(registers=64, spill_stores=12, spill_loads=20, smem=96)
    probe = res[sr.find_kernel(res, "sweep_probe")]
    assert (probe.registers, probe.spill_stores, probe.smem) == (40, 0, 0)
    assert sr.find_kernel(res, "grad_replay") is None


def _sass_line(addr, text):
    return f"        /*{addr:04x}*/                   {text} ;   /* 0x000000000000000000 */\n" \
           "                                                                 /* 0x000fe20000000f00 */\n"


def _synthetic_sass():
    """A kernel with an outer loop around a sweep loop of 2 tests a trip
    (each: LDS, 7 FMUL, 8 FADD), a skipped root block, a loop tail, and a
    one-test remainder loop."""
    body, a = [], 0

    def emit(text):
        nonlocal a
        body.append(_sass_line(a, text))
        a += 0x10

    emit("S2R R0, SR_TID.X")
    outer = a
    emit("LDS R9, [0x60]")
    head = a
    for _ in range(2):
        emit("LDS.128 R4, [R2]")
        for _ in range(7):
            emit("FMUL R10, R4, R5")
        for _ in range(8):
            emit("FADD R11, R10, R6")
    emit("LOP3.LUT P0, RZ, R12, R13, RZ, 0x80, !PT")
    skip_at = a
    emit("@P0 BRA 0xSKIP")
    for _ in range(12):
        emit("MUFU.RSQ R14, R11")
    join = a
    emit("IADD3 R2, R2, 0x20, RZ")
    emit("ISETP.GE.AND P1, PT, R2, R3, PT")
    emit(f"@!P1 BRA 0x{head:x}")
    rem = a
    emit("LDS.128 R4, [R2]")
    for _ in range(7):
        emit("FMUL R10, R4, R5")
    emit(f"@!P1 BRA 0x{rem:x}")
    for _ in range(3):
        emit("FMUL R20, R21, R22")
    emit(f"BRA 0x{outer:x}")
    emit("EXIT")
    emit("NOP")
    text = "".join(body).replace("0xSKIP", f"0x{join:x}")
    assert skip_at < join
    return "\n\tcode for sm_90a\n\t\tFunction : _Z13render_kernelPK6float4\n" + text


def test_sass_sweep_loop_per_test():
    funcs = sr.sass_functions(_synthetic_sass())
    name = sr.find_kernel(funcs, "render_kernel")
    loop = sr.sweep_loop(funcs[name])
    # 2 x (1 + 7 + 8) + LOP3 + BRA + IADD3 + ISETP + BRA = 37 a trip, 2 tests.
    assert (loop.instructions, loop.tests) == (37, 2)
    assert loop.per_test == 18.5
    assert "MUFU" not in loop.opcodes and loop.opcodes["LDS"] == 2
    assert sr.sweep_loop("") is None


def _synthetic_sass_root_loop():
    """threefry_render_kernel's shape: a sweep loop of 2 tests a trip (each
    LDS, 2 FMUL, 5 FFMA) whose skipped root block holds a loop over the
    group's roots (one test taken again: 5 FFMA)."""
    body, a = [], 0

    def emit(text):
        nonlocal a
        body.append(_sass_line(a, text))
        a += 0x10

    head = a
    for _ in range(2):
        emit("LDS.128 R4, [R2]")
        for _ in range(2):
            emit("FMUL R10, R4, R5")
        for _ in range(5):
            emit("FFMA R11, R10, R6, R7")
    emit("LOP3.LUT P0, RZ, R12, R13, RZ, 0x80, !PT")
    emit("@P0 BRA 0xSKIP")
    roots = a
    emit("FLO.U32 R15, R16")
    for _ in range(5):
        emit("FFMA R11, R10, R6, R7")
    emit("MUFU.RSQ R14, R11")
    emit(f"@P2 BRA 0x{roots:x}")
    join = a
    emit("IADD3 R2, R2, 0x20, RZ")
    emit("ISETP.GE.AND P1, PT, R2, R3, PT")
    emit(f"@!P1 BRA 0x{head:x}")
    emit("EXIT")
    text = "".join(body).replace("0xSKIP", f"0x{join:x}")
    return "\n\tcode for sm_90a\n\t\tFunction : _ZN3tfr22threefry_render_kernelEPK6float4\n" + text


def test_sass_sweep_loop_around_a_root_loop():
    """The loop over a group's roots lies in the skipped block, so the sweep
    loop is still the one read: 2 x (1 + 2 + 5) + LOP3 + BRA + IADD3 +
    ISETP + BRA = 21 a trip, 2 tests, nothing of the root loop."""
    funcs = sr.sass_functions(_synthetic_sass_root_loop())
    loop = sr.sweep_loop(next(iter(funcs.values())), "FFMA", sr.FFMA_PER_TEST)
    assert (loop.instructions, loop.tests) == (21, 2)
    assert "FLO" not in loop.opcodes and "MUFU" not in loop.opcodes and loop.opcodes["FFMA"] == 10


def test_occupancy_rules():
    """Blocks an H100 SM holds at 128 threads: the parent's sweep kernels
    (76 registers, 32 KB table) 6, the 64-register kernels with an 8 KB
    table 8, and the thread limit (16 blocks of 128) below 40 registers."""
    assert sr.blocks_per_sm(76, 96 + 512 * 64, 128) == 6
    assert sr.blocks_per_sm(64, 96 + 512 * 16, 128) == 8
    assert sr.blocks_per_sm(32, 512 * 16, 128) == 16
    assert sr.blocks_per_sm(64, 96 + 512 * 16, 512) == 2
