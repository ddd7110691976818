"""The port's device functions (plain PyTorch) against the JAX kernel's.

Inputs are drawn from a seeded numpy generator and handed to both. The
PCG streams are pure uint32 arithmetic and must be bit-equal. Float
results agree to float32 rounding (atol 2e-6 on unit vectors and
O(1) points): the two frameworks' sin, cos and rsqrt differ in the last
ulp. The JAX functions run eagerly; `_sweep_ts` indexes its table ref
with `pl.ds`, so it runs inside a tiny interpret-mode `pallas_call`, as
tests/test_pallas.py runs it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ray_tracing_in_one_weekend_tpu.models import scene as jax_scene
from ray_tracing_in_one_weekend_tpu.models.camera import make_camera as jax_make_camera
from ray_tracing_in_one_weekend_tpu.ops import pallas_render as pr
from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr

torch.set_num_threads(2)

N_BITS = 100_000
ATOL = 2e-6


def _uint32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(x):
    """numpy uint32 -> the port's uint32 representation (int64)."""
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _unit(rng, n):
    v = rng.normal(size=(3, n))
    return (v / np.linalg.norm(v, axis=0)).astype(np.float32)


def test_pcg_and_u01_bit_equal():
    rng = np.random.default_rng(0)
    x, lo, hi = (_uint32(rng, (1, N_BITS)) for _ in range(3))
    np.testing.assert_array_equal(cr._pcg(_t(x)).numpy(), np.asarray(pr._pcg(jnp.asarray(x))))
    stream_j, stream_t = (jnp.asarray(lo), jnp.asarray(hi)), (_t(lo), _t(hi))
    for ctr in (0, 1, 3, 4, 8 + 16 * 7):
        np.testing.assert_array_equal(
            cr._u01(stream_t, ctr).numpy(), np.asarray(pr._u01(stream_j, ctr)), err_msg=f"ctr {ctr}"
        )
    ctr = (8 + 16 * rng.integers(0, 64, size=(1, N_BITS))).astype(np.uint32)
    np.testing.assert_array_equal(
        cr._u01(stream_t, _t(ctr) + 4).numpy(), np.asarray(pr._u01(stream_j, jnp.asarray(ctr) + 4))
    )
    bits = _uint32(rng, (1, N_BITS))
    np.testing.assert_array_equal(
        cr._to_unit_float(_t(bits)).numpy(), np.asarray(pr._to_unit_float(jnp.asarray(bits)))
    )


def test_unit_vectors_and_normalize3():
    rng = np.random.default_rng(1)
    n = 8192
    lo, hi = _uint32(rng, (1, n)), _uint32(rng, (1, n))
    ctr = (8 + 16 * rng.integers(0, 64, size=(1, n))).astype(np.uint32)
    ours = cr._unit_vectors((_t(lo), _t(hi)), _t(ctr)).numpy()
    theirs = np.asarray(pr._unit_vectors((jnp.asarray(lo), jnp.asarray(hi)), jnp.asarray(ctr)))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(ours, axis=0), 1.0, atol=1e-6)
    v = (rng.normal(size=(3, n)) * rng.uniform(1e-3, 1e3, size=(1, n))).astype(np.float32)
    np.testing.assert_allclose(
        cr._normalize3(torch.from_numpy(v)).numpy(), np.asarray(pr._normalize3(jnp.asarray(v))),
        rtol=0, atol=ATOL,
    )


def test_camera_ray_block_streams_bit_equal_rays_close():
    """Both lens parameterizations; the stream words are bit-equal, the
    rays agree to rounding."""
    rng = np.random.default_rng(2)
    n = 4096
    for kw in (dict(defocus_angle_degrees=0.6), dict(defocus_angle_degrees=0.0), dict(aperture=0.1)):
        cam = jax_make_camera(image_width=64, aspect_ratio=2.0, samples_per_pixel=2, max_depth=8, **kw)
        cam_vec = pr.pack_camera(cam)
        pix = rng.integers(0, 64 * 32, size=(1, n)).astype(np.int32)
        seed = int(rng.integers(0, 1 << 31))
        s_global = rng.integers(0, 1 << 20, size=(1, n)).astype(np.int32)
        px, py = (pix % 64).astype(np.float32), (pix // 64).astype(np.float32)
        h0_j = pr._pcg(jnp.asarray(pix).astype(jnp.uint32) ^ pr._pcg(jnp.uint32(seed)))
        h0_t = cr._pcg(_t(pix.astype(np.uint32)) ^ cr._pcg(seed))
        np.testing.assert_array_equal(h0_t.numpy(), np.asarray(h0_j))
        o_j, d_j, lo_j, hi_j = pr._camera_ray_block(
            pr._unpack_cam(jnp.asarray(cam_vec)), h0_j, jnp.asarray(px), jnp.asarray(py),
            jnp.asarray(s_global), n,
        )
        o_t, d_t, lo_t, hi_t = cr._camera_ray_block(
            cr._unpack_cam(torch.from_numpy(cam_vec)), h0_t, torch.from_numpy(px),
            torch.from_numpy(py), torch.from_numpy(s_global.astype(np.int64)),
        )
        np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
        np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=0, atol=ATOL * 8)
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0, atol=ATOL)


def test_scatter_block():
    """All three materials, both faces: same direction, attenuation and
    `ok` per lane."""
    rng = np.random.default_rng(3)
    n = 8192
    d = _unit(rng, n)
    n_vec = _unit(rng, n)
    front = (d * n_vec).sum(axis=0, keepdims=True) < 0
    n_vec = np.where(front, n_vec, -n_vec)  # the normal faces against the ray
    front_face = rng.random((1, n)) < 0.7
    params = np.zeros((16, n), np.float32)
    params[pr._MAT] = rng.integers(0, 3, size=n)
    params[pr._AR : pr._AB + 1] = rng.random((3, n))
    params[pr._FUZZ] = rng.uniform(0, 0.5, size=n)
    params[pr._IOR] = rng.choice([1.0, 1.33, 1.5, 2.4], size=n)
    params[pr._ACTIVE] = 1.0
    lo, hi = _uint32(rng, (1, n)), _uint32(rng, (1, n))
    ctr = (8 + 16 * rng.integers(0, 50, size=(1, n))).astype(np.uint32)
    dir_j, att_j, ok_j = pr._scatter_block(
        jnp.asarray(d), jnp.asarray(n_vec), jnp.asarray(front_face), jnp.asarray(params),
        (jnp.asarray(lo), jnp.asarray(hi)), jnp.asarray(ctr),
    )
    dir_t, att_t, ok_t = cr._scatter_block(
        torch.from_numpy(d), torch.from_numpy(n_vec), torch.from_numpy(front_face),
        torch.from_numpy(params), (_t(lo), _t(hi)), _t(ctr),
    )
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(att_t.numpy(), np.asarray(att_j))
    np.testing.assert_allclose(dir_t.numpy(), np.asarray(dir_j), rtol=0, atol=ATOL)


def _jax_sweep(pt, o, d, t_min):
    """The JAX `_sweep_ts` in a minimal interpret-mode kernel -> [N, T]."""
    n, tile = pt.shape[0], o.shape[1]

    def kernel(pt_ref, o_ref, d_ref, out_ref, *, n_chunks):
        out_ref[:, :] = jnp.concatenate(
            pr._sweep_ts(o_ref[:, :], d_ref[:, :], pt_ref, n_chunks, t_min), axis=0
        )

    return np.array(pl.pallas_call(
        functools.partial(kernel, n_chunks=n // pr.CHUNK),
        out_shape=jax.ShapeDtypeStruct((n, tile), jnp.float32),
        interpret=pltpu.InterpretParams(),
    )(jnp.asarray(pt), jnp.asarray(o), jnp.asarray(d)))


def test_sweep_and_select_hit_match_jax():
    """Rays from around the cover scene: candidate t per (sphere, ray) to
    rounding, the same winner, the same gathered parameters."""
    rng = np.random.default_rng(4)
    sc = jax_scene.cover_scene(0)
    p_mat = np.array(pr.pack_scene(sc))
    tile = 256
    o = np.stack([rng.uniform(-12, 12, tile), rng.uniform(0.05, 3, tile), rng.uniform(-12, 12, tile)])
    o = o.astype(np.float32)
    d = _unit(rng, tile)
    for t_min in (pr.T_MIN_EPS, 0.0):
        ts_j = _jax_sweep(p_mat.T.copy(), o, d, t_min)
        ts_t = cr._sweep_ts(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(p_mat), t_min)
        ts_t = ts_t.numpy()
        np.testing.assert_array_equal(ts_t == pr.T_MISS, ts_j == pr.T_MISS)
        # t to rtol 1e-5, except near-tangent pairs: there sqrt(disc)
        # amplifies disc's last-ulp rounding to ~sqrt(eps)*|half_b|
        # (<= 4e-3 for |half_b| <= 15), on well under 0.1% of pairs.
        close = np.isclose(ts_t, ts_j, rtol=1e-5, atol=1e-5)
        assert (~close).mean() < 1e-3
        np.testing.assert_allclose(ts_t, ts_j, rtol=0, atol=4e-3)
        assert (ts_t < pr.T_MISS).any(axis=0).mean() > 0.3  # many rays hit something

        t_best_j, params_j, onehot = pr._select_hit(
            jnp.asarray(p_mat), [jnp.asarray(ts_j[c : c + pr.CHUNK]) for c in range(0, 512, pr.CHUNK)]
        )
        t_best_t, params_t, best = cr._select_hit(torch.from_numpy(p_mat), torch.from_numpy(ts_j))
        np.testing.assert_array_equal(t_best_t.numpy(), np.asarray(t_best_j))
        np.testing.assert_array_equal(params_t.numpy(), np.asarray(params_j))
        hit = np.asarray(t_best_j)[0] < pr.T_MISS
        np.testing.assert_array_equal(
            best.numpy()[0][hit], np.asarray(onehot).argmax(axis=0)[hit]
        )


def test_sweep_ts_negative_disc_is_miss():
    """NaN-as-miss on the plain sweep (the counterpart of tests/test_pallas.py's
    kernel-level test): rays pointing away from every sphere — including
    the r^2 = -1 padding slots — yield T_MISS, no NaN escapes, and a
    head-on control ray still gets the analytic root."""
    sc = scene_lib.single_sphere_scene(pad_to=128, device="cpu")  # sphere (0,0,-1) r=0.5
    p_mat = cr.pack_scene(sc)
    n, tile = p_mat.shape[1], 128
    o = torch.zeros((3, tile))
    d = torch.zeros((3, tile))
    d[1, 0] = 1.0  # straight up: misses, disc < 0
    d[2, 1] = 1.0  # straight back: disc < 0
    d[2, 2] = -1.0  # head-on: hits at t = 0.5
    d[0, 3:] = 1.0  # +x: misses
    ts = cr._sweep_ts(o, d, p_mat).numpy()
    assert np.all(np.isfinite(ts)), "NaNs must not escape _sweep_ts"
    hit_mask = np.zeros((n, tile), bool)
    hit_mask[0, 2] = True
    assert np.all(ts[~hit_mask] == cr.T_MISS)
    np.testing.assert_allclose(ts[0, 2], 0.5, rtol=1e-6)
