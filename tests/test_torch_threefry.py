"""The port's threefry keys, cover scene and samplers against the JAX package.

`ops/threefry.py` carries JAX 0.9's threefry2x32 (`jax_threefry_partitionable`
on, the default and what tests/conftest.py sets): keys, fold_in, split,
random bits and uniforms must be `jax.random`'s bits exactly, and so must
the cover scene drawn from them and every uniform of `ops/sampling.py`.
The samplers that go through a transcendental (Box-Muller's log, sin and
cos; `normal`'s erfinv) use torch's functions, not XLA's, and are held to
the ulp bounds stated at each test.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng

from ray_tracing_in_one_weekend_tpu.models import scene as jax_scene
from ray_tracing_in_one_weekend_tpu.ops import sampling as jax_sampling
from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.ops import sampling, threefry

torch.set_num_threads(2)

SEEDS = (0, 1, 7, 2**31 - 1)
DATA = (0, 1, 1 << 20, 2**32 - 1)
RANGES = ((0.0, 1.0), (0.5, 1.0), (0.0, 0.5))
FIELDS = ("center", "radius", "albedo", "fuzz", "ior", "mat_type", "active")
JAX_TABLE = os.path.join(os.path.dirname(__file__), "..", "ray_tracing_in_one_weekend_tpu_torch",
                         "scripts", "jax_cover_scene_0.npz")


def _words(key) -> tuple:
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


def _lanes(keys) -> tuple:
    data = np.asarray(jax.random.key_data(keys)).astype(np.int64)
    return torch.from_numpy(data[..., 0].copy()), torch.from_numpy(data[..., 1].copy())


def _ulps(a, b) -> np.ndarray:
    """|a - b| in float32 ulps (the distance of their ordered bit patterns)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_and_uniform_are_jax_bits(seed):
    """key, fold_in on data 0, 1, 2^20 and 2^32-1, split and uniform for n
    = 1..7 on three (minval, maxval) ranges: jax.random's words and floats
    exactly."""
    key = jax.random.key(seed)
    ours = threefry.key(seed)
    assert ours == _words(key)
    for data in DATA:
        assert threefry.fold_in(ours, data) == _words(jax.random.fold_in(key, data)), data
    for n in range(1, 8):
        w0, w1 = threefry.split(ours, n)
        theirs = np.asarray(jax.random.key_data(jax.random.split(key, n)))
        np.testing.assert_array_equal(np.stack([w0.numpy(), w1.numpy()], axis=-1), theirs)
        np.testing.assert_array_equal(threefry.random_bits(ours, (n,)).numpy(),
                                      np.asarray(jax.random.bits(key, (n,), jnp.uint32)))
        for lo, hi in RANGES:
            np.testing.assert_array_equal(
                threefry.uniform(ours, (n,), lo, hi).numpy(),
                np.asarray(jax.random.uniform(key, (n,), jnp.float32, lo, hi)), err_msg=f"{n} {lo} {hi}")


def test_threefry_block_and_lane_forms():
    """The raw block against JAX's threefry_2x32 on counters that cross the
    uint32 range, and the per-lane forms (fold_in with lane data, draws of
    a shape from [R] keys) against jax.vmap."""
    k = jax.random.key_data(jax.random.key(12345))
    counts = np.array([0, 1, 2**31, 2**32 - 1, 77, 2**20], np.uint32)
    theirs = np.asarray(prng.threefry_2x32(k, counts))
    words = tuple(int(w) for w in np.asarray(k))
    y0, y1 = threefry.threefry_2x32(words, torch.tensor(counts[:3].astype(np.int64)),
                                    torch.tensor(counts[3:].astype(np.int64)))
    np.testing.assert_array_equal(np.concatenate([y0.numpy(), y1.numpy()]), theirs)

    base = jax.random.key(3)
    data = jnp.arange(0, 2**32 - 1, 2**26, dtype=jnp.uint32)
    lanes = jax.vmap(lambda d: jax.random.fold_in(base, d))(data)
    ours = threefry.fold_in(threefry.key(3), torch.tensor(np.asarray(data).astype(np.int64)))
    np.testing.assert_array_equal(np.stack([w.numpy() for w in ours], -1),
                                  np.asarray(jax.random.key_data(lanes)))
    np.testing.assert_array_equal(
        threefry.uniform(ours, (2, 3)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (2, 3)))(lanes)))
    w0, w1 = threefry.split(ours, 3)
    np.testing.assert_array_equal(np.stack([w0.numpy(), w1.numpy()], -1),
                                  np.asarray(jax.random.key_data(jax.vmap(lambda k: jax.random.split(k, 3))(lanes))))


@pytest.mark.parametrize("seed", range(4))
def test_cover_scene_equals_jax(seed):
    """cover_scene(seed) is the JAX package's cover_scene(seed) in every
    field and every slot, bit for bit: the port's and the JAX CLI's
    `--scene cover --seed s` build one world."""
    ours = scene_lib.cover_scene(seed, device="cpu")
    theirs = jax_scene.cover_scene(seed)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(theirs, f)), err_msg=f)
    assert ours.center.dtype == torch.float32 and ours.mat_type.dtype == torch.int32
    assert ours.num_slots == 512


def test_cover_scene_0_equals_committed_table():
    """cover_scene(0) is the committed table of the JAX scene (the check the
    card, which has no JAX, runs): 485 active spheres, lambertian / metal /
    dielectric 396 / 72 / 17."""
    ours = scene_lib.cover_scene(0, device="cpu")
    with np.load(JAX_TABLE) as z:
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(ours, f).numpy(), z[f], err_msg=f)
    assert ours.num_active == 485
    mix = np.bincount(ours.mat_type[ours.active].numpy(), minlength=3)
    assert mix.tolist() == [396, 72, 17]


def test_sampling_uniforms_are_jax_bits():
    """Every uniform draw of ops/sampling.py on [R] keys: JAX's bits."""
    base = jax.random.key(5)
    keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(257))
    lanes = _lanes(keys)
    for n, domain in ((5, 0), (5, 7), (4, 1 << 20)):
        np.testing.assert_array_equal(sampling.uniforms_b(lanes, n, domain).numpy(),
                                      np.asarray(jax_sampling.uniforms_b(keys, n, domain=domain)))
    np.testing.assert_array_equal(sampling.uniform_b(lanes).numpy(), np.asarray(jax_sampling.uniform_b(keys)))
    np.testing.assert_array_equal(sampling.uniform2_b(lanes).numpy(), np.asarray(jax_sampling.uniform2_b(keys)))
    folded = sampling.fold_b(lanes, torch.arange(257))
    np.testing.assert_array_equal(np.stack([w.numpy() for w in folded], -1), np.asarray(
        jax.random.key_data(jax_sampling.fold_b(keys, jnp.arange(257)))))
    assert sampling.pixel_sample_key(threefry.key(5), 9, 4) == _words(
        jax_sampling.pixel_sample_key(base, 9, 4))
    one = threefry.key(11)
    np.testing.assert_array_equal(sampling.uniform(one, (6,)).numpy(),
                                  np.asarray(jax_sampling.uniform(jax.random.key(11), (6,))))
    np.testing.assert_array_equal(sampling.random_vec3(one, 0.5, 1.0, (4,)).numpy(),
                                  np.asarray(jax_sampling.random_vec3(jax.random.key(11), 0.5, 1.0, (4,))))


def test_box_muller_within_ulps():
    """unit_vector_from_uniforms on JAX's uniforms: torch's log, sin, cos and
    rsqrt against XLA's, each a few ulps apart, so the directions agree to
    at most 8 ulps a component (measured 4) and 2.5e-7 absolute (measured
    1.8e-7)."""
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(3), i))(jnp.arange(4096))
    u4 = np.asarray(jax_sampling.uniforms_b(keys, 4, domain=2))
    ours = sampling.unit_vector_from_uniforms(torch.from_numpy(u4.copy())).numpy()
    theirs = np.asarray(jax_sampling.unit_vector_from_uniforms(u4))
    assert _ulps(ours, theirs).max() <= 8
    assert np.abs(ours - theirs).max() <= 2.5e-7


def test_normal_samplers_within_ulps():
    """The samplers built on `normal` (sqrt(2) erfinv of a uniform on
    (nextafter(-1, 0), 1)): the uniform is JAX's bits, erfinv is torch's.
    Normals agree to 16 ulps (measured 7); the normalized directions, the
    ball, hemisphere and disk points to 4e-6 absolute (measured 1.7e-6, on
    components near zero, where an ulp of the normal is many of theirs)."""
    k, ours = jax.random.key(5), threefry.key(5)
    assert _ulps(sampling.normal(ours, (1000,)).numpy(), np.asarray(jax.random.normal(k, (1000,)))).max() <= 16
    lanes = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.arange(1024))
    pairs = [
        (sampling.unit_vector_b(_lanes(lanes)), jax_sampling.unit_vector_b(lanes)),
        (sampling.in_unit_disk_b(_lanes(lanes)), jax_sampling.in_unit_disk_b(lanes)),
        (sampling.random_unit_vector(ours, (300,)), jax_sampling.random_unit_vector(k, (300,))),
        (sampling.random_in_unit_sphere(ours, (300,)), jax_sampling.random_in_unit_sphere(k, (300,))),
        (sampling.random_in_unit_disk(ours, (300,)), jax_sampling.random_in_unit_disk(k, (300,))),
    ]
    normals = np.asarray(jax_sampling.random_unit_vector(jax.random.key(9), (300,)))
    pairs.append((sampling.random_on_hemisphere(ours, torch.from_numpy(normals.copy())),
                  jax_sampling.random_on_hemisphere(k, jnp.asarray(normals))))
    for i, (a, b) in enumerate(pairs):
        assert a.shape == tuple(b.shape), i
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 4e-6, i
