"""The port's numpy utilities and 8-bit output against the JAX package.

Both packages are imported; data passes between them as numpy arrays.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tracing_in_one_weekend_tpu.ops.image import to_uint8 as jax_to_uint8
from ray_tracing_in_one_weekend_tpu.utils import ppm as jax_ppm
from ray_tracing_in_one_weekend_tpu_torch.ops.image import linear_to_gamma, to_uint8
from ray_tracing_in_one_weekend_tpu_torch.utils import ppm
from ray_tracing_in_one_weekend_tpu_torch.utils.reference_rng import (
    MT19937,
    ReferenceRandom,
)

torch.set_num_threads(2)


def test_mt19937_replica_first_draws():
    """First doubles of std::mt19937(5489) + uniform_real_distribution,
    the values of tests/test_golden.py (exact to 1e-15)."""
    rng = ReferenceRandom()
    expected = [
        0.1354770042967805,
        0.8350085899945795,
        0.96886777112423139,
        0.2210340429827049,
    ]
    for e in expected:
        assert abs(rng.random_double() - e) < 1e-15


def test_mt19937_first_words():
    """The 10000th output of a default-seeded std::mt19937 is 4123659995
    (C++11 [rand.predef])."""
    eng = MT19937()
    for _ in range(9999):
        eng.genrand()
    assert eng.genrand() == 4123659995


@pytest.mark.parametrize("encoder", ["native", "numpy"])
def test_ppm_bytes_identical_to_jax_package(encoder, monkeypatch):
    """The same uint8 image encodes to the same P3 bytes, whether through
    the native encoder or the numpy fallback, and round-trips."""
    if encoder == "numpy":
        monkeypatch.setattr(ppm, "_load_native", lambda: None)
    else:
        assert ppm._load_native() is not None, "native/libppm_encoder.so not found"
    img = np.random.default_rng(0).integers(0, 256, size=(7, 11, 3), dtype=np.uint8)
    ours = ppm.encode_p3(img)
    assert ours == jax_ppm.encode_p3(img)
    assert ours.startswith(b"P3\n11 7\n255\n")
    buf = io.BytesIO()
    ppm.write_ppm(img, buf)
    assert buf.getvalue() == ours
    np.testing.assert_array_equal(ppm.read_ppm(ours), img)


def test_to_uint8_equals_jax():
    """Gamma 2, clamp to [0, 0.999], x256, truncate: byte-equal to the JAX
    pipeline, including negative, zero, clamped and NaN-free edge values."""
    lin = np.random.default_rng(1).uniform(-0.2, 1.3, size=(9, 13, 3)).astype(np.float32)
    lin[0, 0] = [0.0, 0.998001, 1.0]
    ours = to_uint8(torch.from_numpy(lin)).numpy()
    assert ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, np.asarray(jax_to_uint8(jnp.asarray(lin))))
    np.testing.assert_array_equal(
        linear_to_gamma(torch.from_numpy(lin)).numpy(),
        np.sqrt(np.maximum(lin, 0.0)),
    )
