"""Elastic recovery in the port (utils/resilient.py): fault injection.

The port's counterpart of tests/test_resilient.py. Transient faults (a
raised device error; a NaN-corrupted batch) are injected into the render
that `checkpoint.accumulate` calls, and the recovered image must be
BIT-IDENTICAL to a fault-free batched run: a re-rendered batch covers the
same global sample window through the same render.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.models.camera import make_camera
from ray_tracing_in_one_weekend_tpu_torch.utils import checkpoint as ckpt
from ray_tracing_in_one_weekend_tpu_torch.utils.resilient import (
    BatchCorruptError,
    CheckpointCorruptError,
    RetryStats,
    accumulate_resilient,
    render_resilient,
)

torch.set_num_threads(2)

SEED = 0
TARGET = "ray_tracing_in_one_weekend_tpu_torch.utils.checkpoint.render_cuda"


def _cam(spp=8):
    return make_camera(image_width=32, aspect_ratio=2.0, samples_per_pixel=spp, max_depth=4,
                       vfov_degrees=90.0, lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0),
                       defocus_angle_degrees=0.0, focus_dist=1.0, device="cpu")


class _Flaky:
    """Wraps the batch render; fails on chosen (0-indexed) calls."""

    def __init__(self, real, fail_calls, kind="raise"):
        self.real = real
        self.fail_calls = set(fail_calls)
        self.kind = kind
        self.calls = 0

    def __call__(self, *a, **kw):
        i = self.calls
        self.calls += 1
        if i in self.fail_calls:
            if self.kind == "raise":
                raise RuntimeError("injected transient device fault")
            colors, work = self.real(*a, **kw)
            colors = colors.clone()
            colors[0, 0, 0] = float("nan")  # corrupt one pixel
            return colors, work
        return self.real(*a, **kw)


@pytest.fixture(scope="module")
def scene():
    return scene_lib.single_sphere_scene(pad_to=128, device="cpu")


@pytest.fixture(scope="module")
def golden(scene):
    """Fault-free resilient render with the batch schedule of the faulty
    runs. A monolithic render agrees to float tolerance only (each batch
    boundary re-associates the sum), so the bit-level oracle is the batched
    run itself."""
    cam = _cam()
    img = render_resilient(scene, cam, SEED, spp_batch=2, log=lambda *a: None)
    mono = ckpt.render_cuda(scene, cam, seed=SEED)
    np.testing.assert_allclose(img.numpy(), mono.numpy(), atol=1e-6)
    return img


@pytest.mark.parametrize("kind", ["raise", "nan"])
def test_transient_fault_recovered_bit_identical(scene, golden, kind, monkeypatch):
    flaky = _Flaky(ckpt.render_cuda, fail_calls={1, 2}, kind=kind)
    monkeypatch.setattr(TARGET, flaky)
    stats = RetryStats()
    img = render_resilient(scene, _cam(), SEED, spp_batch=2, max_retries=2, stats=stats,
                           log=lambda *a: None)
    assert stats.retries == 2 and stats.batches == 4
    assert {k for _, k, _ in stats.failures} == (
        {"RuntimeError"} if kind == "raise" else {BatchCorruptError.__name__})
    assert torch.equal(img, golden), "recovered image must be bit-identical to the fault-free run"


def test_retry_budget_exhaustion_fails_stop(scene, monkeypatch):
    # Deterministic failure: every attempt of batch 1 fails.
    monkeypatch.setattr(TARGET, _Flaky(ckpt.render_cuda, fail_calls={1, 2, 3}, kind="raise"))
    with pytest.raises(RuntimeError, match="injected"):
        render_resilient(scene, _cam(), SEED, spp_batch=2, max_retries=2, log=lambda *a: None)


def test_process_grain_resume_after_crash(scene, golden, tmp_path, monkeypatch):
    """A failure that exhausts retries (process death analogue) resumes from
    the checkpoint on the next invocation, and the final image is still
    bit-identical to the fault-free run."""
    path = str(tmp_path / "resume.npz")
    real = ckpt.render_cuda
    monkeypatch.setattr(TARGET, _Flaky(real, fail_calls={2}, kind="raise"))
    with pytest.raises(RuntimeError):
        render_resilient(scene, _cam(), SEED, spp_batch=2, max_retries=0, checkpoint_path=path,
                         log=lambda *a: None)
    assert ckpt.load(path, device="cpu").spp_done == 4
    # "Restarted process": the renderer healed, resume from the checkpoint.
    monkeypatch.setattr(TARGET, real)
    img = render_resilient(scene, _cam(), SEED, spp_batch=2, checkpoint_path=path,
                           log=lambda *a: None)
    assert torch.equal(img, golden)


def test_nan_checkpoint_raises_and_is_never_retried(scene, tmp_path, monkeypatch):
    """A NaN loaded from disk raises CheckpointCorruptError before any batch
    renders: re-rendering batches cannot repair it, and nothing zeroes it."""
    state = ckpt.new_state(_cam(), device="cpu")
    accum = state.accum.clone()
    accum[3, 5, 1] = float("nan")
    path = str(tmp_path / "bad.npz")
    ckpt.save(ckpt.RenderState(accum, 2), path)
    flaky = _Flaky(ckpt.render_cuda, fail_calls=())
    monkeypatch.setattr(TARGET, flaky)
    with pytest.raises(CheckpointCorruptError, match="LOADED"):
        render_resilient(scene, _cam(), SEED, spp_batch=2, max_retries=3, checkpoint_path=path,
                         log=lambda *a: None)
    assert flaky.calls == 0


@pytest.mark.parametrize("fail_calls, recovers", [({0, 1}, True), ({0, 1, 2}, False)])
def test_retry_delay_pauses_between_attempts_only(scene, fail_calls, recovers, monkeypatch):
    """retry_delay_s: one pause after each failed attempt that has another
    to follow, none after the last; the recovered batch is the bits of an
    unfailed one."""
    from ray_tracing_in_one_weekend_tpu_torch.utils import resilient

    cam, pauses = _cam(), []
    monkeypatch.setattr(resilient.time, "sleep", pauses.append)
    want = ckpt.accumulate(ckpt.new_state(cam, device="cpu"), scene, cam, SEED, 2)
    monkeypatch.setattr(TARGET, _Flaky(ckpt.render_cuda, fail_calls=fail_calls, kind="raise"))
    stats = RetryStats()

    def run():
        return accumulate_resilient(ckpt.new_state(cam, device="cpu"), scene, cam, SEED, 2,
                                    max_retries=2, stats=stats, retry_delay_s=0.25,
                                    log=lambda *a: None)

    if recovers:
        assert torch.equal(run().accum, want.accum) and stats.batches == 1
    else:
        with pytest.raises(RuntimeError, match="injected"):
            run()
        assert stats.batches == 0
    assert pauses == [0.25, 0.25] and stats.retries == len(fail_calls)
