"""Elastic recovery: batch-grain retry on device failure.

The PyTorch counterpart of ray_tracing_in_one_weekend_tpu/utils/resilient.py.
The reference's only failure handling is fail-stop: `checkCudaErrors`
prints and exits (reference: src/gpu/cuda_utility.h:8-18). This module
re-renders a failed batch instead, on the checkpoint accumulator's
algebra (utils/checkpoint.py): every sample draws from a stream keyed by
the GLOBAL (pixel, sample) index, so a batch re-rendered on the same
device through the same kernel covers the same samples, and the final
image is bit-identical to an unfailed run. `accumulate` returns a new
state, so a batch that raises or returns non-finite pixels leaves the
previous `RenderState` untouched.

Failure model: transient device faults, and data corruption surfacing as
non-finite pixels. Deterministic failures (a bug) exhaust the retry
budget and re-raise: fail-stop remains the backstop. A retry never
switches to the plain version or to the CPU, and a non-finite pixel is
never clamped or zeroed: it raises.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field

import torch

from ray_tracing_in_one_weekend_tpu_torch.utils import checkpoint as ckpt


@dataclass
class RetryStats:
    """Recovery telemetry for one resilient render."""

    batches: int = 0
    retries: int = 0
    failures: list = field(default_factory=list)  # (batch_start, kind, detail)


class BatchCorruptError(RuntimeError):
    """A rendered batch contained non-finite pixels."""


class CheckpointCorruptError(RuntimeError):
    """A LOADED checkpoint contained non-finite pixels. Re-rendering
    batches can never fix this; delete or re-create the checkpoint."""


def validate_state(state: ckpt.RenderState) -> None:
    """Guard a freshly loaded checkpoint once, with a distinct error: a NaN
    inherited from disk would otherwise make every batch retry fail with a
    misleading 'corrupt batch' message."""
    if not bool(torch.isfinite(state.accum).all()):
        raise CheckpointCorruptError(
            "non-finite pixels in LOADED checkpoint state — delete the "
            "checkpoint file and re-render"
        )


def _validate(new_state: ckpt.RenderState, prev: ckpt.RenderState) -> None:
    # Only the NEW batch's contribution is checked: prev.accum was checked
    # at load time (validate_state) or by the batch that made it, so a
    # non-finite delta implicates this batch and a retry is the remedy.
    delta = new_state.accum - prev.accum
    if not bool(torch.isfinite(delta).all()):
        raise BatchCorruptError("non-finite pixels in rendered batch")


def with_retries(attempt, check, *, max_retries: int, what: str, log, stats: RetryStats | None = None,
                 at: int = 0, delay_s: float = 0.0):
    """`attempt()`, then `check(result)`, up to 1 + max_retries times ->
    the first result that passes its check.

    Any exception of either counts as a failure: it is logged as `what`
    failed, recorded in `stats` (at sample `at`), and followed by a pause
    of `delay_s` and another attempt while the budget lasts. Raises the
    last error when the budget is exhausted.
    """
    last_err = None
    for k in range(1 + max_retries):
        try:
            result = attempt()
            check(result)
            return result
        except Exception as e:  # noqa: BLE001 — retry any device fault
            last_err = e
            if stats is not None:
                stats.retries += 1
                stats.failures.append((at, type(e).__name__, str(e)[:200]))
            log(
                f"{what} failed ({type(e).__name__}: {str(e)[:120]}) — retry {k + 1}/{max_retries}"
                if k < max_retries
                else f"{what} failed after {max_retries} retries — failing stop"
            )
            if k < max_retries and delay_s:
                time.sleep(delay_s)
    raise last_err


def accumulate_resilient(
    state: ckpt.RenderState,
    scene,
    cam,
    seed: int,
    spp_batch: int,
    *,
    max_retries: int = 2,
    stats: RetryStats | None = None,
    retry_delay_s: float = 0.0,
    log=None,
    **accumulate_kw,
) -> ckpt.RenderState:
    """`checkpoint.accumulate` with batch-grain retry.

    Attempts the batch up to 1 + max_retries times, `retry_delay_s` apart;
    each attempt re-renders the SAME global sample window
    [spp_done, spp_done+batch), so a successful retry is indistinguishable
    from never having failed. Raises the last error when the budget is
    exhausted.
    """
    new_state = with_retries(
        lambda: ckpt.accumulate(state, scene, cam, seed, spp_batch, **accumulate_kw),
        lambda new: _validate(new, state),
        max_retries=max_retries,
        what=f"resilient: batch at spp={state.spp_done}",
        log=log or (lambda *a: print(*a, file=sys.stderr, flush=True)),
        stats=stats,
        at=state.spp_done,
        delay_s=retry_delay_s,
    )
    if stats is not None:
        stats.batches += 1
    return new_state


def render_resilient(
    scene,
    cam,
    seed: int,
    spp: int | None = None,
    spp_batch: int | None = None,
    *,
    max_retries: int = 2,
    checkpoint_path: str | None = None,
    stats: RetryStats | None = None,
    log=None,
    **accumulate_kw,
) -> torch.Tensor:
    """Full render with batch-grain elastic recovery -> [H, W, 3] on the
    scene's device.

    Optionally persists each completed batch to `checkpoint_path`, so even
    a process-killing failure resumes from the last good batch on the next
    invocation (process-grain elasticity on top of the in-process batch
    retries). With a `mesh` among the keywords every rank loads the file,
    and rank 0 alone saves it. A non-finite batch is seen by every rank (the
    image is gathered), so all ranks retry it together; an exception on one
    rank alone leaves the others waiting in the next collective until the
    process group's timeout.
    """
    spp = cam.samples_per_pixel if spp is None else spp
    spp_batch = spp_batch or max(1, spp // 10)

    mesh = accumulate_kw.get("mesh")
    if checkpoint_path and os.path.exists(checkpoint_path):
        state = ckpt.load(checkpoint_path, device=scene.device)
        validate_state(state)
    else:
        state = ckpt.new_state(cam, device=scene.device)
    if mesh is not None:
        mesh.barrier()  # every rank has read the file before rank 0 writes it

    while state.spp_done < spp:
        n = min(spp_batch, spp - state.spp_done)
        state = accumulate_resilient(
            state, scene, cam, seed, n,
            max_retries=max_retries, stats=stats, log=log, **accumulate_kw,
        )
        if checkpoint_path and (mesh is None or mesh.rank == 0):
            ckpt.save(state, checkpoint_path)
    return state.image
