"""Spans of the port's layers on the profiler's clock.

Each layer marks the host time it spends with `span(name)` (a context
manager) or `spanned(name)` (a decorator over a whole function), and every
call that blocks the host until the card's stream drains with
`sync(site)`: a device->host read (`.cpu()`, `.tolist()`, `.item()`,
`int()` of a device tensor), a host->device copy from pageable memory, or
a synchronize. So an idle gap of the card in a profiler trace can be put
down to the sync, the port's other host code, or the caller around it.

A span is a FUNCTION-scope record of torch.profiler
(`torch._C._profiler._RecordFunctionFast`): it appears among the trace's
host events, with its name and nothing else, and not on the device's
timeline, so it changes no device reading of the trace. While no profiler
runs, a span costs one check of the profiler's flag: no record, no
allocation, no device call. The operator's `--profile` chrome trace shows
the spans too.

`SPANS` is every name the port emits; the names of the sync spans are
`rt.sync.<site>`, and their count in a trace is the port's count of host
syncs.
"""

from __future__ import annotations

import contextlib
import functools

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

SYNC_PREFIX = "rt.sync."

SPANS = (
    # Accumulation and output: utils/checkpoint.py, ops/image.py.
    "rt.accumulate",
    "rt.to_uint8",
    # The lane scheduler: ops/cuda_render.py.
    "rt.sched.render",
    "rt.sched.pass",
    "rt.sched.compact",
    "rt.sched.cache_fill",
    # The keyed render and the keyed train step: ops/render.py,
    # parallel/dist.py, ops/cuda_threefry.py.
    "rt.keyed.render",
    "rt.train_step",
    "rt.keyed.forward",
    "rt.keyed.backward",
    "rt.keyed.record",
    "rt.keyed.grad_pass",
    # Host syncs.
    SYNC_PREFIX + "cam_pack",  # each number `pack_camera` writes into the card's camera vector
    SYNC_PREFIX + "cam_key",  # the warm cache's key reads the camera vector
    SYNC_PREFIX + "arena_total",  # the keyed backward reads the sweeps made and the events' count
    SYNC_PREFIX + "replay_work",  # the PCG replay checks the work map holds whole counts
    SYNC_PREFIX + "replay_events",  # the PCG replay sizes its records
    SYNC_PREFIX + "replay_flags",  # the PCG replay reads its divergence flags
    SYNC_PREFIX + "mesh",  # a mesh collective's synchronizes
    SYNC_PREFIX + "checkpoint_save",  # the state's copy to the host for its file
)


# The span while no profiler runs: enters and leaves, records nothing.
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records the span `name` while torch.profiler
    runs, and does nothing otherwise."""
    return _RecordFunctionFast(name) if _profiler._is_profiler_enabled else _OFF


def sync(site: str):
    """`span("rt.sync.<site>")`: around a call that blocks the host until
    the stream drains."""
    return _RecordFunctionFast(SYNC_PREFIX + site) if _profiler._is_profiler_enabled else _OFF


def spanned(name: str):
    """A decorator: every call of the function is the span `name`."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _RecordFunctionFast(name):
                return fn(*args, **kwargs)

        return call

    return wrap
