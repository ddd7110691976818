"""The backward's fixed-order reduction on the CPU: `_reduce_events_ordered`
(the order of `build.grad_reduce`) against a numpy float32 left fold
written event by event, against `_reduce_events_plain` (index_add), and the
reduction kernel's walk (`csrc/grad_kernel.cu`: staged events, spheres
owned by warps, each warp's events of a stage listed by ballots and split
by its hot sphere, per-row folds, the fold over chunks in rounds) emulated in numpy, bit for bit.

The events are synthetic (`probes.synthetic_events`, numpy seeds): four
chunks with a ragged last one, chunk 1 mostly one sphere's, -1 and
out-of-range winners, -0.0 words. The card holds the kernel to the same
order in tests/test_torch_cuda.py and chip_smoke.py phase 7.
"""

import numpy as np
import pytest
import torch

from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
from ray_tracing_in_one_weekend_tpu_torch.probes import synthetic_events

N_EVENTS = 3 * cg.CHUNK_EVENTS + 1500  # four chunks, the last ragged
N_SPHERES = 37


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy()


@pytest.fixture(scope="module")
def events():
    return synthetic_events(N_EVENTS, N_SPHERES, seed=0)


def _left_fold(ev: np.ndarray, n_spheres: int) -> np.ndarray:
    """The contract, event by event in numpy float32: each chunk's partial
    from +0 in increasing event index, then the chunks in order."""
    chunk = cg.CHUNK_EVENTS
    n_chunks = -(-ev.shape[0] // chunk)
    partial = np.zeros((n_chunks, 13, n_spheres), dtype=np.float32)
    winner = ev[:, 0].view(np.int32)
    for e in range(ev.shape[0]):
        w = int(winner[e])
        if 0 <= w < n_spheres:
            partial[e // chunk, :, w] = partial[e // chunk, :, w] + ev[e, 1:14]
    total = np.zeros((13, n_spheres), dtype=np.float32)
    for c in range(n_chunks):
        total = total + partial[c]
    out = np.zeros((16, n_spheres), dtype=np.float32)
    out[list(cg._EVENT_ROWS)] = total
    return out


def test_synthetic_events_reach_every_case(events):
    winner = _bits(events)[:, 0]
    assert -(-events.shape[0] // cg.CHUNK_EVENTS) == 4 and events.shape[0] % cg.CHUNK_EVENTS
    assert (winner == -1).any() and ((winner >= N_SPHERES) | (winner < -1)).any()
    heavy = winner[cg.CHUNK_EVENTS : 2 * cg.CHUNK_EVENTS]
    assert (heavy == N_SPHERES - 1).mean() > 0.75
    words = _bits(events)[:, 1:14]
    assert (words == np.int32(-(2**31))).any()  # -0.0
    assert not _bits(events)[:, 14:].any()


@pytest.mark.parametrize("n_spheres", [N_SPHERES, 1])
def test_ordered_equals_numpy_left_fold(events, n_spheres):
    """Bit for bit, for 37 spheres and for one (nearly every winner out of
    range then)."""
    got = cg._reduce_events_ordered(events, n_spheres)
    want = _left_fold(events.numpy(), n_spheres)
    np.testing.assert_array_equal(_bits(got), want.view(np.int32))


def test_ordered_within_1e5_of_index_add(events):
    """Only the summation order differs from index_add: within 1e-5
    relative L2 (the events span six decades, so some sums cancel)."""
    got = cg._reduce_events_ordered(events, N_SPHERES).double()
    plain = cg._reduce_events_plain(events, N_SPHERES).double()
    assert float((got - plain).norm() / plain.norm()) <= 1e-5


def test_empty_events_give_positive_zeros():
    out = cg._reduce_events_ordered(torch.zeros(0, 16), N_SPHERES)
    assert out.shape == (16, N_SPHERES)
    assert not _bits(out).any()  # +0.0 everywhere, no -0.0


def test_out_of_range_winners_add_nothing(events):
    """Winners outside [0, N) give the bits of the same events with -1
    winners; rows 4, 10 and 11 are +0."""
    fixed = events.clone()
    w = fixed[:, 0].contiguous().view(torch.int32)
    fixed.view(torch.int32)[:, 0] = torch.where((w >= 0) & (w < N_SPHERES), w, -1)
    assert not torch.equal(fixed.view(torch.int32)[:, 0], events.view(torch.int32)[:, 0])
    out = cg._reduce_events_ordered(events, N_SPHERES)
    np.testing.assert_array_equal(_bits(out), _bits(cg._reduce_events_ordered(fixed, N_SPHERES)))
    assert not _bits(out)[[4, 10, 11]].any()
    assert _bits(out)[list(cg._EVENT_ROWS)].any()


def _kernel_walk(ev: np.ndarray, n_spheres: int) -> np.ndarray:
    """grad_reduce_chunks then grad_reduce_partials as the kernels walk the
    events (row-lane fold): per chunk, stages of STAGE_EVENTS; warp w owns
    the spheres s % REDUCE_WARPS == w, lists its own events of the stage in
    index order, split into those of its hot sphere and the others, and
    adds the others and then the hot ones, keeping the sphere it adds to
    in registers and the others' accumulators in shared memory; the next
    stage's hot sphere is the first other event's when the others were
    more. Then each output adds the chunks' partials in rounds of
    FOLD_ROUND, in order. (Which warp owns a sphere, and the batches in
    which a warp loads its events, change no add's operands or order.) The warps own disjoint spheres, so their
    interleaving does not matter: this walks them one after another."""
    chunk, stage = cg.CHUNK_EVENTS, cg.REDUCE_STAGE_EVENTS
    warps, fold_round = cg.REDUCE_WARPS, cg.REDUCE_FOLD_ROUND
    n_chunks = -(-ev.shape[0] // chunk)
    winner = ev[:, 0].view(np.int32)
    partials = np.zeros((max(n_chunks, 1), 13, n_spheres), dtype=np.float32)
    for c in range(n_chunks):
        acc = np.zeros((n_spheres, 13), dtype=np.float32)
        n = min(chunk, ev.shape[0] - c * chunk)
        for warp in range(warps):
            cur, a, hot = -1, None, -1  # the sphere in registers, its rows

            def add(w, v):
                nonlocal cur, a
                if w != cur:
                    if cur >= 0:
                        acc[cur] = a
                    cur, a = w, acc[w].copy()
                a = a + v

            for e0 in range(0, n, stage):
                m = min(stage, n - e0)
                base = c * chunk + e0
                # The warp's own events of the stage in index order, split
                # into the hot sphere's and the others'; the others are
                # added first, then the hot ones.
                mine = [i for i in range(m) if 0 <= winner[base + i] < n_spheres and winner[base + i] % warps == warp]
                hot_list = [i for i in mine if winner[base + i] == hot]
                other = [i for i in mine if winner[base + i] != hot]
                for i in other + hot_list:
                    add(int(winner[base + i]), ev[base + i, 1:14])
                if len(other) > len(hot_list):
                    hot = int(winner[base + other[0]])
            if cur >= 0:
                acc[cur] = a
        partials[c] = acc.T
    total = np.zeros((13, n_spheres), dtype=np.float32)
    for c0 in range(0, n_chunks, fold_round):
        for c in range(c0, min(c0 + fold_round, n_chunks)):
            total = total + partials[c]
    out = np.zeros((16, n_spheres), dtype=np.float32)
    out[list(cg._EVENT_ROWS)] = total
    return out


@pytest.mark.parametrize("n_spheres", [N_SPHERES, 1])
def test_kernel_walk_equals_ordered(events, n_spheres):
    """The kernel's design, emulated, gives `_reduce_events_ordered`'s bits
    (the order the card tests and chip_smoke.py then hold the kernel to)."""
    want = cg._reduce_events_ordered(events, n_spheres)
    np.testing.assert_array_equal(_kernel_walk(events.numpy(), n_spheres).view(np.int32), _bits(want))
