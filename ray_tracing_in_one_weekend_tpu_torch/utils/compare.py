"""Comparisons of two renders of the same streams: lane states and images.

Two correct implementations of the render agree to float32 rounding per
bounce, not bitwise: a last-ulp difference (an FMA, a sin or rsqrt
rounded differently) is amplified along a path by every bounce off a
small sphere, and now and then flips a discrete decision. So a lane is
either equal to rounding or "flipped", and the checks are the flipped
fraction plus block means of the radiance, where Monte-Carlo noise
averages out and a real bug (a wrong select, a broken stream, a bad
normal) shifts whole blocks. The block thresholds (MAD < 0.02, mean
difference < 0.01) are those of the JAX package's compiled-vs-interpreted
mode check (bench.py).
"""

from __future__ import annotations

import dataclasses

import torch

from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr

# Lanes whose radiance differs by more than this count as flipped.
FLIP_ATOL = 1e-4
BLOCK_MAD_MAX = 0.02
MEAN_DIFF_MAX = 0.01


@dataclasses.dataclass(frozen=True)
class Agreement:
    flipped_frac: float  # lanes (pixels) off by more than the tolerance
    max_abs_err: float  # largest per-lane (per-pixel) difference
    block_mad: float  # mean |difference| of block means
    block_max_err: float  # largest |difference| of block means
    mean_diff: float  # |difference| of the overall means

    @property
    def blocks_agree(self) -> bool:
        return self.block_mad < BLOCK_MAD_MAX and self.mean_diff < MEAN_DIFF_MAX


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    n = x.shape[0] // block * block
    return x[:n].reshape(-1, block).mean(dim=1)


def lane_states(of_a, oi_a, of_b, oi_b, n_lanes, spp, depth_rows="all", block=256) -> Agreement:
    """Compare two lane states ([SF_ROWS, P] f32, [SI_ROWS, P] i32) over the
    first `n_lanes` lanes. A lane is flipped when an integer row (pixel,
    samples started, stream words, busy, depth) differs or a radiance
    channel differs by more than FLIP_ATOL. `depth_rows="busy"` compares
    depth on busy lanes only: a finished lane's depth is layout-dependent
    in the JAX kernel (see ops/cuda_render.py)."""
    of_a, oi_a, of_b, oi_b = (t[:, :n_lanes].cpu() for t in (of_a, oi_a, of_b, oi_b))
    rows = [cr._SI_PIX, cr._SI_STARTED, cr._SI_STREAM, cr._SI_STREAM2, cr._SI_BUSY]
    int_diff = (oi_a[rows] != oi_b[rows]).any(dim=0)
    depth_diff = oi_a[cr._SI_DEPTH] != oi_b[cr._SI_DEPTH]
    if depth_rows == "busy":
        depth_diff &= oi_a[cr._SI_BUSY] > 0
    rad_a = of_a[cr._SF_RAD : cr._SF_RAD + 3].double()
    rad_b = of_b[cr._SF_RAD : cr._SF_RAD + 3].double()
    err = (rad_a - rad_b).abs().amax(dim=0)
    flipped = int_diff | depth_diff | (err > FLIP_ATOL)
    lane_a = rad_a.mean(dim=0) / spp
    lane_b = rad_b.mean(dim=0) / spp
    block_err = (_blocks(lane_a, block) - _blocks(lane_b, block)).abs()
    return Agreement(
        flipped_frac=float(flipped.double().mean()),
        max_abs_err=float(err.max()),
        block_mad=float(block_err.mean()),
        block_max_err=float(block_err.max()),
        mean_diff=float((lane_a.mean() - lane_b.mean()).abs()),
    )


def images(img_a, img_b, block=10, atol=1e-3) -> Agreement:
    """Compare two [H, W, 3] images: pixels off by more than `atol`, and
    the means of `block` x `block` pixel blocks (of the channel mean)."""
    a, b = img_a.detach().cpu().double(), img_b.detach().cpu().double()
    err = (a - b).abs().amax(dim=2)
    h, w = a.shape[0] // block * block, a.shape[1] // block * block

    def block_means(x):
        x = x[:h, :w].mean(dim=2)
        return x.reshape(h // block, block, w // block, block).mean(dim=(1, 3))

    block_err = (block_means(a) - block_means(b)).abs()
    return Agreement(
        flipped_frac=float((err > atol).double().mean()),
        max_abs_err=float(err.max()),
        block_mad=float(block_err.mean()),
        block_max_err=float(block_err.max()),
        mean_diff=float((a.mean() - b.mean()).abs()),
    )


def grid_mad(img_a, img_b, grid=(12, 6)) -> float:
    """Mean |difference| of two [H, W, 3] images' block means on a `grid`
    of (blocks across, blocks down), per channel: the statistic of the
    JAX package's milestone tests (tests/test_milestones.py), where
    Monte-Carlo noise averages out and a shading fault shifts blocks."""
    gw, gh = grid

    def blocks(x):
        x = torch.as_tensor(x).detach().cpu().double()
        bh, bw = x.shape[0] // gh, x.shape[1] // gw
        return x[: gh * bh, : gw * bw].reshape(gh, bh, gw, bw, 3).mean(dim=(1, 3))

    return float((blocks(img_a) - blocks(img_b)).abs().mean())
