"""What the padding slots cost a milestone render on the card: each book
milestone at its own size (400x225, 100 spp, depth 50) through
`render_cuda`, warm, over its 128 slots and cut to its active ones
(`first_slots`; the sweep tests every slot, the function needs only the
active spheres), timed in turns.

    python -m ray_tracing_in_one_weekend_tpu_torch.probes.slot_padding [--rounds 5] [--names image16_hollow_glass_trio ...]

Both scenes of a milestone render the same bits (checked). Prints one line
a milestone: best and median seconds of `--rounds` rounds by the host
clock to a synchronize, and the ratio of the medians, with the card's
name and power limit. The sky alone (no active sphere) is left out: it
cannot be cut to zero slots.
"""

from __future__ import annotations

import argparse
import statistics
import time


def padding_times(name: str, rounds: int, device="cuda") -> dict:
    """{slots: (best s, median s)} for milestone `name` over its 128 slots
    and over its active ones, warm, in turns; raises if the bits differ."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.models import milestones as M
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
    from ray_tracing_in_one_weekend_tpu_torch.probes import first_slots

    scene, cam = M.milestone_render(name, device=device)
    scenes = {scene.num_slots: scene, scene.num_active: first_slots(scene, scene.num_active)}
    images = {k: cr.render_cuda(sc, cam) for k, sc in scenes.items()}  # fills each cache entry
    if not torch.equal(*images.values()):
        raise RuntimeError(f"{name}: the scene cut to its active slots renders other bits")
    times = {k: [] for k in scenes}
    for _ in range(rounds):
        for k, sc in scenes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cr.render_cuda(sc, cam)
            torch.cuda.synchronize()
            times[k].append(time.perf_counter() - t0)
    return {k: (min(ts), statistics.median(ts)) for k, ts in times.items()}


def main(argv=None) -> int:
    from ray_tracing_in_one_weekend_tpu_torch.models import milestones as M
    from ray_tracing_in_one_weekend_tpu_torch.probes import nvidia_smi

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--names", nargs="*", default=[n for n in M.MILESTONE_RENDERS if n != "image2_sky"])
    args = ap.parse_args(argv)
    smi = nvidia_smi()
    for name in args.names:
        t = padding_times(name, args.rounds)
        (full, (fb, fm)), (cut, (cb, cm)) = t.items()
        print(f"{name}: {full} slots best {fb:.5f}s median {fm:.5f}s; {cut} slots best {cb:.5f}s "
              f"median {cm:.5f}s; {fm / cm:.2f}x; the same bits [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
