"""Render the gallery's presets and hold them against the reference's own
image and against the TPU's renders.

    python -m ray_tracing_in_one_weekend_tpu_torch.scripts.render_gallery [preset ...]
        [--spp N] [--out DIR]

The counterpart of the JAX package's scripts/render_gallery.py, for the
four reference presets (default all: cpu, gpu, gpu-old, cpu-mt), each
rendered by `render_artifact.render_preset` on the scene of the TPU
gallery's render (`jax_scene`) under render seed 0:

* the `cpu` preset (1200x800, aperture 0.1, 500 spp, depth 50,
  reference: src/cpu/main.cc:82-99) on the reference's exact scene,
  against the reference cpu_ray_tracer's own render
  (tests/goldens/ref_cpu_cover_1200x800_500spp.png): two independent
  500-sample estimates of the same pixels, held to the gates of
  tests/test_golden_fullres.py:56-58 (MAD < 2.5, p99 <= 25, max <= 220
  8-bit levels);
* every preset against the TPU's render of the same preset, size and spp
  in `gallery/` (found by its MANIFEST.json), which the JAX package's
  Pallas kernel drew on the same PCG streams. So the port's render must
  lie far closer to it than an independent render does: the preset is
  rendered again under render seed 1, and `noise` = MAD(seed 0, seed 1).
  The gate: MAD(seed 0, TPU) < TPU_GATE x noise, while MAD(seed 1, TPU),
  the wrong pairing, must reach it.

Statistics are in 8-bit levels over every channel of every pixel. The
card has no PIL: the PNGs are read by `utils/png.read_png`. The
images and their MANIFEST.json go to `--out` (default `build/gallery/`);
`gallery/` stays the JAX package's. Exit 1 when a gate fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

from ray_tracing_in_one_weekend_tpu_torch.scripts import render_artifact
from ray_tracing_in_one_weekend_tpu_torch.utils import manifest
from ray_tracing_in_one_weekend_tpu_torch.utils.png import read_png

GALLERY_PRESETS = ("cpu", "gpu", "gpu-old", "cpu-mt")
GOLDEN = os.path.join(manifest.repo_root(), "tests", "goldens", "ref_cpu_cover_1200x800_500spp.png")
TPU_GALLERY = os.path.join(manifest.repo_root(), "gallery")
# tests/test_golden_fullres.py:56-58: the TPU's render against the golden
# measured MAD 1.91, p99 19, max 159; the bounds sit ~30% above.
GOLDEN_GATES = {"mad": 2.5, "p99": 25.0, "max": 220.0}
# The port's render against the TPU's, as a fraction of the distance
# between two independent renders on the port.
TPU_GATE = 0.5


@dataclasses.dataclass(frozen=True)
class Stats:
    """|a - b| over every channel of every pixel, in 8-bit levels."""

    mad: float
    p50: float
    p99: float
    p999: float
    max: float
    equal: float  # share of pixels whose three channels are equal
    bias: float  # mean of a - b: a brighter image is positive

    def line(self) -> str:
        return (f"MAD {self.mad:.4f}  p50 {self.p50:.0f}  p99 {self.p99:.0f}  p99.9 {self.p999:.0f}  "
                f"max {self.max:.0f}  equal pixels {self.equal:.4%}  bias {self.bias:+.4f}")


def image_stats(ours: np.ndarray, ref: np.ndarray) -> Stats:
    """The statistics of the JAX package's render_gallery.py:30-37 for two
    uint8 [H, W, 3] images, the share of pixels exactly equal and the mean
    signed difference."""
    if ours.shape != ref.shape:
        raise ValueError(f"images of shapes {ours.shape} and {ref.shape}")
    signed = ours.astype(np.int32) - ref.astype(np.int32)
    diff = np.abs(signed)
    p50, p99, p999 = np.percentile(diff, (50, 99, 99.9))
    return Stats(float(diff.mean()), float(p50), float(p99), float(p999), float(diff.max()),
                 float((diff.max(axis=-1) == 0).mean()), float(signed.mean()))


def golden_failures(stats: Stats) -> list:
    """The golden gates that `stats` (against the golden) misses: MAD below
    its gate, p99 and max at most theirs."""
    out = [] if stats.mad < GOLDEN_GATES["mad"] else [f"MAD {stats.mad:.4f} >= {GOLDEN_GATES['mad']:g}"]
    return out + [f"{k} {getattr(stats, k):g} > {GOLDEN_GATES[k]:g}" for k in ("p99", "max")
                  if getattr(stats, k) > GOLDEN_GATES[k]]


def tpu_render(entry: dict) -> str | None:
    """The TPU's render of the same preset, size and spp as the manifest
    `entry`, in the JAX package's gallery; None when it has none."""
    key = tuple(entry[k] for k in ("preset", "width", "height", "spp"))
    for name, e in sorted(manifest.load(TPU_GALLERY).items()):
        if e.get("backend") == "pallas-tpu" and tuple(e.get(k) for k in ("preset", "width", "height", "spp")) == key:
            return os.path.join(TPU_GALLERY, name)
    return None


@dataclasses.dataclass(frozen=True)
class PresetCheck:
    seed0: render_artifact.Artifact
    seed1: render_artifact.Artifact | None  # None without a TPU render
    tpu_path: str | None
    vs_golden: Stats | None  # the cpu preset at 500 spp
    vs_tpu: Stats | None  # seed 0 against the TPU's render
    seed1_vs_tpu: Stats | None  # the wrong pairing
    noise: float | None  # MAD(seed 0, seed 1)

    @property
    def failures(self) -> list:
        out = [f"golden: {f}" for f in (golden_failures(self.vs_golden) if self.vs_golden else [])]
        if self.vs_tpu is not None:
            if not self.vs_tpu.mad < TPU_GATE * self.noise:
                out.append(f"TPU: MAD {self.vs_tpu.mad:.4f} >= {TPU_GATE} x noise {self.noise:.4f}")
            if not self.seed1_vs_tpu.mad >= TPU_GATE * self.noise:
                out.append(f"TPU: the wrong pairing (seed 1) passes, MAD {self.seed1_vs_tpu.mad:.4f} < "
                           f"{TPU_GATE} x noise {self.noise:.4f}")
        return out


def check_preset(preset: str, spp: int | None = None, out_dir: str = render_artifact.OUT_DIR,
                 device="cuda", seed0: render_artifact.Artifact | None = None) -> PresetCheck:
    """Render `preset` on the TPU gallery's scene under render seed 0 (or
    take `seed0`, such a render), hold it against the golden (the cpu
    preset at 500 spp) and against the TPU's render with its seed-1 twin."""
    if seed0 is None:
        seed0 = render_artifact.render_preset(preset, spp, out_dir=out_dir, seed=0, device=device,
                                              jax_scene=True)
    vs_golden = None
    if (preset, seed0.entry["spp"]) == ("cpu", 500):
        vs_golden = image_stats(seed0.u8, read_png(GOLDEN))
    tpu_path = tpu_render(seed0.entry)
    if tpu_path is None:
        return PresetCheck(seed0, None, None, vs_golden, None, None, None)
    seed1 = render_artifact.render_preset(preset, seed0.entry["spp"], out_dir=out_dir, seed=1, device=device,
                                          jax_scene=True)
    tpu = read_png(tpu_path)
    return PresetCheck(seed0, seed1, tpu_path, vs_golden, image_stats(seed0.u8, tpu),
                       image_stats(seed1.u8, tpu), image_stats(seed0.u8, seed1.u8).mad)


def report(preset: str, c: PresetCheck) -> list:
    """The lines that say what `check_preset` found."""
    e = c.seed0.entry
    lines = [f"gallery[{preset}]: {e['width']}x{e['height']} {e['spp']} spp, {e['scene']}, "
             f"{e['render_seconds']:.3f}s ({e.get('mrays_per_s', float('nan')):.2f} Mrays/s steady) on "
             f"{e['card']}"]
    if c.vs_golden is not None:
        lines.append(f"gallery[{preset}] vs reference golden: {c.vs_golden.line()}")
    if c.vs_tpu is not None:
        lines.append(f"gallery[{preset}] vs TPU {os.path.basename(c.tpu_path)}: {c.vs_tpu.line()}; noise "
                     f"(seed 0 vs seed 1) MAD {c.noise:.4f}; seed 1 vs TPU MAD {c.seed1_vs_tpu.mad:.4f} "
                     f"(gate: seed 0 below {TPU_GATE} x noise, seed 1 not)")
    lines += [f"gallery[{preset}] FAILED {f}" for f in c.failures]
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("presets", nargs="*", default=list(GALLERY_PRESETS), help="default: all four")
    ap.add_argument("--spp", type=int, default=None, help="samples a pixel (default: the preset's, 500)")
    ap.add_argument("--out", default=render_artifact.OUT_DIR)
    args = ap.parse_args(argv)
    failed = False
    for preset in args.presets:
        c = check_preset(preset, args.spp, args.out)
        for line in report(preset, c):
            print(line, file=sys.stderr, flush=True)
        failed |= bool(c.failures)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
