"""The render mixes: final renders and a progressive viewer, both through
`utils.checkpoint.accumulate`.

`final`: each render is the configuration's samples_per_pixel samples as
accumulate calls of `batch_spp` on a fresh state, with a render seed drawn
from --seed; a frame is one call, ended by a synchronize, and a render's
last frame also carries its 8-bit image to the host.

`preview`: a frame is one accumulate call of the configuration's
samples_per_pixel, the next sample window of the current pose, ended by
its 8-bit image on the host. The poses are a fixed multiset (hold
frames, yaw about the look-at point) drawn from the mix's `path_seed`;
--seed orders them and draws each pose's render seed.

The check renders, with the plain reference, a seeded sample of pixels of
a seeded sample of the window's finished answers (reservoir sampling over
the renders or frames) and compares the linear means, the 8-bit bytes
and the sweeps of the last call at those pixels: on the PCG backend the
work map the timed call returned, on the jnp backend (whose call returns
none) the kernel's own count of the same batch at the same pixels, made
again after the window. The pixels are drawn before the window, and a
kept answer keeps only them.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from rtbench import seeds
from rtbench.reference import common, keyed, pcg


def _yawed(config: dict, degrees: float) -> tuple:
    """The configuration's lookfrom turned by `degrees` about the vertical
    axis through lookat."""
    (fx, fy, fz), (ax, _, az) = config["lookfrom"], config["lookat"]
    a = math.radians(degrees)
    dx, dz = fx - ax, fz - az
    return (ax + dx * math.cos(a) + dz * math.sin(a), fy, az - dx * math.sin(a) + dz * math.cos(a))


def _gaps(out: dict, lin, u8, work, ref_lin, ref_work):
    """Add one answer's numbers to `out`: the mean absolute gap of the
    linear means, the share of 8-bit bytes that differ, and the relative
    gap of the sweeps' sum (where the call returned a work map)."""
    out.setdefault("pixel_mad", []).append(float((lin - ref_lin).abs().mean()))
    out.setdefault("u8_mismatch", []).append(float((u8 != common.to_uint8(ref_lin).cpu()).float().mean()))
    if work is not None:
        out.setdefault("work_gap", []).append(float((work.sum() - ref_work.sum()).abs() / ref_work.sum()))


class Driver:
    tail = "frame_ms_p95"

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.config, self.traffic, self.limits = cell.config, cell.traffic, cell.limits
        self.mode, self.backend = self.traffic["mode"], self.traffic["backend"]
        self.width, self.height = self.config["image_width"], self.config["image_height"]
        self.rng = np.random.default_rng(seeds.derive(self.seed, "check"))
        self.recording = False
        self.recorded = []

    # -- set-up ---------------------------------------------------------

    def _camera(self, lookfrom):
        c = self.config
        return self.port_camera(image_width=self.width, aspect_ratio=self.width / self.height,
                                samples_per_pixel=c["samples_per_pixel"], max_depth=c["max_depth"],
                                vfov_degrees=c["vfov_degrees"], lookfrom=lookfrom, lookat=tuple(c["lookat"]),
                                vup=tuple(c["vup"]), defocus_angle_degrees=c["defocus_angle_degrees"],
                                focus_dist=c["focus_dist"], device=self.device)

    def setup(self):
        from ray_tracing_in_one_weekend_tpu_torch.models.camera import make_camera
        from ray_tracing_in_one_weekend_tpu_torch.models.scene import scene_from_numpy
        from ray_tracing_in_one_weekend_tpu_torch.ops.image import to_uint8
        from ray_tracing_in_one_weekend_tpu_torch.utils import checkpoint

        if self.device.type == "cuda":
            from ray_tracing_in_one_weekend_tpu_torch.kernels import build

            build.load()
        self.setup_parts = {"kernels_loaded": time.perf_counter()}
        self.port_camera, self.to_uint8, self.ckpt = make_camera, to_uint8, checkpoint
        self.scene = scene_from_numpy(common.scene_arrays(), device=self.device)
        self.n_active, self.n_slots = self.scene.num_active, self.scene.num_slots
        spp = self.config["samples_per_pixel"]
        if self.mode == "final":
            self.batch = int(self.traffic["batch_spp"])
            if spp % self.batch:
                raise ValueError(f"samples_per_pixel {spp} is not a whole number of batches of {self.batch}")
            self.cam = self._camera(tuple(self.config["lookfrom"]))
            self.poses = None
        else:
            self.batch = spp
            prng = np.random.default_rng(int(self.traffic["path_seed"]))
            lo, hi = self.traffic["hold_frames"]
            yaw = float(self.traffic["yaw_degrees"])
            n = int(self.traffic["poses"])
            holds = prng.integers(lo, hi + 1, size=n)
            yaws = prng.uniform(-yaw, yaw, size=n)
            order = np.random.default_rng(seeds.derive(self.seed, "poses")).permutation(n)
            self.poses = [(int(holds[i]), float(yaws[i])) for i in order]
        # The pixels the check compares, one seeded sample for every answer.
        n_pix = self.width * self.height
        n_check = min(int(self.traffic["check_pixels"]), n_pix)
        self.check_pix = torch.tensor(np.sort(self.rng.choice(n_pix, size=n_check, replace=False)),
                                      device=self.device)
        # One frame of the cell's own shapes, on a render seed of its own (so
        # that no frame of the window finds its schedule cached), unchecked.
        self.answer, self.left, self.kept, self.seen = -2, 0, [], 0
        self.frame()
        self.to_uint8(self.state.image).cpu()
        self.answer = -1  # renders (final) or poses (preview) begun
        self.left = 0  # frames left in the current render or pose
        self.kept = []  # the reservoir of checked answers
        self.seen = 0  # answers offered to it

    # -- the window -----------------------------------------------------

    def _begin(self):
        self.answer += 1
        self.render_seed = seeds.derive(self.seed, "render", self.answer) % (1 << 31)
        if self.poses is not None:
            hold, yaw = self.poses[self.answer % len(self.poses)]
            self.lookfrom = _yawed(self.config, yaw)
            self.cam = self._camera(self.lookfrom)
            self.left = hold
        else:
            self.lookfrom = tuple(self.config["lookfrom"])
            self.left = self.config["samples_per_pixel"] // self.batch
        self.state = self.ckpt.new_state(self.cam, device=self.device)
        self.asked = 0  # samples this answer has asked for

    def frame(self) -> int:
        if self.left == 0:
            self._begin()
        self.state = self.ckpt.accumulate(self.state, self.scene, self.cam, self.render_seed, self.batch,
                                          backend=self.backend)
        self.left -= 1
        self.asked += self.batch
        if self.mode == "preview" or self.left == 0:
            self._offer(self.to_uint8(self.state.image).cpu())
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.recording:
            self.recorded.append(self.state.work if self.backend != "jnp"
                                 else (self.cam, self.render_seed, self.state.spp_done - self.batch))
        return self.width * self.height * self.batch

    def _offer(self, image):
        """Reservoir sampling of the finished answers, from the check's seed;
        a kept answer keeps only the checked pixels (the linear mean, the
        8-bit bytes, the last call's work), so no frame's buffers stay
        alive."""
        k = int(self.traffic["checked_answers"])
        self.seen += 1
        slot = len(self.kept) if len(self.kept) < k else int(self.rng.integers(0, self.seen))
        if slot >= k:
            return
        pix, state = self.check_pix, self.state
        answer = {"seed": self.render_seed, "lookfrom": self.lookfrom, "asked": self.asked,
                  "lin": (state.accum.reshape(-1, 3)[pix] / float(max(state.spp_done, 1))).float(),
                  "work": None if state.work is None else state.work.reshape(-1)[pix].double(),
                  "u8": image.reshape(-1, 3)[pix.cpu()]}
        if slot == len(self.kept):
            self.kept.append(answer)
        else:
            self.kept[slot] = answer

    # -- the traced run's counts ----------------------------------------

    def trace_counts(self, frames: int) -> dict:
        """The traced frames' sweeps (the sum of their work maps) and the
        sizes the readers need."""
        from ray_tracing_in_one_weekend_tpu_torch.kernels import build

        works = self.recorded[-frames:]
        if self.backend == "jnp":
            # The jnp path returns no work map: the kernel's own count of the
            # same batches, run again once the trace has closed.
            from ray_tracing_in_one_weekend_tpu_torch.ops.render import render_keyed

            launches = build.LAUNCHES["threefry_render_kernel"]
            pix = torch.arange(self.width * self.height, device=self.device)
            sweeps = sum(float(render_keyed(self.scene, cam, pix, seed, self.batch, offset,
                                            return_work=True)[1].double().sum()) for cam, seed, offset in works)
            build.LAUNCHES["threefry_render_kernel"] = launches
        else:
            sweeps = sum(float(w.double().sum()) for w in works)
        self.recorded = []
        return {"sweeps": sweeps, "n_active": self.n_active, "n_slots": self.n_slots,
                "pixels": self.width * self.height, "frame_spp": self.batch, "backend": self.backend}

    def _keyed_work(self, answer: dict, pix):
        """The jnp path's sweeps a pixel at `pix` of `answer`'s last batch:
        it returns no work map, so the kernel counts the same batch of the
        same pixels again (its launch not counted)."""
        from ray_tracing_in_one_weekend_tpu_torch.kernels import build
        from ray_tracing_in_one_weekend_tpu_torch.ops.render import render_keyed

        launches = build.LAUNCHES["threefry_render_kernel"]
        cam = self._camera(answer["lookfrom"])
        work = render_keyed(self.scene, cam, pix, answer["seed"], self.batch, answer["asked"] - self.batch,
                            return_work=True)[1].double()
        build.LAUNCHES["threefry_render_kernel"] = launches
        return work

    # -- the check ------------------------------------------------------

    def check(self, control: bool = False) -> dict:
        """The numbers compared, each with its limit; with `control`, the
        program's numbers and those of the reference computed in bfloat16 in
        the program's place."""
        while not self.kept:  # no answer finished in the window: finish the one under way
            self.frame()
        kept, pix = self.kept, self.check_pix
        self.kept = self.recorded = []
        if self.backend == "jnp":
            for a in kept:
                a["work"] = self._keyed_work(a, pix)
        del self.state, self.scene
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        prog, ctrl = {}, {}
        for a in kept:
            ref_lin, ref_work = self.reference(a, pix, torch.float32)
            _gaps(prog, a["lin"], a["u8"], a["work"], ref_lin, ref_work)
            if control:
                c_lin, c_work = self.reference(a, pix, torch.bfloat16)
                _gaps(ctrl, c_lin, common.to_uint8(c_lin).cpu(), c_work if a["work"] is not None else None, ref_lin,
                      ref_work)
        prog = {name: max(v) for name, v in prog.items()}
        if control:
            return {"program": prog, "control": {name: max(v) for name, v in ctrl.items()}}
        return {name: {"value": v, "limit": self.limits[name]} for name, v in prog.items()}

    def reference(self, answer: dict, pix, dtype):
        """The plain reference's linear mean [R, 3] of `pix` over the samples
        `answer` asked for, folded batch by batch as the program folds, and
        the sweeps of its last batch."""
        c = self.config
        cam = common.make_camera(self.width, self.height, answer["lookfrom"], c["lookat"], c["vup"],
                                 c["vfov_degrees"], c["defocus_angle_degrees"], c["focus_dist"], self.device)
        scene = common.scene_tensors(common.scene_arrays(), self.device)
        seed = answer["seed"]
        if self.backend == "jnp":
            rad, work = keyed.sample_radiance(scene, cam, pix, (seed >> 32, seed & 0xFFFFFFFF), 0, answer["asked"],
                                              c["max_depth"], dtype)
        else:
            rad, work = pcg.sample_radiance(pcg.pack_scene(scene, dtype), cam, pix, seed, 0, answer["asked"],
                                            c["max_depth"], dtype)
        fold = keyed.fold if self.backend == "jnp" else pcg.fold
        accum = torch.zeros(pix.numel(), 3, dtype=dtype, device=self.device)
        for b in range(0, answer["asked"], self.batch):
            accum = accum + fold(rad[b:b + self.batch], self.batch) * float(self.batch)
        return (accum / float(answer["asked"])).float(), work[-self.batch:].sum(0).double()
