"""The inverse-rendering mix: `parallel.dist.train_step` on threefry keys,
one step after another, closed loop, one client.

Set-up builds the scene and camera, moves every albedo by a seeded
U(-jitter, jitter) (clipped to [0, 1]) to make the starting parameters
(the mix's `fields` of the scene, the albedo among them), renders the
target from the true scene on a key of its own, and takes one step of the
cell's shapes through the same call the window makes; the window goes on
from there with the same parameters, each step on a fresh key. A frame is
one step, ended by its return and a synchronize.

The check follows `checked_steps` consecutive steps of the window, whose
first is drawn by reservoir sampling over the window's steps from the
check's seed (a run that the window's close cuts short is finished through
the same call after the close). The window keeps the run's parameters
(the step returns new tensors, so keeping them copies nothing), each
step's loss and the sweeps the port counted for its recording. The plain
reference then takes each of those steps from the parameters the
program's step started from (its own target, its own gradient by
torch.autograd, its own SGD update) and the check compares each step's
loss and sweeps, the first update (the first gradient as SGD got it,
times lr) and the parameters' change over the run, each as the worst
leaf's gap of norms. It follows the program's states and not its own
trajectory: a path-traced gradient is chaotic in the parameters, so states
one float32 rounding apart give gradients far apart after a step
(PERF.md).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rtbench import seeds
from rtbench.reference import common, keyed

# Pixels a block of the reference's gradient (its tape is one block's).
REFERENCE_PIXELS = 480_000


def _norms(a: dict, b: dict) -> dict:
    """The float64 norm of b - a, by leaf."""
    return {k: float((b[k].double() - a[k].double()).norm()) for k in a}


def _worst_gap(prog: dict, ref: dict, leaves) -> float:
    """max over `leaves` of |prog - ref| / max(ref, the median leaf's ref)."""
    median = sorted(ref.values())[len(ref) // 2]
    return max(abs(prog[k] - ref[k]) / max(ref[k], median) for k in leaves)


class Driver:
    tail = "step_ms_p95"

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.config, self.traffic, self.limits = cell.config, cell.traffic, cell.limits
        self.width, self.height = self.config["image_width"], self.config["image_height"]
        self.spp, self.depth = self.config["samples_per_pixel"], self.config["max_depth"]
        self.fields = tuple(self.traffic["fields"])
        self.rng = np.random.default_rng(seeds.derive(self.seed, "check"))
        self.recording = False
        self.recorded = []

    def key(self, step: int) -> tuple:
        return seeds.key(self.seed, "step", step)

    def setup(self):
        from ray_tracing_in_one_weekend_tpu_torch.models.camera import make_camera
        from ray_tracing_in_one_weekend_tpu_torch.models.scene import scene_from_numpy
        from ray_tracing_in_one_weekend_tpu_torch.ops.render import render_image
        from ray_tracing_in_one_weekend_tpu_torch.parallel import dist

        if self.device.type == "cuda":
            from ray_tracing_in_one_weekend_tpu_torch.kernels import build

            build.load()
            self.arena_totals = build._ARENA_TOTALS
        else:
            self.arena_totals = {}
        self.setup_parts = {"kernels_loaded": time.perf_counter()}
        c = self.config
        self.dist = dist  # train_step is looked up at each step, where a fault may be planted
        self.lr = float(self.traffic["lr"])
        self.scene = scene_from_numpy(common.scene_arrays(), device=self.device)
        self.cam = make_camera(image_width=self.width, aspect_ratio=self.width / self.height,
                               samples_per_pixel=self.spp, max_depth=self.depth, vfov_degrees=c["vfov_degrees"],
                               lookfrom=tuple(c["lookfrom"]), lookat=tuple(c["lookat"]), vup=tuple(c["vup"]),
                               defocus_angle_degrees=c["defocus_angle_degrees"], focus_dist=c["focus_dist"],
                               device=self.device)
        self.n_active, self.n_slots = self.scene.num_active, self.scene.num_slots
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seeds.derive(self.seed, "albedo") >> 1)
        jitter = float(self.traffic["albedo_jitter"])
        noise = torch.rand(self.scene.albedo.shape, generator=gen, device=self.device)
        self.params = {k: getattr(self.scene, k) for k in self.fields}
        self.params["albedo"] = torch.clamp(self.scene.albedo + (noise * (2 * jitter) - jitter), 0.0, 1.0)
        self.target = render_image(self.scene, self.cam, seeds.key(self.seed, "target"))
        float(self.target[0, 0, 0])  # the target's render ends before the steps begin
        self.setup_parts["target"] = time.perf_counter()
        self.steps = 0
        self.run = None  # the checked run of steps
        self.seen = 0  # window steps offered to the reservoir as its start
        self._step()  # one step of the cell's shapes, unchecked

    def _sweeps(self):
        return self.arena_totals.get((self.width * self.height, self.spp, self.depth, self.n_slots))

    def _step(self):
        """One train_step; a step of the checked run keeps its loss, its
        sweeps and the parameters it made."""
        loss, self.params = self.dist.train_step(self.params, self.scene, self.cam, self.target, self.key(self.steps),
                                            lr=self.lr)
        self.steps += 1
        run = self.run
        if run is not None and len(run["losses"]) < int(self.traffic["checked_steps"]):
            run["losses"].append(loss)
            run["sweeps"].append(self._sweeps())
            run["states"].append(self.params)

    def frame(self) -> int:
        # Reservoir sampling of one run's first step over the window's steps.
        self.seen += 1
        if int(self.rng.integers(0, self.seen)) == 0:
            self.run = {"start": self.steps, "states": [self.params], "losses": [], "sweeps": []}
        self._step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.recording:
            self.recorded.append(self._sweeps())
        return self.width * self.height * self.spp

    def trace_counts(self, frames: int) -> dict:
        sweeps = self.recorded[-frames:]
        self.recorded = []
        n = self.width * self.height
        return {"sweeps": float(sum(sweeps)) if all(s is not None for s in sweeps) else None,
                "n_active": self.n_active, "n_slots": self.n_slots, "pixels": n * frames,
                "paths": n * self.spp * frames}

    # -- the check ------------------------------------------------------

    def _reference(self):
        c = self.config
        cam = common.make_camera(self.width, self.height, c["lookfrom"], c["lookat"], c["vup"], c["vfov_degrees"],
                                 c["defocus_angle_degrees"], c["focus_dist"], self.device)
        return cam, common.scene_tensors(common.scene_arrays(), self.device)

    def _target(self, cam, true, dtype):
        pix = torch.arange(self.width * self.height, device=self.device)
        with torch.no_grad():
            return torch.cat([keyed.render_pixels(true, cam, pix[a:a + REFERENCE_PIXELS], seeds.key(self.seed, "target"),
                                                  self.spp, 0, self.depth, dtype)[0]
                              for a in range(0, pix.numel(), REFERENCE_PIXELS)])

    def _reference_step(self, cam, true, target, state: dict, step: int, dtype):
        """The reference's step `step` (its key's index) from parameters
        `state` -> (loss,
        sweeps, the parameters after its SGD update, by leaf)."""
        pix = torch.arange(self.width * self.height, device=self.device)
        start = {k: v.to(self.device).to(dtype) for k, v in state.items()}
        leaves = {k: v.detach().clone().requires_grad_() for k, v in start.items()}
        scene = dict(true, **leaves)
        image, work = [], 0
        for a in range(0, pix.numel(), REFERENCE_PIXELS):
            colors, w = keyed.render_pixels(scene, cam, pix[a:a + REFERENCE_PIXELS], self.key(step), self.spp, 0,
                                            self.depth, dtype)
            part = ((colors - target[a:a + REFERENCE_PIXELS]) ** 2).sum() * (1.0 / target.numel())
            if part.requires_grad:
                part.backward()
            image.append(colors.detach())
            work += int(w.sum())
        loss = float(torch.mean((torch.cat(image) - target) ** 2))
        new = {k: (start[k] - self.lr * (v.grad if v.grad is not None else torch.zeros_like(v))).detach()
               for k, v in leaves.items()}
        return loss, work, {k: new[k].float().cpu() for k in self.fields}

    def follow(self, run: dict) -> dict:
        """The float32 reference's steps from each of `run`'s states: its
        losses, sweeps and updates."""
        cam, true = self._reference()
        target = self._target(cam, true, torch.float32)
        losses, sweeps, updates = [], [], []
        for i in range(len(run["losses"])):
            loss, work, new = self._reference_step(cam, true, target, run["states"][i], run["start"] + i,
                                                   torch.float32)
            losses.append(loss)
            sweeps.append(work)
            updates.append({k: new[k].double() - run["states"][i][k].double() for k in self.fields})
        return {"losses": losses, "sweeps": sweeps, "updates": updates}

    def control_run(self, start: int, state: dict) -> dict:
        """The reference in bfloat16 in the program's place: its own target
        and its own steps from the program's run's first state."""
        cam, true = self._reference()
        target = self._target(cam, true, torch.bfloat16)
        run = {"start": start, "losses": [], "sweeps": [], "states": [state]}
        for i in range(int(self.traffic["checked_steps"])):
            loss, work, new = self._reference_step(cam, true, target, run["states"][i], start + i, torch.bfloat16)
            run["losses"].append(loss)
            run["sweeps"].append(work)
            run["states"].append(new)
        return run

    def compare(self, run: dict, ref: dict) -> dict:
        """The numbers compared, of a run (the program's, or the control's)
        against the reference's steps from the run's own states: each
        step's loss, the first update (the first gradient as SGD got it,
        times lr) and the change over the checked steps, each as the worst
        leaf's gap of norms, and each step's sweeps."""
        n = len(ref["losses"])
        states = run["states"]
        first_ref = {k: float(ref["updates"][0][k].norm()) for k in self.fields}
        median = sorted(first_ref.values())[len(first_ref) // 2]
        # Leaves that the reference's first gradient leaves at rounding.
        moved = [k for k in self.fields if first_ref[k] >= 1e-3 * median]
        change_ref = {k: float(sum(u[k] for u in ref["updates"]).norm()) for k in self.fields}
        out = {
            "loss_gap": max(abs(run["losses"][i] - ref["losses"][i]) / abs(ref["losses"][i]) for i in range(n)),
            "grad_gap": _worst_gap(_norms(states[0], states[1]), first_ref, self.fields),
            "change_gap": _worst_gap(_norms(states[0], states[n]), change_ref, moved),
        }
        if all(s is not None for s in run["sweeps"][:n]):
            out["sweeps_gap"] = max(abs(run["sweeps"][i] - ref["sweeps"][i]) / ref["sweeps"][i] for i in range(n))
        return out

    def check(self, control: bool = False) -> dict:
        while self.run is None or len(self.run["losses"]) < int(self.traffic["checked_steps"]):
            if self.run is None:  # no window step: the run starts after it
                self.run = {"start": self.steps, "states": [self.params], "losses": [], "sweeps": []}
            self._step()
        run = self.run
        prog = {"start": run["start"], "losses": [float(v) for v in run["losses"]], "sweeps": run["sweeps"],
                "states": [{k: v.detach().cpu() for k, v in s.items()} for s in run["states"]]}
        del self.params, self.target, self.scene, self.run
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        numbers = self.compare(prog, self.follow(prog))
        if control:
            ctrl = self.control_run(prog["start"], prog["states"][0])
            return {"program": numbers, "control": self.compare(ctrl, self.follow(ctrl))}
        return {name: {"value": v, "limit": self.limits[name]} for name, v in numbers.items()}
