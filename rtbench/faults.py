"""Faults planted in the port underneath a run, to show that the check
fails them: a step that returns its state unchanged, half of the batch
left out with the mean taken over the rest, and an answer altered where it
is produced. (Every cell runs on one chip, so no exchange between chips
can be left out.) They are planted once set-up has ended, so only the
window's work is broken, and a check that looked at set-up's work alone
would pass them. The CPU tests plant them at a tiny size, and
`rtbench.control --fault` reads them on the card at the cell's own size."""

from __future__ import annotations

import contextlib

import torch


def _render(name: str):
    from ray_tracing_in_one_weekend_tpu_torch.utils import checkpoint
    from ray_tracing_in_one_weekend_tpu_torch.utils.checkpoint import RenderState

    orig = checkpoint.accumulate

    def unchanged(state, *a, **kw):
        return state

    def half_batch(state, scene, cam, seed, spp_batch, **kw):
        half = orig(RenderState(torch.zeros_like(state.accum), state.spp_done), scene, cam, seed, spp_batch // 2, **kw)
        colors = half.accum / float(spp_batch // 2)  # the mean over the half rendered
        return RenderState(state.accum + colors * float(spp_batch), state.spp_done + spp_batch, half.work)

    def altered(state, scene, cam, seed, spp_batch, **kw):
        new = orig(state, scene, cam, seed, spp_batch, **kw)
        return RenderState(new.accum + 0.05 * spp_batch, new.spp_done, new.work)  # every pixel off by 0.05

    return checkpoint, "accumulate", {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}[name]


def _keyed(name: str):
    from ray_tracing_in_one_weekend_tpu_torch.parallel import dist

    orig_step, orig_loss = dist.train_step, dist.render_loss

    def unchanged(params, *a, lr=None, **kw):
        return orig_loss(params, *a, **kw), params

    def half_batch(params, scene, cam, target, base_key=0, mesh=None, chunk_size=dist.DEFAULT_CHUNK, spp=None):
        img = dist.render_distributed(dist.scene_with_params(scene, params), cam, base_key, mesh, chunk_size, spp,
                                      differentiable=True)
        rows = cam.image_height // 2  # the mean over the first half's pixels
        return torch.mean((img[:rows] - target[:rows]) ** 2)

    def altered(params, *a, **kw):
        loss, new = orig_step(params, *a, **kw)
        return loss, dict(new, albedo=params["albedo"] + 2.0 * (new["albedo"] - params["albedo"]))  # doubled

    if name == "half_batch":
        return dist, "render_loss", half_batch
    return dist, "train_step", {"unchanged": unchanged, "altered": altered}[name]


FAULTS = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def planted(name: str, driver: str):
    """The port with fault `name` planted for a cell played by `driver`."""
    module, attr, broken = (_keyed if driver == "keyed_step" else _render)(name)
    orig = getattr(module, attr)
    setattr(module, attr, broken)
    try:
        yield
    finally:
        setattr(module, attr, orig)


def after_setup(driver_class, name: str, stack: contextlib.ExitStack):
    """`driver_class` with fault `name` planted, into `stack`, once a
    driver's set-up has ended."""

    class Faulty(driver_class):
        def setup(self):
            super().setup()
            stack.enter_context(planted(name, self.traffic["driver"]))

    return Faulty
