"""The port's entry points (`entry.py`): the one-device render check and
the multi-rank dry run, on the CPU (gloo ranks on localhost)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ray_tracing_in_one_weekend_tpu_torch import entry
from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_render import render_cuda

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_renders_the_cover_scene():
    """entry() gives a render of the cover scene at 64x32, 2 spp, and its
    arguments: finite, the shape of the camera, `render_cuda`'s image."""
    fn, (scene, seed) = entry.entry(device="cpu")
    img = fn(scene, seed)
    assert img.shape == (32, 64, 3) and img.dtype == torch.float32
    assert bool(torch.isfinite(img).all()) and 0.0 < float(img.mean()) < 1.0
    assert torch.equal(img, render_cuda(scene, entry._small_camera(2, 64, "cpu"), seed=seed))


@pytest.mark.parametrize("n,shape", [(1, (1, 1)), (2, (2, 1)), (3, (3, 1)), (4, (2, 2)), (8, (4, 2))])
def test_mesh_shape_for_rank_counts(n, shape):
    """(n/2, 2) for an even n >= 4, else (n, 1): __graft_entry__.py's rule."""
    assert entry.mesh_shape_for(n) == shape


def test_dryrun_multichip_two_ranks():
    """Two gloo ranks: the sharded target and one sharded train step, with a
    finite loss that both ranks agree on bit for bit."""
    res = entry.dryrun_multichip(2, device="cpu", timeout=120.0)
    assert res["mesh"] == (2, 1) and len(res["losses"]) == 2
    assert np.isfinite(res["losses"][0]) and res["losses"][0] > 0.0


def test_dryrun_on_the_card_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        entry.dryrun_multichip(2)


def test_sharding_modules_never_import_jax():
    """A fresh interpreter imports the sharding, the worker and the entry,
    and has neither jax nor flax in sys.modules."""
    code = (
        "import sys\n"
        "import ray_tracing_in_one_weekend_tpu_torch.parallel\n"
        "from ray_tracing_in_one_weekend_tpu_torch.parallel import dist, worker\n"
        "from ray_tracing_in_one_weekend_tpu_torch import entry\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_worker_launch_asks_for_its_device():
    """`parallel/worker.launch` takes `device` as a required keyword: no
    launch runs its ranks on the CPU unless the caller asks."""
    import inspect

    from ray_tracing_in_one_weekend_tpu_torch.parallel import worker

    param = inspect.signature(worker.launch).parameters["device"]
    assert param.kind is inspect.Parameter.KEYWORD_ONLY and param.default is inspect.Parameter.empty
    with pytest.raises(TypeError, match="device"):
        worker.launch([], 1, REPO)
