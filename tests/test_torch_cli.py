"""The port's CLI: PPM output, backend choice, flags shared with the JAX
CLI, and no JAX at run time."""

import os
import subprocess
import sys

import pytest
import torch

from ray_tracing_in_one_weekend_tpu.utils import cli as jax_cli
from ray_tracing_in_one_weekend_tpu_torch.utils import cli, ppm
from ray_tracing_in_one_weekend_tpu_torch.utils.config import PRESETS

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--width", "32", "--aspect", "2", "--spp", "2", "--max-depth", "4"]


def test_tiny_render_to_ppm_file_and_stdout(tmp_path, capsysbinary):
    out = tmp_path / "out.ppm"
    res = cli.run(["--backend", "torch", "--scene", "three", *TINY, "--out", str(out)])
    assert res.backend == "torch" and res.image.shape == (16, 32, 3)
    assert res.render_s > 0 and res.mrays_per_s > 0
    data = out.read_bytes()
    assert data.startswith(b"P3\n32 16\n255\n")
    img = ppm.read_ppm(data)
    assert img.shape == (16, 32, 3) and 0 < img.mean() < 255

    assert cli.main(["--backend", "torch", "--scene", "three", *TINY]) == 0
    captured = capsysbinary.readouterr()
    assert captured.out == data  # same render, same bytes, on stdout
    assert b"Mrays/s" in captured.err and b"P3" not in captured.err


def test_auto_backend_logs_choice_and_cuda_never_falls_back(monkeypatch, capsys):
    """The default backend is `cuda`: without a GPU the CLI raises and does
    not render on the CPU; with one it logs `cuda`. Only `--backend torch`
    reaches the CPU."""
    assert cli.build_parser().parse_args([]).backend is None
    assert cli.config_from_args(cli.build_parser().parse_args([])).backend == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--backend", "cuda"]):
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            cli.run([*argv, "--scene", "single", *TINY, "--no-output"])
    assert "backend:" not in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--backend", "auto"])
    res = cli.run(["--backend", "torch", "--scene", "single", *TINY, "--no-output"])
    assert res.backend == "torch"
    assert "backend: torch on cpu" in capsys.readouterr().err
    # With a GPU the default resolves to cuda and says so before it renders
    # (the render itself needs the card; this CPU-only torch stops there).
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "Test GPU")
    assert cli.resolve_backend("cuda") == "cuda"
    with pytest.raises((AssertionError, RuntimeError)):
        cli.run(["--scene", "single", *TINY, "--no-output"])
    assert "backend: cuda on Test GPU" in capsys.readouterr().err


def test_timed_render_is_warm_unless_cold(capsys):
    """The first render fills the warm-start cache, so the timed second
    render runs one pass over cost-sorted lanes; `--cold` runs the
    compaction schedule both times. The image is the same bits."""
    argv = ["--backend", "torch", "--scene", "three", *TINY, "--no-output"]
    warm = cli.run(argv)
    assert warm.warm_hit and "warm schedule" in capsys.readouterr().err
    cold = cli.run([*argv, "--cold"])
    assert not cold.warm_hit and "cold schedule" in capsys.readouterr().err
    assert torch.equal(warm.image, cold.image)


@pytest.mark.parametrize(
    "argv",
    [
        [],
        ["--preset", "bench"],
        ["--preset", "cpu", "--width", "100", "--spp", "3"],
        ["--preset", "gpu", "--aperture", "0.2", "--focus-dist", "7.5", "--seed", "4"],
        ["--aspect", "2", "--max-depth", "9", "--vfov", "35", "--lookfrom", "1", "2", "3",
         "--lookat", "0", "1", "0", "--vup", "0", "0", "1", "--defocus-angle", "0",
         "--scene", "three"],
    ],
    ids=["default", "bench", "cpu", "gpu-aperture", "camera-flags"],
)
def test_shared_flags_give_jax_config(argv):
    ours = cli.config_from_args(cli.build_parser().parse_args(argv))
    theirs = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    for field in (
        "image_width", "image_height", "aspect_ratio", "samples_per_pixel", "max_depth",
        "vfov_degrees", "lookfrom", "lookat", "vup", "defocus_angle_degrees",
        "focus_dist", "aperture", "seed", "scene", "rays_per_frame",
    ):
        assert getattr(ours, field) == getattr(theirs, field), field


def test_presets_equal_jax_presets():
    from ray_tracing_in_one_weekend_tpu.utils.config import PRESETS as JAX_PRESETS

    assert set(PRESETS) == set(JAX_PRESETS) == {"cpu", "cpu-mt", "gpu", "gpu-old", "bench"}
    for name, ours in PRESETS.items():
        theirs = JAX_PRESETS[name]
        for field in ("image_width", "aspect_ratio", "samples_per_pixel", "max_depth",
                      "aperture", "defocus_angle_degrees", "scene", "seed"):
            assert getattr(ours, field) == getattr(theirs, field), (name, field)


def test_port_never_imports_jax():
    """A fresh interpreter imports the port, renders through the CLI and the
    library, and has neither jax nor flax in sys.modules."""
    code = (
        "import sys\n"
        "import ray_tracing_in_one_weekend_tpu_torch as rt\n"
        "from ray_tracing_in_one_weekend_tpu_torch.utils import cli\n"
        "from ray_tracing_in_one_weekend_tpu_torch.kernels import build\n"
        "from ray_tracing_in_one_weekend_tpu_torch.probes import device_idle, fma_contraction\n"
        "from ray_tracing_in_one_weekend_tpu_torch.probes import kernel_parts, perf_probe\n"
        "from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_render import _compact\n"
        "img = rt.render_cuda(rt.single_sphere_scene(pad_to=128), rt.make_camera("
        "image_width=16, aspect_ratio=2.0, samples_per_pixel=1, max_depth=2))\n"
        "assert img.shape == (8, 16, 3)\n"
        "cli.run(['--backend', 'torch', '--scene', 'single', '--width', '16', '--aspect', '2',"
        " '--spp', '1', '--max-depth', '2', '--no-output'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("clean")
