"""The port's CLI: PPM output, backend choice, flags shared with the JAX
CLI, and no JAX at run time."""

import os
import subprocess
import sys

import numpy as np
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
    for argv in ([], ["--backend", "cuda"], ["--spp", "64"], ["--checkpoint", "never.npz"]):
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


LONG = ["--backend", "torch", "--scene", "three", "--width", "32", "--aspect", "2", "--max-depth", "4"]


def test_long_render_prints_a_progress_line_a_batch(capsys):
    """At spp >= 64 the CLI renders in batches of --spp-batch samples, each
    on the next sample window, with the JAX CLI's lines on stderr; the image
    is the one-piece render's to float rounding of the re-associated mean."""
    res = cli.run([*LONG, "--spp", "64", "--spp-batch", "10", "--no-output"])
    err = capsys.readouterr().err
    assert "samples 10/64 (+10 in " in err and "samples 64/64 (+4 in " in err
    assert err.count("samples ") == 7 and "s remaining)" in err
    assert "render: " in err and "s total for 64 spp (" in err and "Mrays/s incl compile)" in err
    assert res.batches == 7 and res.session_spp == 64 and not res.warm_hit
    assert res.first_s == res.batch_s[0] and res.render_s == pytest.approx(sum(res.batch_s))
    assert res.mrays_per_s > 0
    one = cli.run([*LONG, "--spp", "64", "--no-progress", "--no-output"])
    err = capsys.readouterr().err
    assert "samples " not in err and "first render" in err and one.batches == 0
    torch.testing.assert_close(res.image, one.image, atol=1e-6, rtol=0)


def test_checkpoint_resumes_and_a_complete_one_renders_nothing(tmp_path, capsys):
    """--checkpoint saves after every batch and resumes; a rerun on a
    complete checkpoint renders no sample and writes the same bytes."""
    ckpt, first, again = tmp_path / "run.npz", tmp_path / "a.ppm", tmp_path / "b.ppm"
    part = cli.run([*LONG, "--spp", "3", "--checkpoint", str(ckpt), "--no-output"])
    assert part.session_spp == 3 and ckpt.exists()
    res = cli.run([*LONG, "--spp", "8", "--checkpoint", str(ckpt), "--out", str(first)])
    err = capsys.readouterr().err
    assert f"resumed {ckpt} at 3 spp" in err and "samples 8/8" in err
    assert res.session_spp == 5
    assert torch.equal(res.image, cli.run([*LONG, "--spp", "8", "--checkpoint",
                                           str(tmp_path / "fresh.npz"), "--spp-batch", "1",
                                           "--no-output"]).image)
    capsys.readouterr()
    res = cli.run([*LONG, "--spp", "8", "--checkpoint", str(ckpt), "--out", str(again)])
    err = capsys.readouterr().err
    assert "checkpoint already complete at 8 spp" in err and "samples " not in err
    assert res.batches == 0 and res.session_spp == 0 and res.mrays_per_s == 0.0
    assert again.read_bytes() == first.read_bytes()


def test_png_decodes_to_the_ppm_pixels(tmp_path):
    pil = pytest.importorskip("PIL.Image")

    out, png = tmp_path / "out.ppm", tmp_path / "out.png"
    cli.run([*LONG, "--spp", "2", "--out", str(out), "--png", str(png)])
    decoded = np.asarray(pil.open(png))
    assert decoded.dtype == np.uint8
    np.testing.assert_array_equal(decoded, ppm.read_ppm(str(out)))


def test_profile_writes_a_trace_of_the_one_piece_render(tmp_path, capsys):
    res = cli.run([*LONG, "--spp", "64", "--max-depth", "2", "--width", "16", "--profile",
                   str(tmp_path / "prof"), "--no-output"])
    assert res.batches == 0  # --profile renders in one piece
    trace = tmp_path / "prof" / "trace.json"
    assert trace.stat().st_size > 0 and "traceEvents" in trace.read_text()
    assert f"profile trace written to {trace}" in capsys.readouterr().err


def test_retries_recover_an_injected_nan_batch(monkeypatch, capsys):
    """--retries 1: one NaN batch is rendered again, and the image is the
    bits of the run without the fault."""
    from ray_tracing_in_one_weekend_tpu_torch.utils import checkpoint

    argv = [*LONG, "--spp", "64", "--max-depth", "2", "--width", "16", "--no-output"]
    clean = cli.run(argv)
    real, calls = checkpoint.render_cuda, []

    def flaky(*a, **kw):
        calls.append(kw["sample_offset"])
        colors, work = real(*a, **kw)
        return (colors * float("nan") if len(calls) == 2 else colors), work

    monkeypatch.setattr(checkpoint, "render_cuda", flaky)
    assert not bool(torch.isfinite(cli.run(argv).image).all())  # the fault reaches the image
    calls.clear()
    capsys.readouterr()
    res = cli.run([*argv, "--retries", "1"])
    assert "resilient: batch at spp=6 failed (BatchCorruptError" in capsys.readouterr().err
    assert calls[:3] == [0, 6, 6] and torch.equal(res.image, clean.image)


def test_retries_recover_an_injected_nan_frame_in_one_piece(monkeypatch, capsys):
    """--no-progress --retries 1: a NaN timed frame is rendered again, and
    the image is the bits of the run without the fault; with --retries 0
    the NaN frame raises, as the JAX CLI's does."""
    argv = [*TINY, "--backend", "torch", "--no-output", "--no-progress"]
    clean = cli.run(argv)
    real, calls = cli.render_cuda, []

    def flaky(*a, **kw):
        calls.append(len(calls))
        img = real(*a, **kw)
        return img * float("nan") if len(calls) == 2 else img  # call 2: the timed render

    monkeypatch.setattr(cli, "render_cuda", flaky)
    with pytest.raises(RuntimeError, match="non-finite pixels in rendered frame"):
        cli.run(argv)
    assert "render failed after 0 retries" in capsys.readouterr().err
    calls.clear()
    res = cli.run([*argv, "--retries", "1"])
    assert len(calls) == 3 and res.batches == 0
    assert "render failed (RuntimeError: non-finite pixels" in capsys.readouterr().err
    assert torch.equal(res.image, clean.image)


def test_port_never_imports_jax(tmp_path):
    """A fresh interpreter imports the port, renders through the CLI (in one
    piece and checkpointed) and the library, and has neither jax nor flax
    in sys.modules."""
    code = (
        "import sys\n"
        "import ray_tracing_in_one_weekend_tpu_torch as rt\n"
        "from ray_tracing_in_one_weekend_tpu_torch.utils import cli\n"
        "from ray_tracing_in_one_weekend_tpu_torch.kernels import build\n"
        "from ray_tracing_in_one_weekend_tpu_torch.probes import device_idle, fma_contraction\n"
        "from ray_tracing_in_one_weekend_tpu_torch.probes import kernel_parts, perf_probe\n"
        "from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_render import _compact\n"
        "from ray_tracing_in_one_weekend_tpu_torch.utils import checkpoint, debug, png, resilient\n"
        "img = rt.render_cuda(rt.single_sphere_scene(pad_to=128, device='cpu'), rt.make_camera("
        "image_width=16, aspect_ratio=2.0, samples_per_pixel=1, max_depth=2, device='cpu'))\n"
        "assert img.shape == (8, 16, 3)\n"
        "cli.run(['--backend', 'torch', '--scene', 'single', '--width', '16', '--aspect', '2',"
        " '--spp', '1', '--max-depth', '2', '--no-output'])\n"
        "res = cli.run(['--backend', 'torch', '--scene', 'single', '--width', '16', '--aspect', '2',"
        " '--spp', '2', '--max-depth', '2', '--checkpoint', sys.argv[1], '--no-output'])\n"
        "assert res.batches == 2 and checkpoint.load(sys.argv[1], device='cpu').spp_done == 2\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "ckpt.npz")], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("clean")


@pytest.mark.parametrize("text,shape", [("2", (2,)), ("1,2", (1, 2)), ("4,2", (4, 2))])
def test_mesh_flag_parses_as_the_jax_cli(text, shape):
    """`--mesh P[,S]` gives the JAX CLI's mesh_shape; anything else raises."""
    ours = cli.config_from_args(cli.build_parser().parse_args(["--mesh", text]))
    theirs = jax_cli.config_from_args(jax_cli.build_parser().parse_args(["--mesh", text]))
    assert ours.mesh_shape == theirs.mesh_shape == shape
    assert cli.config_from_args(cli.build_parser().parse_args([])).mesh_shape == ()
    for bad in ("", "2,x", "1,2,3", "0", "-1,2"):
        with pytest.raises(ValueError, match="--mesh takes P or P,S"):
            cli.parse_mesh(bad)


def test_batch_rounds_to_the_sample_axis():
    """The batched path's batch is a multiple of the mesh's S, at least S
    (JAX cli.py:327-335); without a mesh it is unchanged."""
    from ray_tracing_in_one_weekend_tpu_torch.parallel.dist import Mesh

    assert cli.batch_for_mesh(7, None) == 7
    assert cli.batch_for_mesh(7, Mesh(2, 1)) == 7
    assert cli.batch_for_mesh(7, Mesh(1, 2)) == 6
    assert cli.batch_for_mesh(6, Mesh(2, 4)) == 4
    assert cli.batch_for_mesh(1, Mesh(1, 2)) == 2


def test_torchrun_sample_mesh_rank_zero_writes_the_composite_ppm(tmp_path):
    """`torchrun --nproc-per-node 2 ... --backend torch --mesh 1,2` on the
    CPU (gloo): rank 0 alone writes the PPM, and its bytes are those of the
    two sample windows rendered in one process and averaged in rank order;
    stdout stays empty."""
    import socket

    from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_render import render_cuda
    from ray_tracing_in_one_weekend_tpu_torch.ops.image import to_uint8
    from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
        make_camera_from_config,
        make_scene_from_config,
    )

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tmp_path / "mesh.ppm"
    argv = ["--backend", "torch", "--scene", "three", *TINY, "--mesh", "1,2", "--out", str(out)]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "127.0.0.1", "--master-port", str(port),
         "-m", "ray_tracing_in_one_weekend_tpu_torch", *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout == ""
    assert proc.stderr.count(f"wrote {out}") == 1 and proc.stderr.count("render: ") == 1
    assert "backend gloo" in proc.stderr and "mesh=1x2" in proc.stderr

    config = cli.config_from_args(cli.build_parser().parse_args(argv))
    scene = make_scene_from_config(config, "cpu")
    cam = make_camera_from_config(config, "cpu")
    windows = [render_cuda(scene, cam, seed=config.seed, spp=1, sample_offset=s) for s in (0, 1)]
    expected = tmp_path / "composite.ppm"
    ppm.write_ppm(to_uint8((windows[0] + windows[1]) / 2).numpy(), str(expected))
    assert out.read_bytes() == expected.read_bytes()
