"""The port's gallery tools: `utils/png.read_png`, `utils/manifest.py`,
`scripts/render_artifact.py`, `scripts/render_gallery.py` and
`probes/sweep_sched.py`, on the CPU.

`read_png` is held to PIL's pixels on the committed PNGs and on rows
written under each filter type by an encoder in this file. The shrunken
preset render is held to the JAX package's Pallas accumulation (interpret
mode, once for the module) on the same scene and streams, as
tests/test_torch_checkpoint.py holds the accumulation. No test starts a
process: the manifest's git calls are replaced by a fake.
"""

import dataclasses
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch

from ray_tracing_in_one_weekend_tpu.models import scene as jax_scene
from ray_tracing_in_one_weekend_tpu.utils import checkpoint as jax_ckpt
from ray_tracing_in_one_weekend_tpu.utils import config as jax_config
from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.models.camera import make_camera
from ray_tracing_in_one_weekend_tpu_torch.probes import sweep_sched
from ray_tracing_in_one_weekend_tpu_torch.scripts import render_artifact, render_gallery
from ray_tracing_in_one_weekend_tpu_torch.utils import compare, manifest
from ray_tracing_in_one_weekend_tpu_torch.utils.png import read_png, write_png

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED_PNGS = (
    "tests/goldens/ref_cpu_cover_1200x800_500spp.png",
    "gallery/cover_1200x800_500spp_pallas.png",
    "gallery/cover_1920x1080_500spp_gpu.png",
    "gallery/cover_300x200_500spp_gpu-old.png",
    "gallery/cover_3840x2160_500spp_cpu-mt.png",
)
FIELDS = ("center", "radius", "albedo", "fuzz", "ior", "mat_type", "active")
# The shrunken gpu-old preset: 48x32, spp 4 in batches of 2, depth 8.
SMALL = dict(image_width=48, max_depth=8)
SMALL_SPP, SMALL_BATCH = 4, 2


@pytest.fixture(autouse=True)
def no_git(monkeypatch):
    """The manifest sees no git checkout unless a test says otherwise."""
    monkeypatch.setattr(manifest, "_git", lambda root, *args: None)


# --- read_png -----------------------------------------------------------------


def _png(header, raw, extra=()):
    """PNG bytes from an IHDR tuple, the uncompressed rows and extra chunks
    put before IDAT."""
    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", *header))
            + b"".join(chunk(k, d) for k, d in extra) + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_rows(img, types):
    """Encode uint8 [H, W, C] with filter types[r] on row r, byte by byte as
    the PNG specification defines the filters (on the original bytes)."""
    h, w, bpp = img.shape
    x = img.reshape(h, w * bpp).astype(int)
    out = []
    for r in range(h):
        row = [types[r]]
        for i in range(w * bpp):
            a = x[r, i - bpp] if i >= bpp else 0
            b = x[r - 1, i] if r > 0 else 0
            c = x[r - 1, i - bpp] if r > 0 and i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[types[r]]
            row.append((x[r, i] - pred) % 256)
        out.append(row)
    return np.asarray(out, np.uint8).tobytes()


@pytest.mark.parametrize("rel", COMMITTED_PNGS)
def test_read_png_equals_pil(rel):
    """PIL wrote these with adaptive row filters (all of 1-4 appear)."""
    pil = pytest.importorskip("PIL.Image")
    path = os.path.join(ROOT, rel)
    ours = read_png(path)
    assert ours.dtype == np.uint8 and ours.flags.c_contiguous
    np.testing.assert_array_equal(ours, np.asarray(pil.open(path))[..., :3])


@pytest.mark.parametrize("types", ["0", "1", "2", "3", "4", "mixed", "rgba"])
def test_read_png_each_filter_type(tmp_path, types):
    """Rows written under one filter type, or a random type a row (RGB and
    RGBA, alpha dropped), decode to the pixels exactly."""
    rng = np.random.default_rng(7)
    bpp = 4 if types == "rgba" else 3
    img = rng.integers(0, 256, (9, 13, bpp), dtype=np.uint8)
    img[2:5, 3:9] = img[2, 3]  # flat patches, where the filters' predictions matter
    row_types = (rng.integers(0, 5, 9) if types in ("mixed", "rgba") else np.full(9, int(types))).tolist()
    path = tmp_path / "f.png"
    path.write_bytes(_png((13, 9, 8, 2 if bpp == 3 else 6, 0, 0, 0), _filter_rows(img, row_types)))
    np.testing.assert_array_equal(read_png(str(path)), img[..., :3])


def test_write_png_round_trips(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    write_png(img, str(tmp_path / "w.png"))
    np.testing.assert_array_equal(read_png(str(tmp_path / "w.png")), img)


@pytest.mark.parametrize("bad", ["16-bit", "palette", "grey", "interlaced", "crc", "filter-type", "short"])
def test_read_png_rejects(tmp_path, bad):
    raw = bytes(1 + 2 * 3) * 2  # two rows of a 2x2 RGB image, filter 0
    header = {"16-bit": (2, 2, 16, 2, 0, 0, 0), "palette": (2, 2, 8, 3, 0, 0, 0),
              "grey": (2, 2, 8, 0, 0, 0, 0), "interlaced": (2, 2, 8, 2, 0, 0, 1)}.get(bad, (2, 2, 8, 2, 0, 0, 0))
    extra = [(b"PLTE", bytes(6))] if bad == "palette" else []
    if bad == "filter-type":
        raw = b"\x05" + raw[1:]
    if bad == "short":
        raw = raw[:-1]
    data = bytearray(_png(header, raw, extra))
    if bad == "crc":
        data[40] ^= 1  # a byte of the IDAT chunk's data
    path = tmp_path / "bad.png"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        read_png(str(path))


# --- manifest -----------------------------------------------------------------


def _copy_sources(root):
    for rel in manifest.RENDER_SOURCES:
        os.makedirs(os.path.dirname(root / rel), exist_ok=True)
        shutil.copy(os.path.join(ROOT, rel), root / rel)


def test_digest_is_stable():
    assert manifest.render_sources_digest() == manifest.render_sources_digest(ROOT)
    assert len(manifest.render_sources_digest()) == 64


@pytest.mark.parametrize("change,moves", [
    ("python code", True), ("cuda byte", True), ("python docstring", False), ("python comment", False)])
def test_digest_follows_code_not_docs(tmp_path, change, moves):
    """A code change moves the digest (a .cu file by any byte); a docstring
    or a comment in a Python file does not."""
    _copy_sources(tmp_path)
    before = manifest.render_sources_digest(str(tmp_path))
    assert before == manifest.render_sources_digest()
    if change == "cuda byte":
        path = tmp_path / "ray_tracing_in_one_weekend_tpu_torch/csrc/render_device.cuh"
        data = bytearray(path.read_bytes())
        data[len(data) // 2] ^= 1
        path.write_bytes(bytes(data))
    else:
        path = tmp_path / "ray_tracing_in_one_weekend_tpu_torch/ops/cuda_render.py"
        src = path.read_text()
        edit = {"python code": ("DEFAULT_PASSES = 2", "DEFAULT_PASSES = 3"),
                "python docstring": ('"""The forward render:', '"""The render forward:'),
                "python comment": ("# Passes of a render", "# The passes of a render")}[change]
        assert src.count(edit[0]) == 1
        path.write_text(src.replace(*edit))
    assert (manifest.render_sources_digest(str(tmp_path)) != before) == moves


@pytest.mark.parametrize("top,head,status,want", [
    ("ROOT", "abc123", "", "abc123"),
    ("ROOT", "abc123", " M ray_tracing_in_one_weekend_tpu_torch/ops/image.py", "abc123-dirty"),
    ("/elsewhere", "abc123", "", "unknown"),  # an unpacked archive inside another checkout
    (None, None, None, "unknown"),  # no git, or not a checkout
])
def test_git_commit_marks_a_dirty_tree(monkeypatch, tmp_path, top, head, status, want):
    answers = {"--show-toplevel": str(tmp_path) if top == "ROOT" else top, "HEAD": head, "--porcelain": status}
    monkeypatch.setattr(manifest, "_git", lambda root, *args: answers[args[1]])
    assert manifest.git_commit(str(tmp_path)) == want


def test_record_and_load(tmp_path):
    entry = manifest.record(str(tmp_path), "a.png", {"spp": 4}, device="cpu")
    assert manifest.load(str(tmp_path)) == {"a.png": entry}
    assert entry["render_sources_digest"] == manifest.render_sources_digest()
    assert entry["git_commit"] == "unknown" and entry["card"] == "cpu"
    assert entry["torch_version"] == torch.__version__ and entry["spp"] == 4
    assert manifest.load(str(tmp_path / "none")) == {}


# --- render_artifact ------------------------------------------------------------


def test_jax_scene_table_is_the_jax_cover_scene():
    """The committed table is the JAX package's cover_scene(0), every slot."""
    theirs = jax_scene.cover_scene(0)
    with np.load(render_artifact.JAX_COVER_SCENE_0) as z:
        assert sorted(z.files) == sorted(FIELDS)
        for f in FIELDS:
            np.testing.assert_array_equal(z[f], np.asarray(getattr(theirs, f)), err_msg=f)


@pytest.fixture(scope="module")
def small_render(tmp_path_factory):
    """The shrunken gpu-old render through `render_preset` on the CPU, on
    the JAX scene; and the same batches through the JAX package's Pallas
    accumulation."""
    out = tmp_path_factory.mktemp("gallery")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(manifest, "_git", lambda root, *args: None)
        art = render_artifact.render_preset("gpu-old", SMALL_SPP, SMALL_BATCH, out_dir=str(out), device="cpu",
                                            jax_scene=True, **SMALL)
    config = dataclasses.replace(jax_config.PRESETS["gpu-old"], **SMALL)
    js, jc = jax_config.make_scene_from_config(config), jax_config.make_camera_from_config(config)
    state = jax_ckpt.new_state(jc)
    for _ in range(SMALL_SPP // SMALL_BATCH):
        state = jax_ckpt.accumulate(state, js, jc, 0, SMALL_BATCH, backend="pallas", tile=128, interpret=True)
    return art, np.array(state.image)


def test_render_preset_writes_png_and_manifest(small_render):
    art, _ = small_render
    assert art.name == "cover_48x32_4spp_gpu-old.png"
    np.testing.assert_array_equal(read_png(art.path), art.u8)
    assert art.u8.shape == (32, 48, 3) and art.launches == (0, 0) and len(art.batch_s) == 2
    m = manifest.load(os.path.dirname(art.path))
    assert m == {art.name: art.entry}
    e = art.entry
    for k in ("preset", "scene", "width", "height", "spp", "max_depth", "seed", "backend", "render_seconds",
              "mrays_per_s", "mrays_per_s_incl_first", "batch_seconds", "mean_u8", "render_kernel_launches",
              "render_sources_digest", "git_commit", "python_version", "torch_version", "cuda_version", "card"):
        assert k in e, k
    assert (e["preset"], e["width"], e["height"], e["spp"], e["max_depth"], e["seed"]) == ("gpu-old", 48, 32, 4, 8, 0)
    assert (e["scene"], e["backend"], e["card"], e["render_kernel_launches"]) == (
        "jax cover_scene(0)", "torch", "cpu", 0)
    assert e["mean_u8"] == pytest.approx(float(art.u8.mean()))


def test_render_preset_matches_jax_pallas(small_render):
    """The same scene, camera, seed and batches as the JAX package's Pallas
    accumulation: pixels off by more than 1e-3 under 3%, block means within
    the mode-check thresholds (tests/test_torch_checkpoint.py's bound)."""
    art, theirs = small_render
    agree = compare.images(art.image, torch.from_numpy(theirs), block=8, atol=1e-3)
    assert agree.flipped_frac < 0.03, agree
    assert agree.blocks_agree, agree


def test_render_preset_other_seed_and_scene(tmp_path):
    """Another render seed gets its own file name and other pixels; without
    `jax_scene` the preset renders the port's own cover_scene(0)."""
    kw = dict(out_dir=str(tmp_path), device="cpu", image_width=24, max_depth=4)
    own = render_artifact.render_preset("gpu-old", 2, 2, **kw)
    seed1 = render_artifact.render_preset("gpu-old", 2, 2, seed=1, **kw)
    assert (own.name, seed1.name) == ("cover_24x16_2spp_gpu-old.png", "cover_24x16_2spp_gpu-old_seed1.png")
    assert own.entry["scene"] == "cover_scene(0)" and seed1.entry["seed"] == 1
    assert not np.array_equal(own.u8, seed1.u8)
    assert sorted(manifest.load(str(tmp_path))) == sorted([own.name, seed1.name])
    assert "mrays_per_s" not in own.entry  # one batch: no steady window


def test_render_preset_needs_a_gpu_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        render_artifact.render_preset("gpu-old", 2, out_dir=str(tmp_path), image_width=24, max_depth=4)


def test_steady_rates_label_the_first_batch():
    one = render_artifact.steady_rates([2.0], [4e6])
    assert one == {"mrays_per_s_incl_first": 2.0}
    three = render_artifact.steady_rates([3.0, 1.0, 1.0], [2e6, 2e6, 2e6])
    assert three == {"mrays_per_s_incl_first": pytest.approx(1.2), "mrays_per_s": pytest.approx(2.0)}


# --- render_gallery -------------------------------------------------------------


def test_image_stats_by_hand():
    """Differences 0, 0, 0 | 1, 2, 3 | 0, 0, 0 | 10, 0, 250 (in 8-bit levels)."""
    ref = np.zeros((2, 2, 3), np.uint8)
    ours = np.array([[[0, 0, 0], [1, 2, 3]], [[0, 0, 0], [10, 0, 250]]], np.uint8)
    s = render_gallery.image_stats(ours, ref)
    assert s.mad == pytest.approx(266 / 12)
    assert s.p50 == pytest.approx(0.0) and s.max == 250.0 and s.equal == 0.5
    assert s.p99 == pytest.approx(np.percentile([0, 0, 0, 1, 2, 3, 0, 0, 0, 10, 0, 250], 99))
    assert s.bias == pytest.approx(266 / 12)
    back = render_gallery.image_stats(ref, ours)  # no wrap of uint8
    assert back == dataclasses.replace(s, bias=-s.bias)
    with pytest.raises(ValueError):
        render_gallery.image_stats(ours, ref[:1])


@pytest.mark.parametrize("mad,p99,mx,failed", [
    (1.91, 19.0, 159.0, []), (2.5, 19.0, 159.0, ["MAD"]), (1.0, 26.0, 221.0, ["p99", "max"])])
def test_golden_gates(mad, p99, mx, failed):
    s = render_gallery.Stats(mad, 1.0, p99, p99, mx, 0.1, 0.0)
    assert [f.split()[0] for f in render_gallery.golden_failures(s)] == failed


@pytest.mark.parametrize("preset,size,name", [
    ("cpu", (1200, 800), "cover_1200x800_500spp_pallas.png"),
    ("gpu", (1920, 1080), "cover_1920x1080_500spp_gpu.png"),
    ("gpu-old", (300, 200), "cover_300x200_500spp_gpu-old.png"),
    ("cpu-mt", (3840, 2160), "cover_3840x2160_500spp_cpu-mt.png"),
    ("gpu-old", (48, 32), None),
])
def test_tpu_render_found_by_the_manifest(preset, size, name):
    got = render_gallery.tpu_render({"preset": preset, "width": size[0], "height": size[1], "spp": 500})
    assert (os.path.basename(got) if got else None) == name


@pytest.mark.parametrize("seed0_mad,seed1_mad,failed", [(0.1, 1.3, 0), (0.7, 1.3, 1), (0.1, 0.6, 1)])
def test_tpu_gate_and_its_wrong_pairing(small_render, seed0_mad, seed1_mad, failed):
    """MAD(seed 0, TPU) must be under half the noise (here 1.3), and
    MAD(seed 1, TPU) must not."""
    def stats(mad):
        return render_gallery.Stats(mad, 0.0, 1.0, 2.0, 3.0, 0.5, 0.0)

    art, _ = small_render
    c = render_gallery.PresetCheck(art, art, "tpu.png", None, stats(seed0_mad), stats(seed1_mad), 1.3)
    assert len(c.failures) == failed


# --- sweep_sched ---------------------------------------------------------------------


@pytest.mark.parametrize("text,want", [("128:30:2", (128, 30, 2)), ("256:12:6", (256, 12, 6)),
                                       ("100:30:2", None), ("128:0:2", None), ("128:30", None), ("a:b:c", None)])
def test_sweep_parser(text, want):
    if want is None:
        with pytest.raises(ValueError):
            sweep_sched.parse_config(text)
    else:
        assert sweep_sched.parse_config(text) == want


def test_sweep_default_grid():
    grid = sweep_sched.DEFAULT_GRID
    assert grid[0] == (128, 30, 2) and len(set(grid)) == len(grid) == 14
    for budget, passes in sweep_sched.JAX_PAIRS:
        assert (128, budget, passes) in grid and (256, budget, passes) in grid
    assert {b for t, b, p in grid if (t, p) == (128, 2)} == {15, 20, 30, 45}


def test_sweep_images_are_bit_identical():
    """Two schedules of the plain version at 32x16, spp 2, depth 4: the
    same bits as the default schedule (the sweep raises otherwise)."""
    cam = make_camera(image_width=32, aspect_ratio=2.0, samples_per_pixel=2, max_depth=4, device="cpu")
    results = sweep_sched.sweep(scene_lib.cover_scene(0, device="cpu"), cam, [(128, 2, 3), (256, 30, 1)], reps=1)
    assert [(r.tile, r.budget, r.passes) for r in results] == [(128, 2, 3), (256, 30, 1)]
    assert all(r.launches == 0 and len(r.times_s) == 1 and r.mrays_per_s > 0 for r in results)
