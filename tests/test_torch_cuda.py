"""The CUDA kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU with nvcc (they build csrc/ on first use)
and skip without one. They repeat phases 3-5, 7a, 8 and 9 of
chip_smoke.py (7a: the replay kernel's records and the reverse kernel's
events against their plain versions; 12b: the milestone scenes; 15c: the jnp
backend's threefry_render_kernel, in any pixel order; 16b: the keyed step's
recording forward and per-path reverse), check that the wrappers refuse
what the kernels do not take, and read the sweep kernels' occupancy.
On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import dataclasses

import pytest
import torch

from ray_tracing_in_one_weekend_tpu_torch.models import milestones
from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.models.camera import make_camera
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
from ray_tracing_in_one_weekend_tpu_torch.utils import compare

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU interpret mode)")
    return torch.device("cuda", 0)


def _cam(dev, **kw):
    kw = {"image_width": 64, "aspect_ratio": 2.0, "samples_per_pixel": 4, "max_depth": 8, **kw}
    return make_camera(device=dev, **kw)


def _inputs(scene, cam):
    n = cam.image_width * cam.image_height
    sf, si = cr._init_state(0, -(-n // 128) * 128, n, cam.samples_per_pixel, scene.device)
    return cr.pack_scene(scene), cr.pack_camera(cam), sf, si, n


def test_kernel_matches_plain_one_pass(dev):
    """A budgeted pass from fresh state, then an unbudgeted one from where
    it stopped: at most 2% flipped lanes, block means within the mode-check
    thresholds. (Built without FMA contraction, they are bit-identical on
    an H100.)"""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    scene = scene_lib.cover_scene_reference(device=dev)
    cam = _cam(dev)
    spp, depth = cam.samples_per_pixel, cam.max_depth
    p_mat, cam_vec, sf, si, n = _inputs(scene, cam)
    for budget in (3, spp * depth):
        args = (cam_vec, (0, 0, 0, budget), sf, si, 128, spp, depth)
        before = build.LAUNCHES["render_kernel"]
        of_k, oi_k = build.render_pass(p_mat.T.contiguous(), *args)
        assert build.LAUNCHES["render_kernel"] == before + 1
        of_p, oi_p = cr._render_pass_plain(p_mat, *args)
        torch.cuda.synchronize()
        agree = compare.lane_states(of_k, oi_k, of_p, oi_p, n, spp)
        assert agree.flipped_frac <= 0.02, agree
        assert agree.blocks_agree, agree
        sf, si = of_p, oi_p


def test_sky_only_and_nan_as_miss(dev):
    scene = scene_lib.cover_scene_reference(device=dev)
    cam = _cam(dev)
    sky = scene.replace(active=torch.zeros_like(scene.active))
    img_k = cr.render_cuda(sky, cam)
    img_p = cr.render_with(cr._render_pass_plain, sky, cam)
    assert float((img_k - img_p).abs().max()) <= 1e-6
    up = _cam(dev, lookfrom=(0.0, 50.0, 0.0), lookat=(0.0, 100.0, 0.0), vup=(1.0, 0.0, 0.0))
    img, work = cr.render_cuda(scene, up, return_work=True)
    assert bool(torch.isfinite(img).all())
    assert bool((work == up.samples_per_pixel).all()), "a sky-bound ray hit a sphere"
    assert float((img[..., 2] - 1.0).abs().max()) < 1e-5


def test_passes_bit_identical(dev):
    scene = scene_lib.cover_scene_reference(device=dev)
    cam = _cam(dev)
    one = cr.render_cuda(scene, cam, n_passes=1)
    assert torch.equal(cr.render_cuda(scene, cam, n_passes=3, budget=3), one)
    assert torch.equal(cr.render_cuda(scene, cam, tile=256), one)


def test_builders_default_to_the_card(dev):
    """Called without `device`, the library builds on the card, so
    render_cuda launches the kernel there."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    scene, cam = scene_lib.cover_scene(0), make_camera(image_width=64, aspect_ratio=2.0,
                                                       samples_per_pixel=1, max_depth=4)
    assert scene.device.type == "cuda" and cam.center.device.type == "cuda"
    before = build.LAUNCHES["render_kernel"]
    assert cr.render_cuda(scene, cam).device.type == "cuda"
    assert build.LAUNCHES["render_kernel"] > before


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    scene = scene_lib.three_sphere_scene(pad_to=128, device=dev)
    p_mat, cam_vec, sf, si, _ = _inputs(scene, _cam(dev))
    table = p_mat.T.contiguous()
    args = (cam_vec, (0, 0, 0, 4), sf, si, 128, 4, 8)
    with pytest.raises(ValueError, match="contiguous"):
        build.render_pass(p_mat.T, *args)
    with pytest.raises(TypeError, match="dtype"):
        build.render_pass(table, cam_vec, (0, 0, 0, 4), sf, si.float(), 128, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        build.render_pass(table.cpu(), cam_vec.cpu(), (0, 0, 0, 4), sf.cpu(), si.cpu(), 128, 4, 8)
    for tile in (100, 1024):
        with pytest.raises(ValueError, match="tile"):
            build.render_pass(table, cam_vec, (0, 0, 0, 4), sf, si, tile, 4, 8)
    # The sweep table takes 16 bytes a sphere of the block's default 48 KB.
    big = cr.pack_scene(scene_lib.three_sphere_scene(pad_to=4096, device=dev)).T.contiguous()
    with pytest.raises(ValueError, match="shared-memory"):
        build.render_pass(big, *args)


def test_kernel_bit_identical_on_ties_and_ragged_slot_counts(dev):
    """`probes.tie_scene` (11 slots: exact ties inside the sweep's first
    group of 8 and in its remainder) and the same scene cut to 9, 5 and 3
    slots: the kernel's lane state after one pass and its image equal the
    plain version's bit for bit, and no duplicate ever wins a tie."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.probes import (
        first_slots,
        tie_camera,
        tie_scene,
        without_duplicates,
    )

    ties, cam = tie_scene(dev), tie_camera(dev)
    spp, depth = cam.samples_per_pixel, cam.max_depth
    for n_slots in (11, 9, 5, 3):
        scene = first_slots(ties, n_slots)
        p_mat, cam_vec, sf, si, _ = _inputs(scene, cam)
        args = (cam_vec, (0, 0, 0, spp * depth), sf, si, 128, spp, depth)
        of_k, oi_k = build.render_pass(p_mat.T.contiguous(), *args)
        of_p, oi_p = cr._render_pass_plain(p_mat, *args)
        torch.cuda.synchronize()
        assert torch.equal(of_k.view(torch.int32), of_p.view(torch.int32)) and torch.equal(oi_k, oi_p)
        img = cr.render_cuda(scene, cam)
        assert torch.equal(img, cr.render_with(cr._render_pass_plain, scene, cam))
        assert torch.equal(img, cr.render_cuda(without_duplicates(scene), cam))


def test_blocks_per_sm_at_every_tile(dev):
    """The CUDA runtime's occupancy of the three sweep kernels: at least one
    resident block at every tile the wrappers accept, for the cover scene's
    512 slots and for the largest scene they take; at tile 128 no fewer
    blocks than the 64-register cap allows (8)."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    lib = build.load()
    for kernel, most in (("render_kernel", lib.rt_render_max_spheres()),
                         ("grad_replay", lib.rt_replay_max_spheres())):
        max_tile = lib.rt_max_tile() if kernel == "render_kernel" else lib.rt_max_grad_tile()
        for tile in range(128, max_tile + 1, 128):
            for n in (512, most):
                assert build.blocks_per_sm(kernel, tile, n) >= 1, (kernel, tile, n)
        assert build.blocks_per_sm(kernel, 128, 512) >= 8, kernel
    assert build.blocks_per_sm("sweep_probe", 128, lib.rt_sweep_probe_max_spheres()) >= 1
    assert build.blocks_per_sm("sweep_probe", 128, 512) >= 8


def test_hand_adjoint_matches_autograd_of_bounce_f(dev):
    """grad_device.cuh's adjoint against torch.autograd of the plain
    `_bounce_f` on every continuing bounce of the cover scene at 64x32,
    spp 4, depth 8, with random output cotangents: relative L2 <= 3e-5 on
    each of the four input cotangents (chip_smoke.py phase 7a's gate)."""
    from ray_tracing_in_one_weekend_tpu_torch.probes import adjoint_errors

    m, errs = adjoint_errors(scene_lib.cover_scene_reference(device=dev), _cam(dev))
    assert m > 1000
    for name, e in errs.items():
        assert e <= 3e-5, (name, e)


def test_gradients_reproducible_across_runs_and_tiles(dev):
    """The kernels' gradient is the same bits run after run and for
    bwd_tile 128 and 256 (no float atomics; record slots fixed by the
    pixel ids; a fixed reduction order), and agrees with the plain version
    on the card per field to 2e-4 relative L2 (chip_smoke.py phase 7a's
    gate)."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
    from ray_tracing_in_one_weekend_tpu_torch.probes import rel_l2

    scene = scene_lib.cover_scene_reference(device=dev)
    cam = _cam(dev)
    target = torch.zeros(cam.image_height, cam.image_width, 3, device=dev)
    params = cg.scene_params(scene)
    before = {k: build.LAUNCHES[k] for k in ("grad_replay", "grad_reverse", "grad_reduce")}
    _, g1 = cg.render_grads_cuda(params, scene, cam, target)
    assert all(build.LAUNCHES[k] == v + 1 for k, v in before.items()), build.LAUNCHES
    _, g2 = cg.render_grads_cuda(params, scene, cam, target)
    _, g3 = cg.render_grads_cuda(params, scene, cam, target, bwd_tile=256)
    img, work = cg.render_cuda_diff(scene, cam, return_work=True)
    n = cam.num_pixels
    pix, g = cg._bwd_lanes(work.reshape(-1), (2.0 / (3 * n) * img).reshape(n, 3).T, 4, 128)
    p_mat, cam_vec = cr.pack_scene(scene), cr.pack_camera(cam)
    gp = cg.params_vjp(scene, cg._grad_pass_plain(p_mat, cam_vec, (0, 0, 0, n), pix, g, 4, 8))
    for k in cg.DIFF_FIELDS:
        assert torch.equal(g1[k], g2[k]) and torch.equal(g1[k], g3[k]), k
        assert bool(torch.isfinite(g1[k]).all()), k
        assert rel_l2(g1[k], gp[k]) <= 2e-4, (k, rel_l2(g1[k], gp[k]))


def _grad_inputs(scene, dev, tile=128):
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
    from ray_tracing_in_one_weekend_tpu_torch.probes import random_cotangent

    cam = _cam(dev)
    n = cam.num_pixels
    p_mat, cam_vec = cr.pack_scene(scene), cr.pack_camera(cam)
    _, work = cr.render_cuda(scene, cam, return_work=True)
    work = work.reshape(-1)
    pix, g = cg._bwd_lanes(work, random_cotangent((3, n), 1, dev), 4, tile)
    return p_mat, cam_vec, (0, 0, 0, n), pix, g, work


# (n_events, n_spheres, winners): "mixed" as probes.synthetic_events makes
# them, "none" every winner -1, "one" every event sphere n_spheres - 1's.
_REDUCE_CASES = [
    (0, 512, "mixed"), (1000, 512, "none"), (3 * 8192 + 77, 512, "one"), (3 * 8192 + 77, 1, "mixed"),
    (3 * 8192 + 77, 512, "mixed"), (2 * 8192 + 5, 1024, "mixed"), (8192 + 128 * 3, 37, "mixed"),
    (129, 512, "mixed"),
]


@pytest.mark.parametrize("n_events,n_spheres,winners", _REDUCE_CASES)
def test_grad_reduce_equals_ordered_plain(dev, n_events, n_spheres, winners):
    """`grad_reduce` is `_reduce_events_ordered` bit for bit: empty input,
    no winner, one sphere taking every event, 1, 37, 512 and 1024 spheres,
    event counts that are no multiple of the stage (128) or the chunk."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
    from ray_tracing_in_one_weekend_tpu_torch.probes import synthetic_events

    ev = synthetic_events(n_events, n_spheres, seed=n_events + n_spheres)
    if winners != "mixed":
        ev.view(torch.int32)[:, 0] = -1 if winners == "none" else n_spheres - 1
    ev = ev.to(dev)
    got = build.grad_reduce(ev, n_spheres)
    want = cg._reduce_events_ordered(ev, n_spheres)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(build.grad_reduce(ev, n_spheres).view(torch.int32), got.view(torch.int32))
    assert not got.view(torch.int32)[[4, 10, 11]].any()


def test_chunk_events_match_the_kernel(dev):
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg

    lib = build.load()
    assert lib.rt_chunk_events() == cg.CHUNK_EVENTS
    walk = (lib.rt_reduce_stage_events(), lib.rt_reduce_warps(), lib.rt_reduce_fold_round())
    assert walk == (cg.REDUCE_STAGE_EVENTS, cg.REDUCE_WARPS, cg.REDUCE_FOLD_ROUND)
    assert build.blocks_per_sm("grad_reduce_chunks", 256, 1024) >= 1


def test_replay_kernel_matches_plain_records(dev):
    """grad_replay_kernel's records against `_replay_records_plain` at
    64x32, spp 4, depth 8 on the cover scene: all 16 words bit-identical
    (both take the forward's arithmetic, built without contraction), and
    the same slots."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg

    p_mat, cam_vec, scalars, pix, _, work = _grad_inputs(scene_lib.cover_scene_reference(device=dev), dev)
    before = build.LAUNCHES["grad_replay"]
    got = build.grad_replay(p_mat.T.contiguous(), cam_vec, scalars, pix, work, 128, 4, 8)
    assert build.LAUNCHES["grad_replay"] == before + 1
    want = cg._replay_records_plain(p_mat, cam_vec, scalars, pix, 4, 8)
    torch.cuda.synchronize()
    assert torch.equal(got.ev_start, want.ev_start) and torch.equal(got.ev_count, want.ev_count)
    assert torch.equal(got.records.view(torch.int32), want.records.view(torch.int32))


def test_reverse_kernel_matches_plain_events(dev):
    """grad_reverse_kernel's events against `_reverse_records_plain` on the
    same records: winners equal, cotangent words within 2e-4 relative L2
    (chip_smoke.py's EVENT_GATE, set from the error's growth with the
    distance from a path's end). The records become the events in place
    and the Replay is consumed."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
    from ray_tracing_in_one_weekend_tpu_torch.probes import rel_l2

    p_mat, cam_vec, scalars, pix, g, work = _grad_inputs(scene_lib.cover_scene_reference(device=dev), dev)
    table = p_mat.T.contiguous()
    replay = build.grad_replay(table, cam_vec, scalars, pix, work, 128, 4, 8)
    want = cg._reverse_records_plain(p_mat, cam_vec, replay, g)
    before, records = build.LAUNCHES["grad_reverse"], replay.records
    got = build.grad_reverse(table, cam_vec, replay, g, 128)
    assert build.LAUNCHES["grad_reverse"] == before + 1
    assert got.data_ptr() == records.data_ptr() and replay.records is None  # in place, consumed
    torch.cuda.synchronize()
    assert torch.equal(got[:, 0].view(torch.int32), want[:, 0].view(torch.int32))
    assert int((got[:, 0].view(torch.int32) >= 0).sum()) > 1000
    assert bool(torch.isfinite(got[:, 1:]).all())
    assert rel_l2(got[:, 1:14], want[:, 1:14]) <= 2e-4


def test_grad_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    p_mat, cam_vec, scalars, pix, g, work = _grad_inputs(scene_lib.three_sphere_scene(pad_to=128, device=dev), dev)
    table = p_mat.T.contiguous()
    args = (cam_vec, scalars, pix, work, 128, 4, 8)
    replay = build.grad_replay(table, *args)
    assert replay.records.shape == (int(work.sum()), 16)
    with pytest.raises(ValueError, match="contiguous"):
        build.grad_replay(p_mat.T, *args)
    with pytest.raises(TypeError, match="dtype"):
        build.grad_replay(table, cam_vec, scalars, pix.long(), work, 128, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        build.grad_replay(table.cpu(), cam_vec.cpu(), scalars, pix.cpu(), work.cpu(), 128, 4, 8)
    for tile in (100, 1024):
        with pytest.raises(ValueError, match="tile"):
            build.grad_replay(table, cam_vec, scalars, pix, work, tile, 4, 8)
        with pytest.raises(ValueError, match="tile"):
            build.grad_reverse(table, cam_vec, replay, g, tile)
    with pytest.raises(ValueError, match="whole bounce counts"):
        build.grad_replay(table, cam_vec, scalars, pix, work + 0.5, 128, 4, 8)
    with pytest.raises(RuntimeError, match="diverged"):
        build.grad_replay(table, cam_vec, scalars, pix, work + 1.0, 128, 4, 8)
    big = cr.pack_scene(scene_lib.three_sphere_scene(pad_to=4096, device=dev)).T.contiguous()
    with pytest.raises(ValueError, match="shared-memory"):
        build.grad_replay(big, *args)
    with pytest.raises(ValueError, match="CUDA"):
        build.grad_reverse(table, cam_vec, replay, g.cpu(), 128)
    with pytest.raises(ValueError, match="shape"):
        build.grad_reverse(table, cam_vec, replay, g[:, :128].contiguous(), 128)
    with pytest.raises(TypeError, match="dtype"):
        build.grad_reverse(table, cam_vec, dataclasses.replace(replay, ev_count=replay.ev_count.long()), g, 128)
    # A slot range outside the records is left alone, not written past
    # (compared as int32 words: a winner of -1 reads as NaN).
    outside = build.Replay(replay.records.clone(), replay.ev_start + replay.records.shape[0], replay.ev_count)
    kept = outside.records.view(torch.int32).clone()
    assert torch.equal(build.grad_reverse(table, cam_vec, outside, g, 128).view(torch.int32), kept)
    assert build.grad_reverse(table, cam_vec, replay, g, 128).shape == (int(work.sum()), 16)
    with pytest.raises(ValueError, match="reversed already"):
        build.grad_reverse(table, cam_vec, replay, g, 128)


def test_scheduler_bit_identical_on_the_card(dev):
    """Compaction, a work_hint and a warm cache hit are lane permutations:
    the kernel's image is the same bits as one pixel-order pass."""
    scene = scene_lib.cover_scene_reference(device=dev)
    cam = _cam(dev)
    cr._WORK_CACHE.clear()
    one, work = cr.render_cuda(scene, cam, n_passes=1, warm=False, return_work=True)
    assert torch.equal(cr.render_cuda(scene, cam, n_passes=3, warm=False), one)
    assert torch.equal(cr.render_cuda(scene, cam, n_passes=3, budget=(5, 2), warm=False), one)
    assert torch.equal(cr.render_cuda(scene, cam, work_hint=work), one)
    assert torch.equal(cr.render_cuda(scene, cam), one)  # fills the cache
    assert cr.warm_cache_hit(scene, cam)
    assert torch.equal(cr.render_cuda(scene, cam), one)  # the hit


@pytest.mark.parametrize("name", ["chain_fma", "fma_peak", "sweep_probe", "gather_probe", "skinny_probe",
                                  "skinny_probe_default"])
def test_probe_kernel_matches_plain(dev, name):
    """Each probe kernel against its plain version at 256 columns and at
    196, a ragged last block (12.25 gather blocks of 16 columns, 24.5
    skinny blocks of 8), within its gate (probes/kernel_parts.py GATES,
    chip_smoke.py phase 9)."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.probes import kernel_parts as kp

    torch.backends.cuda.matmul.allow_tf32 = False
    reps = 64 if name == "chain_fma" else 4
    for tile in (256, 196):
        args = kp.inputs(name, tile, dev)
        before = build.LAUNCHES[name]
        got = kp.run(name, args, reps)
        assert build.LAUNCHES[name] == before + 1
        want = kp.run_plain(name, args, reps)
        torch.cuda.synchronize()
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        err = kp.error(name, got, want)
        assert err <= kp.GATES[name], (name, tile, err)


def test_probe_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.probes import kernel_parts as kp

    (x,) = kp.inputs("fma_peak", 128, dev)
    with pytest.raises(ValueError, match="CUDA"):
        build.fma_peak(x.cpu(), 2)
    with pytest.raises(ValueError, match="shape"):
        build.fma_peak(x[:32], 2)
    with pytest.raises(ValueError, match="reps"):
        build.fma_peak(x, 0)
    p, oh = kp.inputs("gather_probe", 128, dev)
    with pytest.raises(TypeError, match="dtype"):
        build.gather_probe(p.double(), oh, 2)
    # The kernels hold P's and L's fragments in the registers of 8 warps.
    for n in (1024, 100):
        with pytest.raises(ValueError, match="a multiple of 8, at most 512"):
            build.gather_probe(torch.zeros(16, n, device=dev), torch.zeros(n, 128, device=dev), 2)
    table, o, d = kp.inputs("sweep_probe", 128, dev)
    with pytest.raises(ValueError, match="contiguous"):
        build.sweep_probe(table.T.contiguous().T, o, d, 2, 1e-3)
    l, r = kp.inputs("skinny_probe", 128, dev)
    for fn in (build.skinny_probe, build.skinny_default_probe):
        for m in (2048, 1000):
            with pytest.raises(ValueError, match="a multiple of 16, at most 1024"):
                fn(torch.zeros(m, 8, device=dev), r, 2)
        with pytest.raises(TypeError, match="dtype"):
            fn(l.bfloat16(), r, 2)


def test_batched_accumulation_kernel_equals_plain(dev, monkeypatch):
    """The long render's accumulation (utils/checkpoint.py) through the
    kernel and through the plain version, batch for batch: the same bits,
    with one or more kernel launches a batch."""
    import functools

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.utils import checkpoint as ckpt

    scene = scene_lib.cover_scene_reference(device=dev)
    cam = _cam(dev, samples_per_pixel=16)

    def accumulate():
        state, launches = ckpt.new_state(cam, device=dev), []
        for n in (5, 1, 10):
            before = build.LAUNCHES["render_kernel"]
            state = ckpt.accumulate(state, scene, cam, 3, n)
            launches.append(build.LAUNCHES["render_kernel"] - before)
        return state, launches

    kernel, launches = accumulate()
    assert kernel.spp_done == 16 and min(launches) >= 1
    monkeypatch.setattr(ckpt, "render_cuda", functools.partial(cr.render_with, cr._render_pass_plain))
    plain, launches = accumulate()
    assert launches == [0, 0, 0]
    assert torch.equal(kernel.accum, plain.accum) and torch.equal(kernel.work, plain.work)


def test_sample_offset_kernel_equals_plain(dev):
    """A render of samples [5, 9) (sample_offset 5) through the kernel has
    the plain version's bits, and is not the render of samples [0, 4)."""
    scene = scene_lib.cover_scene_reference(device=dev)
    cam = _cam(dev)
    img = cr.render_cuda(scene, cam, seed=2, sample_offset=5, warm=False)
    assert torch.equal(img, cr.render_with(cr._render_pass_plain, scene, cam, seed=2, sample_offset=5,
                                           warm=False))
    assert not torch.equal(img, cr.render_cuda(scene, cam, seed=2, warm=False))


def test_checked_render_catches_a_nan_center_on_the_card(dev):
    from ray_tracing_in_one_weekend_tpu_torch.utils import debug

    scene = scene_lib.single_sphere_scene(pad_to=8, device=dev)
    cam = _cam(dev, samples_per_pixel=2, max_depth=4)
    err, img = debug.checked_render(scene, cam, 0)
    err.throw()
    center = scene.center.clone()
    center[0, 0] = float("nan")
    err, img = debug.checked_render(scene.replace(center=center), cam, 0)
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    with pytest.raises(FloatingPointError, match=r"scene\.center"):
        err.throw()


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)], ids=["2x1", "1x2"])
def test_sharded_render_and_step_on_the_card(dev, tmp_path, mesh):
    """Two ranks sharing the card over gloo (`parallel/worker.py`): the
    sharded image is `render_cuda`'s (pixel mesh) or the rank-order
    composite of the sample windows (sample mesh) bit for bit, the sharded
    gradients within rtol 2e-5, atol 1e-6 of one device's, and every rank
    launched the forward and the three backward kernels."""
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
    from ray_tracing_in_one_weekend_tpu_torch.parallel import worker

    scene = scene_lib.cover_scene_reference(device=dev)
    cam = _cam(dev)
    spec = {"scene": worker.scene_spec(scene), "camera": worker.camera_spec(cam), "mesh": mesh}
    ranks = worker.launch([{"job": "render", **spec}, {"job": "step", **spec}], 2, tmp_path,
                          device="cuda", timeout=300.0)
    if mesh[1] == 1:
        want = cr.render_cuda(scene, cam)
    else:
        wins = [cr.render_cuda(scene, cam, spp=2, sample_offset=s) for s in (0, 2)]
        want = (wins[0] + wins[1]) / 2
    target = torch.zeros(cam.image_height, cam.image_width, 3, device=dev)
    loss, grads = cg.render_grads_cuda(cg.scene_params(scene), scene, cam, target)
    for render, step in ranks:
        assert render["backend"] == "gloo"
        assert torch.equal(render["image"], want.cpu())
        assert abs(float(step["loss"]) - float(loss)) <= 1e-6 * float(loss)
        for k, g in grads.items():
            torch.testing.assert_close(step["grads"][k], g.cpu(), rtol=2e-5, atol=1e-6)
        assert render["launches"]["render_kernel"] > 0
        for name in ("render_kernel", "grad_replay", "grad_reverse", "grad_reduce"):
            assert step["launches"][name] > 0, name


def test_dryrun_multichip_on_the_card(dev):
    from ray_tracing_in_one_weekend_tpu_torch import entry

    res = entry.dryrun_multichip(2, device="cuda", timeout=300.0)
    assert res["mesh"] == (2, 1) and res["losses"][0] > 0.0


@pytest.mark.parametrize("name", milestones.MILESTONE_RENDERS)
def test_milestone_kernel_equals_plain(dev, name):
    """Each milestone scene and camera of the final integrator (a negative
    radius, the 90-degree pinhole, the aperture lens, 1-5 active spheres in
    128 slots, the sky alone) through the kernel, bit-identical to the
    plain version at 64 wide, spp 4, depth 8."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    scene, cam = milestones.milestone_render(name, image_width=64, spp=4, max_depth=8, device=dev)
    before = build.LAUNCHES["render_kernel"]
    img_k = cr.render_cuda(scene, cam, warm=False)
    assert build.LAUNCHES["render_kernel"] > before
    img_p = cr.render_with(cr._render_pass_plain, scene, cam, warm=False)
    assert bool(torch.isfinite(img_k).all())
    assert torch.equal(img_k, img_p)


def test_threefry_kernel_matches_plain(dev):
    """threefry_render_kernel against render_flat_threefry on the card: the
    whole 64x32 image (spp 4, depth 8) and a pixel subset at a sample
    window, on the JAX cover scene and the reference's, bit for bit; one
    launch a call; render_image and accumulate(backend="jnp") go through
    it."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_threefry as ct
    from ray_tracing_in_one_weekend_tpu_torch.ops import render as pr
    from ray_tracing_in_one_weekend_tpu_torch.utils import checkpoint as ckpt

    cam = _cam(dev)
    pix = torch.arange(cam.num_pixels, device=dev)
    for scene in (scene_lib.cover_scene(0, device=dev), scene_lib.cover_scene_reference(device=dev)):
        before = build.LAUNCHES["threefry_render_kernel"]
        k = ct.render_kernel_pixels(scene, cam, pix, 3)
        assert build.LAUNCHES["threefry_render_kernel"] == before + 1
        assert torch.equal(k, pr.render_flat_threefry(scene, cam, pix, 3))
        sub = pix[::7]
        assert torch.equal(ct.render_kernel_pixels(scene, cam, sub, 3, spp=2, sample_offset=5),
                           pr.render_flat_threefry(scene, cam, sub, 3, spp=2, sample_offset=5))
        assert torch.equal(pr.render_image(scene, cam, 3).reshape(-1, 3), k)
        state = ckpt.accumulate(ckpt.new_state(cam, device=dev), scene, cam, 3, 4, backend="jnp")
        assert torch.equal(state.accum, (k * 4.0).reshape(state.accum.shape))


def test_threefry_kernel_is_the_same_in_any_pixel_order(dev):
    """The persistent grid takes pixels from a queue, so threads meet them
    in another order each launch: the 64x32 image (spp 4, depth 8) in
    identity, reversed and random order, and over fewer pixels than one
    block, gives the same bits and work map after un-permuting, equal to
    the plain version's."""
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_threefry as ct
    from ray_tracing_in_one_weekend_tpu_torch.ops import render as pr

    cam = _cam(dev)
    scene = scene_lib.cover_scene(0, device=dev)
    pix = torch.arange(cam.num_pixels, device=dev)
    image, work = ct.render_kernel_pixels(scene, cam, pix, 3, return_work=True)
    plain, plain_work = pr.render_flat_threefry(scene, cam, pix, 3, return_work=True)
    assert torch.equal(image, plain) and torch.equal(work, plain_work)
    gen = torch.Generator().manual_seed(0)
    for order in (pix.flip(0), torch.randperm(cam.num_pixels, generator=gen).to(dev), pix[:77].flip(0)):
        got, got_work = ct.render_kernel_pixels(scene, cam, order, 3, return_work=True)
        assert torch.equal(got, image[order]) and torch.equal(got_work, work[order])


def test_threefry_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    scene = scene_lib.cover_scene(0, device=dev)
    table, cam_vec = cr.pack_scene(scene).T.contiguous(), cr.pack_camera(_cam(dev))
    pix = torch.arange(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="CUDA tensors"):
        build.threefry_render(table.cpu(), cam_vec.cpu(), pix.cpu(), (0, 0), 0, 1, 2)
    with pytest.raises(TypeError, match="dtype"):
        build.threefry_render(table, cam_vec, pix.long(), (0, 0), 0, 1, 2)
    with pytest.raises(ValueError, match="uint32"):
        build.threefry_render(table, cam_vec, pix, (1 << 32, 0), 0, 1, 2)
    # The kernel's depth cut-off is `depth + 1 == max_depth`: 0 would never end a path.
    for spp, depth in ((0, 2), (1, 0)):
        with pytest.raises(ValueError, match="must be >= 1"):
            build.threefry_render(table, cam_vec, pix, (0, 0), 0, spp, depth)
    big = torch.zeros(4096, 16, device=dev)
    with pytest.raises(ValueError, match="do not fit"):
        build.threefry_render(big, cam_vec, pix, (0, 0), 0, 1, 2)


def _keyed_world(dev):
    cam = _cam(dev)
    scene = scene_lib.cover_scene(0, device=dev)
    pix = torch.arange(cam.num_pixels, device=dev)
    return scene, cam, pix, cr.pack_scene(scene), cr.pack_camera(cam)


def test_keyed_record_and_reverse_match_plain(dev):
    """threefry_record_kernel on the 64x32 image (spp 4, depth 8) of the JAX
    cover scene, in identity and reversed pixel order: its image and work
    map threefry_render_kernel's bits, its records in logical order
    (links and `path_slots`) `replay_records_plain`'s words 0-13 bit for
    bit, its path counts the plain recording's; threefry_reverse_kernel's
    events against `reverse_records_plain`'s: winners equal, cotangent
    words within 3e-5 relative L2 (chip_smoke.py's ADJOINT_GATE); an arena
    too small re-records once in `threefry_grad_pass`, with the same
    gradient bits."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_threefry as ct
    from ray_tracing_in_one_weekend_tpu_torch.probes import random_cotangent, rel_l2

    scene, cam, pix, p_mat, cam_vec = _keyed_world(dev)
    table, n = p_mat.T.contiguous(), cam.num_pixels
    plain = ct.replay_records_plain(scene, cam, pix, 3)
    _, _, plain_rec = ct.record_plain(scene, cam, pix, 3)
    g = random_cotangent((3, n), 1, dev) / 4
    want = ct.reverse_records_plain(p_mat, cam_vec, plain, g)
    for order in (pix, pix.flip(0)):
        args = (table, cam_vec, order.to(torch.int32), (0, 3), 0, 4, 8)
        ref, ref_work = build.threefry_render(*args, work=True)
        before = build.LAUNCHES["threefry_record"]
        out, work, rec = build.threefry_record(*args)
        assert build.LAUNCHES["threefry_record"] == before + 1
        assert torch.equal(out, ref) and torch.equal(work, ref_work)
        assert int(rec.path_count.sum()) == plain.records.shape[0] and int(rec.total) <= rec.capacity
        slots, n_events = build.path_slots(rec.pix, rec.path_count, 4, 0, n)
        got = ct.records_in_logical_order(rec, slots, int(n_events))
        assert torch.equal(got.view(torch.int32)[:, :14], plain.records.view(torch.int32)[:, :14])
        if order is pix:
            assert torch.equal(rec.path_count.cpu(), plain_rec.path_count.cpu())
            events = build.threefry_reverse(rec, slots, int(n_events), g, int(rec.total))
            assert torch.equal(events[:, 0].view(torch.int32), want[:, 0].view(torch.int32))
            assert rel_l2(events[:, 1:14], want[:, 1:14]) <= 3e-5
            grads = build.threefry_grad_pass(rec, g, 0, n)
    _, _, small = build.threefry_record(table, cam_vec, pix.to(torch.int32), (0, 3), 0, 4, 8, capacity=64)
    before = build.LAUNCHES["threefry_record_rerun"]
    assert torch.equal(build.threefry_grad_pass(small, g, 0, n), grads)
    assert build.LAUNCHES["threefry_record_rerun"] == before + 1


def test_keyed_render_grads_on_the_card(dev):
    """`parallel.dist.render_grads` on a CUDA scene runs the recording
    forward, the reverse and the reduction, once each, and neither
    threefry_render_kernel nor a re-run; its loss is that of the forward
    kernel's image bit for bit, and its gradients within 2e-4 relative L2
    a field (chip_smoke.py's GRAD_GATE) of `render_grads_autograd`'s, which
    launches nothing; bit-identical run to run."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import render as pr
    from ray_tracing_in_one_weekend_tpu_torch.parallel import dist
    from ray_tracing_in_one_weekend_tpu_torch.probes import rel_l2

    scene, cam = scene_lib.cover_scene(0, device=dev), _cam(dev, samples_per_pixel=2)
    target = torch.zeros(cam.image_height, cam.image_width, 3, device=dev)
    build.reset_launches()
    loss, grads = dist.render_grads(dist.scene_params(scene), scene, cam, target, 0)
    assert all(build.LAUNCHES[k] == 1 for k in ("threefry_record", "threefry_reverse", "grad_reduce")), build.LAUNCHES
    assert build.LAUNCHES["threefry_render_kernel"] == 0 and build.LAUNCHES["threefry_record_rerun"] == 0
    assert torch.equal(loss, torch.mean((pr.render_image(scene, cam, 0) - target) ** 2))
    loss2, grads2 = dist.render_grads(dist.scene_params(scene), scene, cam, target, 0)
    assert torch.equal(loss2, loss) and all(torch.equal(grads2[k], grads[k]) for k in grads)
    build.reset_launches()
    loss_a, grads_a = dist.render_grads_autograd(dist.scene_params(scene), scene, cam, target, 0)
    assert sum(build.LAUNCHES.values()) == 0
    assert torch.equal(loss_a, loss)
    for k in dist.DIFF_FIELDS:
        assert rel_l2(grads[k], grads_a[k]) <= 2e-4, k


def test_keyed_backward_twice_through_a_retained_graph(dev):
    """A second backward through a graph kept by retain_graph=True records
    the same paths again on the card (the first backward took the arena):
    one more recording forward, reverse and reduction, no plain route, and
    the first backward's gradient bits."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.parallel import dist

    scene, cam = scene_lib.cover_scene(0, device=dev), _cam(dev, samples_per_pixel=2)
    target = torch.zeros(cam.image_height, cam.image_width, 3, device=dev)
    params = {k: v.detach().requires_grad_() for k, v in dist.scene_params(scene).items()}
    loss = dist.render_loss(params, scene, cam, target, 0)
    first = torch.autograd.grad(loss, list(params.values()), retain_graph=True)
    build.reset_launches()
    second = torch.autograd.grad(loss, list(params.values()))
    assert all(build.LAUNCHES[k] == 1 for k in ("threefry_record", "threefry_reverse", "grad_reduce")), build.LAUNCHES
    assert build.LAUNCHES["threefry_render_kernel"] == 0 and build.LAUNCHES["threefry_record_rerun"] == 0
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_keyed_reverse_writes_every_event_of_a_broken_path(dev):
    """threefry_reverse_kernel on a recording with a cut link (a lit path
    whose last record links to -1) and a last record outside the arena:
    every event slot of both paths is written empty (winner -1, zero
    cotangent), none is left uninitialized, and every other path's events
    are the whole recording's bits."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.probes import random_cotangent

    scene, cam, pix, p_mat, cam_vec = _keyed_world(dev)
    table, n = p_mat.T.contiguous(), cam.num_pixels
    _, _, rec = build.threefry_record(table, cam_vec, pix.to(torch.int32), (0, 3), 0, 4, 8)
    rec = build.complete_recording(rec, int(rec.total))
    slots, n_events = build.path_slots(rec.pix, rec.path_count, 4, 0, n)
    n_events, total = int(n_events), int(rec.total)
    g = random_cotangent((3, n), 1, dev) / 4
    want = build.threefry_reverse(rec, slots, n_events, g, total)
    lit = rec.arena.view(torch.int32)[rec.path_last, 13] == 2  # ended at the sky
    a, b = torch.nonzero(lit & (rec.path_count >= 3)).reshape(-1)[:2].tolist()
    arena, path_last = rec.arena.clone(), rec.path_last.clone()
    arena.view(torch.int64)[rec.path_last[a], 7] = -1
    path_last[b] = rec.capacity
    for fill in (float("nan"), 7.0):  # the events buffer is torch.empty: leave junk in the block it reuses
        junk = torch.full((n_events, 16), fill, device=dev)
        del junk
        got = build.threefry_reverse(dataclasses.replace(rec, arena=arena, path_last=path_last), slots, n_events,
                                     g, total)
        broken = torch.zeros(n_events, dtype=torch.bool, device=dev)
        for k in (a, b):
            first, count = int(slots[k]), int(rec.path_count[k])
            broken[first : first + count] = True
        empty = torch.zeros(16, device=dev)
        empty.view(torch.int32)[0] = -1
        assert torch.equal(got[broken].view(torch.int32), empty.view(torch.int32).expand(int(broken.sum()), 16))
        assert torch.equal(got[~broken].view(torch.int32), want[~broken].view(torch.int32))


def test_keyed_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    scene, cam, pix, p_mat, cam_vec = _keyed_world(dev)
    table, n = p_mat.T.contiguous(), cam.num_pixels
    pix32 = pix.to(torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        build.threefry_record(table.cpu(), cam_vec.cpu(), pix32.cpu(), (0, 3), 0, 4, 8)
    with pytest.raises(ValueError, match="capacity"):
        build.threefry_record(table, cam_vec, pix32, (0, 3), 0, 4, 8, capacity=-1)
    _, _, rec = build.threefry_record(table, cam_vec, pix32, (0, 3), 0, 4, 8, capacity=16)
    slots, n_events = build.path_slots(rec.pix, rec.path_count, 4, 0, n)
    g = torch.zeros(3, n, device=dev)
    with pytest.raises(ValueError, match="record again"):
        build.threefry_reverse(rec, slots, int(n_events), g, int(rec.total))
    with pytest.raises(ValueError, match="shape"):
        build.threefry_reverse(rec, slots[1:], int(n_events), g, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        build.threefry_reverse(rec, slots, int(n_events), g.cpu(), 16)
