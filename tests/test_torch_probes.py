"""The probe kernels' plain versions against the JAX probe bodies, on the CPU.

scripts/perf_probe.py and scripts/kernel_parts_probe.py keep their Pallas
kernels as closures inside their functions, so each test rebuilds the
body here as a local `pl.pallas_call` in interpret mode (grid 1, no
memory spaces), as tests/test_pallas.py does for `_sweep_ts`, and runs it
at a tiny shape (tile 128, reps 2-4) on the same numpy inputs as the
port's plain version (`probes/kernel_parts.py`). The kernels themselves
are held against the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 9). Also here: the arithmetic the product kernels
rest on (3xTF32, emulated), the probes' bounds, and the warp-occupancy
arithmetic of `probes/perf_probe.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ray_tracing_in_one_weekend_tpu.models.scene import cover_scene as jax_cover_scene
from ray_tracing_in_one_weekend_tpu.ops import pallas_render as pr
from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.models.camera import make_camera
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
from ray_tracing_in_one_weekend_tpu_torch.probes import kernel_parts as kp
from ray_tracing_in_one_weekend_tpu_torch.probes import perf_probe as pp

torch.set_num_threads(2)

TILE = 128


def _interpret(kernel, out_shape, *args):
    return np.array(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        interpret=pltpu.InterpretParams(),
    )(*(jnp.asarray(a.numpy()) for a in args)))


def _fused_steps_rtol(steps):
    """JAX rounds the product and the sum of `acc * 1.0000001 + 1e-7`
    separately; the port (like the kernel, `__fmaf_rn`) rounds the fused
    step once. Each step may then differ by one float32 rounding (2^-24
    relative), and the multiplier is ~1, so errors add up at most
    linearly over the steps."""
    return steps * 2.0 ** -24


def test_chain_plain_matches_jax_kern():
    """scripts/perf_probe.py:47 `kern`: one dependent chain of 512 steps
    per element, the call repeated (x = f(x)); here 2 calls."""
    reps = 2

    def kern(x_ref, o_ref):
        acc = jax.lax.fori_loop(0, kp.CHAIN, lambda i, acc: acc * 1.0000001 + 0.0000001, x_ref[:, :])
        o_ref[:, :] = acc

    (x,) = kp.inputs("chain_fma", TILE, "cpu")
    theirs, ours = x, x
    for _ in range(reps):
        theirs = torch.from_numpy(_interpret(kern, (128, TILE), theirs))
        ours = kp.chain_fma(ours)
    assert float(ours.min()) > 1.0001  # the chain moved every element
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=_fused_steps_rtol(reps * kp.CHAIN), atol=0)


@pytest.mark.parametrize("chain", [kp.chain_design()["CHAIN_UNROLL"] + 1, 1000])
def test_chain_plain_matches_jax_kern_with_remainder(chain):
    """The same `kern` under fori_loop at a length that is no multiple of
    chain_fma_kernel's unrolled loop (its remainder loop runs), one call."""

    def kern(x_ref, o_ref):
        o_ref[:, :] = jax.lax.fori_loop(0, chain, lambda i, acc: acc * 1.0000001 + 0.0000001, x_ref[:, :])

    assert chain % kp.chain_design()["CHAIN_UNROLL"] != 0
    (x,) = kp.inputs("chain_fma", TILE, "cpu")
    theirs = _interpret(kern, (128, TILE), x)
    ours = kp.chain_fma(x, chain)
    assert float(ours.min()) > 1.0 + chain * 1e-7  # every step moved every element
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=_fused_steps_rtol(chain), atol=0)


def test_chain_design_is_read_from_the_source():
    """kernel_parts reads chain_fma_kernel's CHAIN_UNROLL and CHAIN_ELEMS
    from csrc/probe_kernels.cu, and refuses a text without both."""
    design = kp.chain_design()
    assert set(design) == {"CHAIN_ELEMS", "CHAIN_UNROLL"} and min(design.values()) >= 1
    assert kp.chain_design("constexpr int CHAIN_UNROLL = 16;\nconstexpr int CHAIN_ELEMS = 2;") == {
        "CHAIN_UNROLL": 16, "CHAIN_ELEMS": 2}
    with pytest.raises(ValueError):
        kp.chain_design("constexpr int CHAIN_ELEMS = 4;")


def _chain_sass():
    """chain_fma_kernel's shape: a grid-stride loop around an unrolled
    loop of 8 FFMAs a trip and a remainder loop of 2."""
    lines, a = [], 0

    def emit(text):
        nonlocal a
        lines.append(f"        /*{a:04x}*/                   {text} ;   /* 0x000000000000000000 */\n")
        a += 0x10

    outer = a
    emit("LDG.E R4, desc[UR4][R2.64]")
    head = a
    for _ in range(8):
        emit("FFMA R4, R4, R6, R7")
    emit("IADD3 R8, R8, -0x1, RZ")
    emit("ISETP.NE.AND P0, PT, R8, RZ, PT")
    emit(f"@P0 BRA 0x{head:x}")
    rem = a
    for _ in range(2):
        emit("FFMA R4, R4, R6, R7")
    emit(f"@P1 BRA 0x{rem:x}")
    emit("STG.E desc[UR4][R2.64], R4")
    emit(f"@P2 BRA 0x{outer:x}")
    emit("EXIT")
    return "\n\tcode for sm_90a\n\t\tFunction : _Z16chain_fma_kernelPKfPfxi\n" + "".join(lines)


def test_chain_reading_finds_the_unrolled_loop():
    """The reading takes the inner loop with the most FFMAs (8 of 11
    instructions a trip), not the remainder's or the grid-stride loop;
    without cuobjdump it says so."""
    log = "ptxas info    : Compiling entry function '_Z16chain_fma_kernelPKfPfxi' for 'sm_90a'\n" \
          "ptxas info    : Used 18 registers, used 0 barriers, 0 bytes spill stores, 0 bytes spill loads\n"
    r = kp.chain_reading(log, _chain_sass())
    assert (r.registers, r.spill_bytes, r.ffma, r.instructions) == (18, 0, 8, 11)
    assert r.ffma_share == pytest.approx(8 / 11) and "8 FFMA of 11" in r.line()
    r = kp.chain_reading(log, None)
    assert r.ffma_share is None and "not available" in r.line()
    assert r.fields()["main_loop_ffma_share"] == "not available"


@pytest.mark.parametrize("reps", [2, 4])
def test_fma_peak_plain_matches_jax_fma_kernel(reps):
    """scripts/kernel_parts_probe.py:67 `fma_kernel`: 8 accumulators, reps x
    16 steps each, summed. The sum of 8 adds 8 roundings of its own."""

    def fma_kernel(x_ref, o_ref):
        accs = [x_ref[pl.ds(i * 8, 8), :] + float(i) for i in range(kp.FMA_ACCS)]

        def body(r, accs):
            for _ in range(kp.FMA_UNROLL):
                accs = [a * 1.0000001 + 1e-7 for a in accs]
            return accs

        accs = jax.lax.fori_loop(0, reps, body, accs)
        acc = accs[0]
        for a in accs[1:]:
            acc = acc + a
        o_ref[:, :] = acc

    rng = np.random.default_rng(reps)
    x = torch.from_numpy(rng.uniform(0.5, 2.0, (64, TILE)).astype(np.float32))
    theirs = _interpret(fma_kernel, (8, TILE), x)
    ours = kp.fma_peak(x, reps)
    assert ours.shape == (8, TILE)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=_fused_steps_rtol(reps * kp.FMA_UNROLL + 8),
                               atol=0)


def test_sweep_plain_matches_jax_sweep_kernel():
    """scripts/kernel_parts_probe.py:101 `sweep_kernel` on the cover scene:
    reps x (the full `_sweep_ts`, min to t_best, o += 1e-9 t_best), summed.
    A miss adds T_MISS = 1e30 and moves o by 1e21, so the miss pattern must
    be equal lane for lane, and the sums agree per lane to 1e-5 relative:
    the frameworks round a few operations differently in the last ulp, and
    the near root -half_b - sqrt(disc) cancels digits (measured 4.7e-6 on
    1 of 128 lanes, the rest equal)."""
    reps = 3
    theirs_scene = jax_cover_scene(0)
    p_mat = np.asarray(pr.pack_scene(theirs_scene))
    n = p_mat.shape[1]
    ours_scene = scene_lib.scene_from_numpy(
        {f: np.asarray(getattr(theirs_scene, f)) for f in
         ("center", "radius", "albedo", "fuzz", "ior", "mat_type", "active")}, device="cpu")
    p_t = cr.pack_scene(ours_scene)
    np.testing.assert_array_equal(p_t.numpy(), p_mat)
    _, o, d = kp.inputs("sweep_probe", TILE, "cpu")

    def sweep_kernel(pt_ref, o_ref, d_ref, out_ref):
        def body(r, carry):
            o, d, acc = carry
            t_cs = pr._sweep_ts(o, d, pt_ref, n // pr.CHUNK)
            t_slot = t_cs[0]
            for t_c in t_cs[1:]:
                t_slot = jnp.minimum(t_slot, t_c)
            t_best = jnp.min(t_slot, axis=0, keepdims=True)
            return o + 1e-9 * t_best, d, acc + t_best

        _, _, acc = jax.lax.fori_loop(
            0, reps, body, (o_ref[:, :], d_ref[:, :], jnp.zeros((1, TILE), jnp.float32)))
        out_ref[:, :] = acc

    theirs = _interpret(sweep_kernel, (1, TILE), torch.from_numpy(p_mat.T.copy()), o, d)[0]
    ours = kp.sweep(p_t.T.contiguous(), o, d, reps)[0].numpy()
    miss_t, miss_o = theirs >= 1e29, ours >= 1e29
    assert 0 < miss_t.sum() < TILE, "the rays must both hit and miss"
    np.testing.assert_array_equal(miss_o, miss_t)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=0)


def test_gather_plain_matches_jax_gather_kernel():
    """scripts/kernel_parts_probe.py:148 `gather_kernel`: reps x (P @ OH,
    OH += 1e-12 row 0), summed. Both sides take the product in float32 in
    their own summation order: 1e-5 relative to the largest result."""
    reps = 3
    p, oh = kp.inputs("gather_probe", TILE, "cpu")

    def gather_kernel(p_ref, oh_ref, out_ref):
        def body(r, carry):
            oh, acc = carry
            params = jax.lax.dot_general(p_ref[:, :], oh, (((1,), (0,)), ((), ())),
                                         preferred_element_type=jnp.float32)
            return oh + 1e-12 * params[0:1], acc + params[0:1]

        _, acc = jax.lax.fori_loop(0, reps, body, (oh_ref[:, :], jnp.zeros((1, TILE), jnp.float32)))
        out_ref[:, :] = acc

    theirs = _interpret(gather_kernel, (1, TILE), p, oh)
    ours = kp.gather(p, oh, reps).numpy()
    assert np.abs(theirs).max() > 1.0
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5 * np.abs(theirs).max())


def test_skinny_plain_matches_jax_skinny_kernel():
    """scripts/kernel_parts_probe.py:196 `skinny_kernel` at HIGHEST
    precision (its DEFAULT form is the next test's): reps x (L @ R,
    R += 1e-12 row 0), summed; 1e-5 relative to the largest result
    (summation order)."""
    reps = 4
    l, r = kp.inputs("skinny_probe", TILE, "cpu")

    def skinny_kernel(l_ref, r_ref, out_ref):
        def body(i, carry):
            r, acc = carry
            prod = jax.lax.dot_general(l_ref[:, :], r, (((1,), (0,)), ((), ())),
                                       precision=jax.lax.Precision.HIGHEST,
                                       preferred_element_type=jnp.float32)
            return r + 1e-12 * prod[0:1], acc + prod[0:1]

        _, acc = jax.lax.fori_loop(0, reps, body, (r_ref[:, :], jnp.zeros((1, TILE), jnp.float32)))
        out_ref[:, :] = acc

    theirs = _interpret(skinny_kernel, (1, TILE), l, r)
    ours = kp.skinny(l, r, reps).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5 * np.abs(theirs).max())


def test_skinny_default_plain_matches_jax_skinny_kernel():
    """scripts/kernel_parts_probe.py:196 `skinny_kernel` at DEFAULT, the
    TPU's one bf16 pass: L and the current R cast to bf16, the product
    summed in float32, R updated in float32. A product of two bf16 values is
    exact in float32, so both sides differ only in summation order: 1e-5
    relative to the largest result. The bf16 rounding itself moves the
    result by far more than that (checked against the HIGHEST form)."""
    reps = 4
    l, r = kp.inputs("skinny_probe_default", TILE, "cpu")

    def skinny_kernel(l_ref, r_ref, out_ref):
        def body(i, carry):
            r, acc = carry
            prod = jax.lax.dot_general(l_ref[:, :].astype(jnp.bfloat16), r.astype(jnp.bfloat16),
                                       (((1,), (0,)), ((), ())),
                                       preferred_element_type=jnp.float32)
            return r + 1e-12 * prod[0:1], acc + prod[0:1]

        _, acc = jax.lax.fori_loop(0, reps, body, (r_ref[:, :], jnp.zeros((1, TILE), jnp.float32)))
        out_ref[:, :] = acc

    theirs = _interpret(skinny_kernel, (1, TILE), l, r)
    ours = kp.skinny_default(l, r, reps).numpy()
    scale = np.abs(theirs).max()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5 * scale)
    assert np.abs(ours - kp.skinny(l, r, reps).numpy()).max() > 1e-3 * scale


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: x rounded to 10 mantissa bits, ties away from zero
    (adding half an ulp to the sign-magnitude bits, then clearing the low
    13)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def test_tf32_rounding_emulation():
    """Ties go away from zero; below half an ulp rounds down."""
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11, 1 + 2.0 ** -12, 0.0])
    want = [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1 + 2.0 ** -9, 1.0, 0.0]
    assert _tf32(x).tolist() == want


def _mm_tf32(a, b, passes):
    """A @ B from TF32 parts, as mma.sync takes it: one pass (big x big) or
    three (+ big x small + small x big). The tensor core's products of TF32
    values are exact; the sum is taken in float64 and rounded once."""
    a_big, b_big = _tf32(a), _tf32(b)
    out = a_big.double() @ b_big.double()
    if passes == 3:
        a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
        out = out + (a_big.double() @ b_small.double() + a_small.double() @ b_big.double())
    return out.float()


def _probe_loop(a, b, reps, mm):
    acc = torch.zeros_like(b[0:1])
    for _ in range(reps):
        row0 = mm(a, b)[0:1]
        b = b + 1e-12 * row0
        acc = acc + row0
    return acc


@pytest.mark.parametrize("name", ["gather_probe", "skinny_probe"])
def test_3xtf32_meets_the_gate_and_one_pass_does_not(name):
    """The kernels' HIGHEST arithmetic on the probes' own inputs (tile 128,
    reps 4), against the probe taken wholly in float64, relative to the
    largest value: 3xTF32 is within 1e-6 (measured 3.6e-8 and 1.2e-7), one
    TF32 pass misses the 1e-5 gate (1.6e-4 and 4.6e-4), hence three."""
    reps = 4
    a, b = kp.inputs(name, TILE, "cpu")
    want = _probe_loop(a.double(), b.double(), reps, torch.matmul)
    scale = want.abs().max()

    def err(passes):
        got = _probe_loop(a, b, reps, lambda x, y: _mm_tf32(x, y, passes))
        return float((got.double() - want).abs().max() / scale)

    assert err(3) <= 1e-6
    assert err(1) > kp.GATES[name]


def _bench_args(name, tile):
    """The probe's inputs at `tile` columns as shapes only (the bounds of
    every probe but the sweep read nothing else); the sweep's real inputs."""
    if name == "sweep_probe":
        return kp.inputs(name, tile, "cpu")
    shapes = {"chain_fma": [(128, tile)], "fma_peak": [(64, tile)], "gather_probe": [(16, 512), (512, tile)],
              "skinny_probe": [(1024, 8), (8, tile)], "skinny_probe_default": [(1024, 8), (8, tile)]}
    return tuple(torch.empty(s, device="meta") for s in shapes[name])


def _bound(name, args, reps):
    ops, n_bytes, _, tensor_ms = kp.work(name, args, reps)
    return kp.bound_ms(ops, n_bytes, tensor_ms)


def test_gather_bound_is_its_tensor_work():
    """The gather at 131072 columns, 64 reps: 2 x 16 x 512 x 131072 x 64
    operations, three TF32 passes at 495 TFLOP/s = 0.833 ms, above its bytes
    (0.08 ms) and its float32 operations (0.064 ms)."""
    ms, by = _bound("gather_probe", _bench_args("gather_probe", kp.FILL_TILE), 64)
    assert by == "tensor"
    assert ms == pytest.approx(0.833, abs=0.001)
    ms, by = _bound("skinny_probe_default", _bench_args("skinny_probe_default", kp.FILL_TILE), 64)
    assert by == "tensor" and ms == pytest.approx(2.0 * 1024 * 8 * kp.FILL_TILE * 64 / 989e9)


@pytest.mark.parametrize("name", ["chain_fma", "fma_peak", "sweep_probe", "gather_probe", "skinny_probe",
                                  "skinny_probe_default"])
def test_bound_is_never_below_a_term(name):
    """At the bench shapes (2048 and 131072 columns; the sweep, whose work
    depends on its rays, at 128), no probe's bound is below its float32
    operations over 67 TFLOP/s, its bytes over 3.35 TB/s or its tensor
    work (3 TF32 passes at 495 TFLOP/s for float32 accuracy, one bf16 pass
    at 989 for DEFAULT), and it names the largest."""
    reps = kp.CHAIN if name == "chain_fma" else 64
    passes, peak = {"gather_probe": (3, 495e12), "skinny_probe": (3, 495e12),
                    "skinny_probe_default": (1, 989e12)}.get(name, (0, 1.0))
    for tile in ((TILE,) if name == "sweep_probe" else (kp.JAX_TILE, kp.FILL_TILE)):
        r = 2 if name == "sweep_probe" else reps
        args = _bench_args(name, tile)
        ops, n_bytes, product, tensor_ms = kp.work(name, args, r)
        assert (product > 0) == (passes > 0)
        assert tensor_ms == pytest.approx(passes * product / peak * 1e3)
        terms = {"operations": ops / 67e9, "bytes": n_bytes / 3.35e9, "tensor": tensor_ms}
        ms, by = kp.bound_ms(ops, n_bytes, tensor_ms)
        assert all(ms >= t * (1 - 1e-12) for t in terms.values()), (tile, terms, ms)
        assert ms == pytest.approx(terms[by])


def test_parts_name_both_skinny_precisions():
    """`kernel_parts.main` runs every part in `PARTS` and prints each line
    under the script's name: skinny-default beside skinny-highest."""
    assert kp.PARTS[-2:] == ("skinny_probe", "skinny_probe_default")
    lines = [kp.Timing(name, 2048, 64, 1.0, 1e9, 1e6, 0.5, "tensor").line() for name in kp.PARTS]
    assert [line.split(" ")[0] for line in lines] == ["fma-peak", "sweep", "gather", "skinny-highest",
                                                      "skinny-default"]
    assert "bound 0.5000 ms by tensor (50.0% of bound)" in lines[-1]


def test_fused_step_plain_is_one_rounding():
    """The plain fused step equals the exactly rounded a * m + c (computed
    in exact rational arithmetic) on every input where float64 does not
    land on a float32 tie: here on all of 4096 random inputs."""
    from fractions import Fraction

    x = np.random.default_rng(0).uniform(-4.0, 4.0, 4096).astype(np.float32)
    ours = kp._fma_step(torch.from_numpy(x)).numpy()
    m, c = Fraction(float(np.float32(1.0000001))), Fraction(float(np.float32(1e-7)))
    exact = np.array([np.float32(float(Fraction(float(v)) * m + c)) for v in x])
    # float(Fraction) rounds once to float64, then to float32: compare bits.
    assert (ours.view(np.int32) != exact.view(np.int32)).sum() == 0


def test_warp_occupancy_arithmetic():
    """A warp runs until its longest lane is done: executed = the sum over
    32-lane warps of the largest per-lane trip count; ideal = total
    lane-iterations / 32."""
    iters = torch.zeros(96)
    iters[0], iters[5] = 7.0, 3.0  # warp 0: one long lane
    iters[32:64] = 2.0  # warp 1: uniform
    # warp 2 idle
    assert pp.warp_iters(iters) == 7.0 + 2.0 + 0.0
    work = torch.zeros(96)
    work[:64] = 1.0
    work[0] = 33.0
    assert pp.ideal_warp_iters(work) == 96.0 / 32
    with pytest.raises(RuntimeError):
        pp.warp_iters(torch.zeros(40))  # not whole warps


def test_schedules_report_on_the_cpu():
    """`perf_probe.schedules` through the plain passes at 64x32: every
    schedule does the same lane-iterations, the last cold pass leaves no
    lane unfinished, occupancy is at most 1, and sorting by cost beats
    pixel order (measured 52% pixel order, 61% cold, 98% warm)."""
    sc = scene_lib.cover_scene_reference(device="cpu")
    cam = make_camera(image_width=64, aspect_ratio=2.0, samples_per_pixel=4, max_depth=8, device="cpu")
    lines = []
    s = pp.schedules(sc, cam, log=lines.append)
    assert len(s["passes"]) == cr.DEFAULT_PASSES == len(lines)
    assert s["passes"][-1]["unfinished"] == 0
    assert s["passes"][0]["live_lanes"] == cam.num_pixels
    assert sum(r["lane_iters"] for r in s["passes"]) == s["work"]
    for key in ("cold", "pixel", "warm"):
        assert s["ideal"] <= s[key] and 0 < s[f"occupancy_{key}"] <= 1.0
    assert s["occupancy_warm"] > s["occupancy_cold"] > s["occupancy_pixel"]
