// Probe kernels: the card's float32 rate, the cost of one sphere test, and the
// two products the TPU kernel used, each alone. Hand-written for Hopper
// (sm_90a). They measure; no render runs them.
//
// They replace the Pallas probe kernels of the JAX package's scripts and
// compute what each computes, on the same shapes (f32, row-major [rows, tile]):
//
// * chain_fma_kernel     <- scripts/perf_probe.py:47 (`kern` of _vpu_peak_ops):
//   x [R, tile] -> [R, tile], one dependent chain of `chain` steps
//   acc = acc * 1.0000001 + 1e-7 per element. One chain per element measures
//   the FMA's latency on the TPU; here a thread interleaves the chains of a
//   few elements (below). It is labelled a chain rate, never the peak.
// * fma_peak_kernel      <- scripts/kernel_parts_probe.py:67 (`fma_kernel`):
//   x [64, tile] -> [8, tile]; 8 independent accumulators x[8i:8i+8] + i, each
//   reps x 16 chained steps, summed in order. Eight independent chains per
//   thread give the scheduler instruction-level parallelism: the peak.
// * sweep_probe_kernel   <- scripts/kernel_parts_probe.py:101 (`sweep_kernel`):
//   reps x (closest hit over every sphere -> t_best; o += 1e-9 t_best;
//   acc += t_best) -> [1, tile]. It builds render_device.cuh's sweep table in
//   shared memory and calls its closest_hit under the same register cap:
//   the very sweep render_kernel runs.
// * gather_probe_kernel  <- scripts/kernel_parts_probe.py:148 (`gather_kernel`):
//   reps x (params = P [16, N] @ OH [N, tile]; OH += 1e-12 params[0];
//   acc += params[0]) -> [1, tile]. The TPU kernel found the winner's
//   parameters by this one-hot product; render_kernel here loads the row by
//   index from shared memory instead, so this probe only sizes the product.
// * skinny_probe_kernel  <- scripts/kernel_parts_probe.py:196 (`skinny_kernel`):
//   reps x (prod = L [2N, 8] @ R [8, tile]; R += 1e-12 prod[0];
//   acc += prod[0]) -> [1, tile], at both of the script's precisions:
//   HIGHEST (float32 accuracy) as <Tf32x3>, DEFAULT (one bf16 pass: L and the
//   current R rounded to bf16, products summed in float32) as <Bf16>.
//
// What bounds them, and what the design does about it. The first three are
// bound by float32 operations. fma_peak and the sweep take one thread per
// output column, 128 threads a block, the columns spread over blocks (the
// TPU's grid of 16 ran one block 16 times, while each column here is
// independent); the scene table lives in shared memory and is read as
// broadcasts.
//
// The chain is bound by float32 issue: 2 operations an FFMA at 67 TFLOP/s,
// one warp FFMA a clock on each of an SM's four schedulers. It reads and
// writes each element once, 8 bytes against 2 x chain operations, so bytes
// never bound it, and every issue slot its loop spends on anything but an
// FFMA is lost. So a thread takes CHAIN_ELEMS elements a grid stride apart
// (each load and store coalesced) and steps their independent chains
// together, CHAIN_UNROLL steps a trip through a loop unrolled at compile
// time, then the chain % CHAIN_UNROLL steps left one at a time: a trip issues
// CHAIN_UNROLL x CHAIN_ELEMS FFMAs and a counter add, a compare and a branch,
// and one warp's independent chains cover the FFMA's latency. The grid is the
// blocks the card holds at once (occupancy x SMs, read once), or fewer for a
// small n, and strides over the elements: every SM gets an equal share, with
// no partial last wave. Every warp of the card starts a group at about the
// same time, so a group's loads would stall them all together (4 MB at 131072
// columns); each thread loads its next group before it runs this one. A last
// group with fewer than CHAIN_ELEMS elements runs their chains alone, not
// masked ones beside them. Each element takes the same steps in the same
// order as one chain alone, so the bits do not depend on the grid,
// CHAIN_ELEMS or CHAIN_UNROLL.
//
// The two products are what the TPU ran on its matrix unit, so here they run
// on the tensor cores, by mma.sync m16n8k8: the least time is the tensor
// work the accuracy needs. A single TF32 pass misses the probes' 1e-5 gate
// (1.6e-4 and 4.6e-4 of the largest value on their inputs), so HIGHEST takes
// three: x = big + small, each cvt.rna.tf32.f32, and big*big + big*small +
// small*big, which carries float32 accuracy (3.6e-8 and 1.4e-7). DEFAULT
// takes one bf16 pass, as the TPU did.
//
// * The gather keeps OH on chip for all reps. A block owns 16 columns (two n8
//   tiles) and holds their [N, 16] slice of OH in shared memory (32 KB at
//   N = 512), read from device memory once, in the order of the mma
//   fragments. Each rep, a warp reads the k-slabs it owns, adds the pending
//   1e-12 row 0, writes them back, splits them and issues the MMAs: one read
//   and one write of OH in shared memory per rep. The 16 rows of P are one
//   m16 tile; K is split over 8 warps, each holding its 8 k-slabs of P, split
//   once, in registers (64 a thread). The warps' partial products meet in
//   shared memory and are summed in a fixed order, which gives row 0 for the
//   update. 16 columns a block make 128 blocks at the scripts' 2048 columns.
// * The skinny product is one MMA-tile deep (K = 8). A block owns one n8 tile
//   of 8 columns, and L's 64 m16 tiles are split over its 8 warps, 8 tiles
//   each, split once into registers (64 a thread for HIGHEST): read from
//   shared memory every rep, L would move 1 KB per MMA tile, ~69 GB over a
//   131072-column launch. R's fragments live in registers too. Every warp
//   computes m16 tile 0 itself, which holds row 0, so no warp waits for
//   another's row 0 to update its R (71 tiles a rep for 64, no barrier). 8
//   columns a block make 256 blocks at 2048 columns.
//
// Measured on an H100 80GB HBM3 at 700 W (probes/kernel_parts.py), both
// skinny forms run m16n8k8 mma.sync at about the same rate, ~88 G
// instructions/s, TF32 or bf16 alike (~180 TFLOP/s executed), a third of
// the TF32 dense peak; the gather at two thirds of that rate. Shortening
// each rep's dependent chain did not raise it (see Tf32x3::mma). Whether
// the MMAs' issue or the work between them holds it is not measured (no
// profiler counters were read).
//
// Built into the one library with the render kernels, with -fmad=false (see
// kernels/build.py). So the FMA steps are written as __fmaf_rn: a fused
// multiply-add rounded once, which is one FFMA instruction. Without it the
// build would issue a multiply and an add and time half the rate. The flag
// does not touch mma or cvt, and the split's x - big is a plain FSUB.
//
// The products' rows other than row 0 feed nothing, so a compiler would drop
// them (an empty asm statement does not stop ptxas, which sees no use in the
// PTX). So every row's bits are XORed into a per-column word written to
// `sink` at the end: one integer operation per value, which keeps the full
// product in every rep. Each rep starts from the operand the previous rep
// updated, so no rep can be hoisted and the rank-one form of the update
// (OH_r = OH_0 + s_r 1^T) is not used: the kernel multiplies the whole operand.
#include <cuda_runtime.h>
#include <stdint.h>

#include "render_device.cuh"

using namespace rt;

constexpr int PROBE_BLOCK = 128;
constexpr int FMA_ACCS = 8;     // independent accumulators of fma_peak
constexpr int FMA_UNROLL = 16;  // chained steps per accumulator per rep
constexpr unsigned FULL_MASK = 0xffffffffu;

constexpr int CHAIN_ELEMS = 4;     // elements a chain_fma thread steps together
constexpr int CHAIN_UNROLL = 128;  // chain steps a trip of its unrolled loop

constexpr int GATHER_ROWS = 16;   // rows of P: one m16 tile
constexpr int GATHER_COLS = 16;   // columns of OH a block owns: two n8 tiles
constexpr int GATHER_WARPS = 8;   // K is split over the block's warps
constexpr int GATHER_SLABS = 8;   // k8 slabs of P a warp holds in registers
constexpr int GATHER_MAX_N = GATHER_WARPS * GATHER_SLABS * 8;
constexpr int GATHER_PART_STRIDE = GATHER_COLS + 8;  // padded: the float2 stores of a half-warp hit 16 banks

constexpr int SKINNY_K = 8;       // one k8 slab
constexpr int SKINNY_WARPS = 8;   // L's rows are split over the block's warps
constexpr int SKINNY_TILES = 8;   // m16 tiles of L a warp holds in registers
constexpr int SKINNY_MAX_M = SKINNY_WARPS * SKINNY_TILES * 16;

__device__ __forceinline__ float fma_step(float acc) { return __fmaf_rn(acc, 1.0000001f, 1e-7f); }

// `chain` steps of M independent chains, stepped together: CHAIN_UNROLL
// steps a trip, then the remainder one at a time.
template <int M>
__device__ __forceinline__ void chain_steps(float* a, int chain) {
    for (int trip = chain / CHAIN_UNROLL; trip > 0; --trip) {
#pragma unroll
        for (int u = 0; u < CHAIN_UNROLL; ++u) {
#pragma unroll
            for (int e = 0; e < M; ++e) a[e] = fma_step(a[e]);
        }
    }
    for (int left = chain % CHAIN_UNROLL; left > 0; --left) {
#pragma unroll
        for (int e = 0; e < M; ++e) a[e] = fma_step(a[e]);
    }
}

__global__ void __launch_bounds__(PROBE_BLOCK)
    chain_fma_kernel(const float* __restrict__ x, float* __restrict__ out, long long n, int chain) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    float a[CHAIN_ELEMS];
#pragma unroll
    for (int e = 0; e < CHAIN_ELEMS; ++e) a[e] = i + e * stride < n ? x[i + e * stride] : 0.0f;
    for (; i < n; i += CHAIN_ELEMS * stride) {
        // The next group's loads fly while this one's chains run.
        const long long next = i + CHAIN_ELEMS * stride;
        float b[CHAIN_ELEMS];
#pragma unroll
        for (int e = 0; e < CHAIN_ELEMS; ++e) b[e] = next + e * stride < n ? x[next + e * stride] : 0.0f;
        if (i + (CHAIN_ELEMS - 1) * stride < n) {
            chain_steps<CHAIN_ELEMS>(a, chain);
        } else {
            // The last group holds fewer elements: run theirs alone.
#pragma unroll
            for (int e = 0; e < CHAIN_ELEMS - 1; ++e)
                if (i + e * stride < n) chain_steps<1>(a + e, chain);
        }
#pragma unroll
        for (int e = 0; e < CHAIN_ELEMS; ++e) {
            if (i + e * stride < n) out[i + e * stride] = a[e];
            a[e] = b[e];
        }
    }
}

__global__ void __launch_bounds__(PROBE_BLOCK)
    fma_peak_kernel(const float* __restrict__ x, float* __restrict__ out, int tile, int reps) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)FMA_ACCS * tile) return;
    const int r = (int)(t / tile), c = (int)(t % tile);
    float a[FMA_ACCS];
#pragma unroll
    for (int i = 0; i < FMA_ACCS; ++i) a[i] = x[(long long)(FMA_ACCS * i + r) * tile + c] + (float)i;
    for (int rep = 0; rep < reps; ++rep) {
#pragma unroll
        for (int u = 0; u < FMA_UNROLL; ++u) {
#pragma unroll
            for (int i = 0; i < FMA_ACCS; ++i) a[i] = fma_step(a[i]);
        }
    }
    float acc = a[0];
#pragma unroll
    for (int i = 1; i < FMA_ACCS; ++i) acc = acc + a[i];
    out[(long long)r * tile + c] = acc;
}

SWEEP_KERNEL sweep_probe_kernel(const float4* __restrict__ table, int n_spheres, const float* __restrict__ o_in,
                                const float* __restrict__ d_in, float* __restrict__ out, int n_lanes, int reps,
                                float t_min) {
    extern __shared__ float4 s_sweep[];
    load_sweep_table(s_sweep, table, n_spheres);
    __syncthreads();
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n_lanes) return;
    vec3 o = {o_in[j], o_in[n_lanes + j], o_in[2 * n_lanes + j]};
    const vec3 d = {d_in[j], d_in[n_lanes + j], d_in[2 * n_lanes + j]};
    float acc = 0.0f;
    for (int rep = 0; rep < reps; ++rep) {
        float t_best;
        int best;
        closest_hit(s_sweep, n_spheres, o, d, t_min, t_best, best);
        // Data-dependent, so the sweep cannot be hoisted out of the loop.
        const float s = 1e-9f * t_best;
        o = {o.x + s, o.y + s, o.z + s};
        acc = acc + t_best;
    }
    out[j] = acc;
}

// ---------------------------------------------------------------------------
// Tensor-core pieces. Fragments of mma.sync m16n8k8 (PTX ISA), lane = 4 g + t:
//   tf32 A [16 x 8]: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   tf32 B [8 x 8]:  b0 (t, g), b1 (t + 4, g);
//   bf16 A: {(g, 2t), (g, 2t + 1)}, {(g + 8, 2t), (g + 8, 2t + 1)}, low half first;
//   bf16 B: {(2t, g), (2t + 1, g)};
//   f32 D [16 x 8]:  d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1).
// ---------------------------------------------------------------------------

// cvt.rna.tf32.f32: x to TF32's 10 mantissa bits, ties away from zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// x = big + small, both TF32: the 3xTF32 split.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
    big = to_tf32(x);
    small = to_tf32(x - __uint_as_float(big));
}

// Two floats rounded to nearest-even bf16 and packed, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    uint32_t r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
    return r;
}

// d += A B, one TF32 pass.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%0,%1,%2,%3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B, one bf16 pass.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ float oh_at(const float* __restrict__ oh, int k, int c, int tile) {
    return c < tile ? oh[(long long)k * tile + c] : 0.0f;
}

__global__ void __launch_bounds__(GATHER_WARPS * 32, 2)
    gather_probe_kernel(const float* __restrict__ p, const float* __restrict__ oh, float* __restrict__ out,
                        unsigned* __restrict__ sink, int n, int tile, int reps) {
    // The block's [N, 16] slice of OH, in fragment order: entry 32 s + lane
    // holds the lane's B values (k = 8s + t, 8s + t + 4) of n-tile 0, then of
    // n-tile 1.
    extern __shared__ float4 s_oh[];
    __shared__ __align__(16) float s_part[GATHER_WARPS][GATHER_ROWS][GATHER_PART_STRIDE];
    __shared__ float s_pending[GATHER_COLS];
    __shared__ unsigned s_bits[GATHER_COLS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int col0 = blockIdx.x * GATHER_COLS;
    const int slabs = n / 8;
    for (int q = threadIdx.x; q < 32 * slabs; q += blockDim.x) {
        const int k = 8 * (q >> 5) + (q & 3), c = col0 + ((q & 31) >> 2);
        s_oh[q] = make_float4(oh_at(oh, k, c, tile), oh_at(oh, k + 4, c, tile), oh_at(oh, k, c + 8, tile),
                              oh_at(oh, k + 4, c + 8, tile));
    }
    if (threadIdx.x < GATHER_COLS) s_bits[threadIdx.x] = 0u;
    // This warp's k-slabs of P (slab warp + 8 i), split once.
    uint32_t p_big[GATHER_SLABS][4], p_small[GATHER_SLABS][4];
#pragma unroll
    for (int i = 0; i < GATHER_SLABS; ++i) {
        const int s = warp + GATHER_WARPS * i, k = 8 * s + t;
        const bool live = s < slabs;
        const float a[4] = {live ? p[g * n + k] : 0.0f, live ? p[(g + 8) * n + k] : 0.0f,
                            live ? p[g * n + k + 4] : 0.0f, live ? p[(g + 8) * n + k + 4] : 0.0f};
#pragma unroll
        for (int j = 0; j < 4; ++j) split_tf32(a[j], p_big[i][j], p_small[i][j]);
    }
    __syncthreads();
    // In the reduction, this thread sums element (row, col) of the product.
    const int row = threadIdx.x / GATHER_COLS, col = threadIdx.x % GATHER_COLS;
    float acc = 0.0f, pending0 = 0.0f, pending1 = 0.0f;  // pending: of columns g and 8 + g
    unsigned bits = 0u;
    for (int rep = 0; rep < reps; ++rep) {
        // Big x big and the two corrections in separate accumulators: four
        // independent MMA chains a warp.
        float d_big[2][4] = {}, d_corr[2][4] = {};
#pragma unroll
        for (int i = 0; i < GATHER_SLABS; ++i) {
            const int s = warp + GATHER_WARPS * i;
            if (s >= slabs) break;
            // OH_rep = OH_{rep-1} + 1e-12 row0_{rep-1} (nothing pending at rep 0).
            float4 v = s_oh[32 * s + lane];
            v.x = v.x + pending0;
            v.y = v.y + pending0;
            v.z = v.z + pending1;
            v.w = v.w + pending1;
            s_oh[32 * s + lane] = v;
            uint32_t b_big[4], b_small[4];
            split_tf32(v.x, b_big[0], b_small[0]);
            split_tf32(v.y, b_big[1], b_small[1]);
            split_tf32(v.z, b_big[2], b_small[2]);
            split_tf32(v.w, b_big[3], b_small[3]);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                mma_tf32(d_corr[j], p_small[i], b_big[2 * j], b_big[2 * j + 1]);
                mma_tf32(d_corr[j], p_big[i], b_small[2 * j], b_small[2 * j + 1]);
                mma_tf32(d_big[j], p_big[i], b_big[2 * j], b_big[2 * j + 1]);
            }
        }
        // This warp's partial product over its slabs: rows g and g + 8,
        // columns 8 j + 2t and + 1.
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            *reinterpret_cast<float2*>(&s_part[warp][g][8 * j + 2 * t]) =
                make_float2(d_big[j][0] + d_corr[j][0], d_big[j][1] + d_corr[j][1]);
            *reinterpret_cast<float2*>(&s_part[warp][g + 8][8 * j + 2 * t]) =
                make_float2(d_big[j][2] + d_corr[j][2], d_big[j][3] + d_corr[j][3]);
        }
        __syncthreads();
        float v = s_part[0][row][col];
#pragma unroll
        for (int w = 1; w < GATHER_WARPS; ++w) v = v + s_part[w][row][col];
        if (row == 0) {
            s_pending[col] = 1e-12f * v;
            acc = acc + v;
        } else {
            bits ^= __float_as_uint(v);
        }
        __syncthreads();
        pending0 = s_pending[g];
        pending1 = s_pending[8 + g];
    }
    atomicXor(&s_bits[col], bits);
    __syncthreads();
    if (row == 0 && col0 + col < tile) {
        out[col0 + col] = acc;
        sink[col0 + col] = s_bits[col];
    }
}

// HIGHEST: 3xTF32. A thread holds R[t][c] and R[t + 4][c] of its column c.
struct Tf32x3 {
    struct A {
        uint32_t big[4], small[4];
    };
    struct B {
        uint32_t big[2], small[2];
    };
    static __device__ __forceinline__ int r_row(int t, int i) { return t + 4 * i; }
    static __device__ __forceinline__ A load_a(const float* __restrict__ l, int row, int t) {
        const float v[4] = {l[row * SKINNY_K + t], l[(row + 8) * SKINNY_K + t], l[row * SKINNY_K + t + 4],
                            l[(row + 8) * SKINNY_K + t + 4]};
        A a;
#pragma unroll
        for (int j = 0; j < 4; ++j) split_tf32(v[j], a.big[j], a.small[j]);
        return a;
    }
    static __device__ __forceinline__ B load_b(float r0, float r1) {
        B b;
        split_tf32(r0, b.big[0], b.small[0]);
        split_tf32(r1, b.big[1], b.small[1]);
        return b;
    }
    // d += A B, small terms first, in one accumulator. Two accumulators (big
    // x big beside the corrections, as in the gather) shorten each rep's
    // chain by one MMA but add their sum: 3-4% slower on an H100.
    static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
        mma_tf32(d, a.small, b.big[0], b.big[1]);
        mma_tf32(d, a.big, b.small[0], b.small[1]);
        mma_tf32(d, a.big, b.big[0], b.big[1]);
    }
};

// DEFAULT: one bf16 pass. A thread holds R[2t][c] and R[2t + 1][c].
struct Bf16 {
    struct A {
        uint32_t v[2];
    };
    using B = uint32_t;
    static __device__ __forceinline__ int r_row(int t, int i) { return 2 * t + i; }
    static __device__ __forceinline__ A load_a(const float* __restrict__ l, int row, int t) {
        A a;
        a.v[0] = pack_bf16(l[row * SKINNY_K + 2 * t], l[row * SKINNY_K + 2 * t + 1]);
        a.v[1] = pack_bf16(l[(row + 8) * SKINNY_K + 2 * t], l[(row + 8) * SKINNY_K + 2 * t + 1]);
        return a;
    }
    static __device__ __forceinline__ B load_b(float r0, float r1) { return pack_bf16(r0, r1); }
    static __device__ __forceinline__ void mma(float (&d)[4], const A& a, B b) { mma_bf16(d, a.v, b); }
};

template <class Ops>
__global__ void __launch_bounds__(SKINNY_WARPS * 32, 2)
    skinny_probe_kernel(const float* __restrict__ l, const float* __restrict__ r_in, float* __restrict__ out,
                        unsigned* __restrict__ sink, int m, int tile, int reps) {
    __shared__ unsigned s_bits[8];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int col0 = blockIdx.x * 8, c = col0 + g;  // c: this thread's column of R
    const int m_tiles = m / 16;
    if (threadIdx.x < 8) s_bits[threadIdx.x] = 0u;
    // m16 tile 0 holds row 0: every warp computes it. This warp's own tiles
    // are 8 warp + i.
    const typename Ops::A a0 = Ops::load_a(l, g, t);
    typename Ops::A a[SKINNY_TILES];
#pragma unroll
    for (int i = 0; i < SKINNY_TILES; ++i) {
        const int mt = SKINNY_TILES * warp + i;
        a[i] = mt < m_tiles ? Ops::load_a(l, 16 * mt + g, t) : typename Ops::A{};
    }
    float r0 = c < tile ? r_in[(long long)Ops::r_row(t, 0) * tile + c] : 0.0f;
    float r1 = c < tile ? r_in[(long long)Ops::r_row(t, 1) * tile + c] : 0.0f;
    float acc = 0.0f;
    unsigned even = 0u, odd = 0u;  // XOR of columns 2t and 2t + 1
    for (int rep = 0; rep < reps; ++rep) {
        const typename Ops::B b = Ops::load_b(r0, r1);
        float z[4] = {};
        Ops::mma(z, a0, b);
        if (warp == 0) {
            even ^= __float_as_uint(z[0]) ^ __float_as_uint(z[2]);
            odd ^= __float_as_uint(z[1]) ^ __float_as_uint(z[3]);
        }
#pragma unroll
        for (int i = 0; i < SKINNY_TILES; ++i) {
            const int mt = SKINNY_TILES * warp + i;
            if (mt >= m_tiles) break;
            if (mt == 0) continue;  // z
            float d[4] = {};
            Ops::mma(d, a[i], b);
            even ^= __float_as_uint(d[0]) ^ __float_as_uint(d[2]);
            odd ^= __float_as_uint(d[1]) ^ __float_as_uint(d[3]);
        }
        // Row 0 of column g is d0 (g even) or d1 of lane g / 2.
        const float x0 = __shfl_sync(FULL_MASK, z[0], g >> 1), x1 = __shfl_sync(FULL_MASK, z[1], g >> 1);
        const float row0 = (g & 1) ? x1 : x0;
        const float s = 1e-12f * row0;
        r0 = r0 + s;
        r1 = r1 + s;
        acc = acc + row0;
    }
    // Per column: over the lanes' rows (g), then over the warps.
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
        even ^= __shfl_xor_sync(FULL_MASK, even, o);
        odd ^= __shfl_xor_sync(FULL_MASK, odd, o);
    }
    __syncthreads();
    if (lane < 4) {
        atomicXor(&s_bits[2 * lane], even);
        atomicXor(&s_bits[2 * lane + 1], odd);
    }
    __syncthreads();
    const int tid = threadIdx.x;
    if (tid < 8 && col0 + tid < tile) sink[col0 + tid] = s_bits[tid];
    if (warp == 0 && t == 0 && c < tile) out[c] = acc;
}

static unsigned blocks_for(long long n) { return (unsigned)((n + PROBE_BLOCK - 1) / PROBE_BLOCK); }

// Launchers: device pointers, the stream as a pointer; each returns
// cudaGetLastError() after its launch (0 on success), or
// cudaErrorInvalidValue for a shape its kernel does not take. The wrappers in
// kernels/build.py check shapes and limits first.
// The chain's grid: the blocks of chain_fma_kernel the card holds at once
// (read once), or fewer where n needs fewer; minus the CUDA error.
static long long chain_grid(long long n) {
    static int resident = 0;
    if (resident == 0) {
        int device = 0, sms = 0, per_sm = 0;
        cudaError_t err = cudaGetDevice(&device);
        if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain_fma_kernel, PROBE_BLOCK, 0);
        if (err != cudaSuccess) return -(long long)err;
        resident = sms * per_sm;
    }
    const long long most = (n + (long long)CHAIN_ELEMS * PROBE_BLOCK - 1) / ((long long)CHAIN_ELEMS * PROBE_BLOCK);
    return most < resident ? most : resident;
}

extern "C" int rt_chain_fma(const void* x, void* out, long long n, int chain, void* stream) {
    const long long grid = chain_grid(n);
    if (grid < 0) return (int)-grid;
    if (grid == 0) return (int)cudaErrorInvalidValue;
    chain_fma_kernel<<<(unsigned)grid, PROBE_BLOCK, 0, (cudaStream_t)stream>>>((const float*)x, (float*)out, n,
                                                                                chain);
    return (int)cudaGetLastError();
}

extern "C" int rt_fma_peak(const void* x, void* out, int tile, int reps, void* stream) {
    fma_peak_kernel<<<blocks_for((long long)FMA_ACCS * tile), PROBE_BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, tile, reps);
    return (int)cudaGetLastError();
}

// The sweep table is all of the sweep probe's shared memory.
extern "C" int rt_sweep_probe_max_spheres() { return (int)(DEFAULT_BLOCK_SMEM / sizeof(float4)); }

extern "C" int rt_sweep_probe(const void* table, int n_spheres, const void* o, const void* d, void* out, int n_lanes,
                              int reps, float t_min, void* stream) {
    if (n_spheres <= 0 || n_spheres > rt_sweep_probe_max_spheres()) return (int)cudaErrorInvalidValue;
    sweep_probe_kernel<<<blocks_for(n_lanes), PROBE_BLOCK, sweep_table_bytes(n_spheres), (cudaStream_t)stream>>>(
        (const float4*)table, n_spheres, (const float*)o, (const float*)d, (float*)out, n_lanes, reps, t_min);
    return (int)cudaGetLastError();
}

// Resident sweep-probe blocks an SM holds for a scene of `n_spheres`, or
// minus the CUDA error. The probe's block is PROBE_BLOCK threads.
extern "C" int rt_sweep_probe_blocks_per_sm(int n_spheres) {
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, sweep_probe_kernel, PROBE_BLOCK,
                                                                          sweep_table_bytes(n_spheres));
    return err == cudaSuccess ? blocks : -(int)err;
}

// OH's slice takes n * 64 bytes of dynamic shared memory: 32 KB at the
// largest n, under the default 48 KB with the 12 KB of static partials, so
// no opt-in is needed.
extern "C" int rt_gather_probe(const void* p, const void* oh, void* out, void* sink, int n, int tile, int reps,
                               void* stream) {
    if (n <= 0 || n % 8 || n > GATHER_MAX_N || tile <= 0) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)n * GATHER_COLS * sizeof(float);
    gather_probe_kernel<<<(tile + GATHER_COLS - 1) / GATHER_COLS, GATHER_WARPS * 32, smem, (cudaStream_t)stream>>>(
        (const float*)p, (const float*)oh, (float*)out, (unsigned*)sink, n, tile, reps);
    return (int)cudaGetLastError();
}

template <class Ops>
static int launch_skinny(const void* l, const void* r, void* out, void* sink, int m, int tile, int reps,
                         void* stream) {
    if (m <= 0 || m % 16 || m > SKINNY_MAX_M || tile <= 0) return (int)cudaErrorInvalidValue;
    skinny_probe_kernel<Ops><<<(tile + 7) / 8, SKINNY_WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const float*)l, (const float*)r, (float*)out, (unsigned*)sink, m, tile, reps);
    return (int)cudaGetLastError();
}

extern "C" int rt_skinny_probe(const void* l, const void* r, void* out, void* sink, int m, int tile, int reps,
                               void* stream) {
    return launch_skinny<Tf32x3>(l, r, out, sink, m, tile, reps, stream);
}

extern "C" int rt_skinny_default_probe(const void* l, const void* r, void* out, void* sink, int m, int tile,
                                       int reps, void* stream) {
    return launch_skinny<Bf16>(l, r, out, sink, m, tile, reps, stream);
}
