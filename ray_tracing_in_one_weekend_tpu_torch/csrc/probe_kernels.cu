// Probe kernels: the card's float32 rate, the cost of one sphere test, and the
// two products the TPU kernel used, each alone. Hand-written for Hopper
// (sm_90a). They measure; no render runs them.
//
// They replace the five Pallas probe kernels of the JAX package's scripts and
// compute what each computes, on the same shapes (f32, row-major [rows, tile]):
//
// * chain_fma_kernel     <- scripts/perf_probe.py:47 (`kern` of _vpu_peak_ops):
//   x [R, tile] -> [R, tile], one dependent chain of `chain` steps
//   acc = acc * 1.0000001 + 1e-7 per element. One chain per element measures
//   the FMA's latency on the TPU; here every thread runs one chain, and the
//   card hides a chain's latency only with enough warps in flight. It is
//   labelled a chain rate, never the peak.
// * fma_peak_kernel      <- scripts/kernel_parts_probe.py:67 (`fma_kernel`):
//   x [64, tile] -> [8, tile]; 8 independent accumulators x[8i:8i+8] + i, each
//   reps x 16 chained steps, summed in order. Eight independent chains per
//   thread give the scheduler instruction-level parallelism: the peak.
// * sweep_probe_kernel   <- scripts/kernel_parts_probe.py:101 (`sweep_kernel`):
//   reps x (closest hit over every sphere -> t_best; o += 1e-9 t_best;
//   acc += t_best) -> [1, tile]. It calls render_device.cuh's closest_hit with
//   the table in shared memory: the very sweep render_kernel runs.
// * gather_probe_kernel  <- scripts/kernel_parts_probe.py:148 (`gather_kernel`):
//   reps x (params = P [16, N] @ OH [N, tile]; OH += 1e-12 params[0];
//   acc += params[0]) -> [1, tile]. The TPU kernel found the winner's
//   parameters by this one-hot product; render_kernel here loads the row by
//   index from shared memory instead, so this probe only sizes the product.
// * skinny_probe_kernel  <- scripts/kernel_parts_probe.py:196 (`skinny_kernel`):
//   reps x (prod = L [2N, 8] @ R [8, tile]; R += 1e-12 prod[0];
//   acc += prod[0]) -> [1, tile], in float32 (the TPU's HIGHEST precision;
//   its DEFAULT bf16 passes have no counterpart here).
//
// What bounds them, and what the design does about it: all five are bound by
// float32 operations, none by device memory except the gather probe, whose
// [N, tile] operand lives in a device-memory scratch (2 KB a column is too
// much for registers or a block's shared memory) and is read and written once
// per rep. One thread per output column, 128 threads a block, the columns
// spread over blocks: the TPU's grid of 16 ran one block 16 times, while each
// column here is independent, so a launch with enough columns fills all 132
// SMs. The scene table, P and L live in shared memory and are read as
// broadcasts.
//
// Built into the one library with the render kernels, with -fmad=false (see
// kernels/build.py). So the FMA steps are written as __fmaf_rn: a fused
// multiply-add rounded once, which is one FFMA instruction. Without it the
// build would issue a multiply and an add and time half the rate. The products
// of the gather and skinny probes keep the render's rounding (a multiply and
// an add per term), as the sweep does.
//
// The products' rows other than row 0 feed nothing, so a compiler would drop
// them (an empty asm statement does not stop ptxas, which sees no use in the
// PTX). So every other row's bits are XORed into a per-column word written to
// `sink` at the end: one integer operation per row, which keeps the full
// product in every rep. Each rep starts from the operand the previous rep
// updated, so no rep can be hoisted and the rank-one form of the update
// (OH_r = OH_0 + s_r 1^T) is not used: the kernel multiplies the whole operand.
#include <cuda_runtime.h>

#include "render_device.cuh"

using namespace rt;

constexpr int PROBE_BLOCK = 128;
constexpr int FMA_ACCS = 8;     // independent accumulators of fma_peak
constexpr int FMA_UNROLL = 16;  // chained steps per accumulator per rep
constexpr int GATHER_ROWS = 16;
constexpr int SKINNY_K = 8;

__device__ __forceinline__ float fma_step(float acc) { return __fmaf_rn(acc, 1.0000001f, 1e-7f); }

__global__ void __launch_bounds__(PROBE_BLOCK)
    chain_fma_kernel(const float* __restrict__ x, float* __restrict__ out, long long n, int chain) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float acc = x[i];
    for (int k = 0; k < chain; ++k) acc = fma_step(acc);
    out[i] = acc;
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

__global__ void __launch_bounds__(PROBE_BLOCK)
    sweep_probe_kernel(const float4* __restrict__ table, int n_spheres, const float* __restrict__ o_in,
                       const float* __restrict__ d_in, float* __restrict__ out, int n_lanes, int reps,
                       float t_min) {
    extern __shared__ float4 s_table[];
    for (int k = threadIdx.x; k < 4 * n_spheres; k += blockDim.x) s_table[k] = table[k];
    __syncthreads();
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n_lanes) return;
    vec3 o = {o_in[j], o_in[n_lanes + j], o_in[2 * n_lanes + j]};
    const vec3 d = {d_in[j], d_in[n_lanes + j], d_in[2 * n_lanes + j]};
    float acc = 0.0f;
    for (int rep = 0; rep < reps; ++rep) {
        float t_best;
        int best;
        closest_hit(s_table, n_spheres, o, d, t_min, t_best, best);
        // Data-dependent, so the sweep cannot be hoisted out of the loop.
        const float s = 1e-9f * t_best;
        o = {o.x + s, o.y + s, o.z + s};
        acc = acc + t_best;
    }
    out[j] = acc;
}

__global__ void __launch_bounds__(PROBE_BLOCK)
    gather_probe_kernel(const float* __restrict__ p, const float* __restrict__ oh, float* __restrict__ scratch,
                        float* __restrict__ out, unsigned* __restrict__ sink, int n, int tile, int reps) {
    // P transposed into shared memory, [N][16]: the 16 rows of column k are
    // four float4 broadcasts.
    extern __shared__ float4 s_pt[];
    float* s = reinterpret_cast<float*>(s_pt);
    for (int q = threadIdx.x; q < GATHER_ROWS * n; q += blockDim.x) {
        const int r = q / n, k = q % n;
        s[k * GATHER_ROWS + r] = p[q];
    }
    __syncthreads();
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= tile) return;
    float acc = 0.0f, pending = 0.0f;
    unsigned bits = 0u;
    for (int rep = 0; rep < reps; ++rep) {
        // Rep 0 reads OH_0; rep r > 0 reads OH_{r-1} from the scratch and adds
        // the previous rep's update, OH_r = OH_{r-1} + 1e-12 row0_{r-1}.
        const float* src = rep == 0 ? oh : scratch;
        const bool store = rep + 1 < reps;
        float row[GATHER_ROWS];
#pragma unroll
        for (int r = 0; r < GATHER_ROWS; ++r) row[r] = 0.0f;
        for (int k = 0; k < n; ++k) {
            const long long at = (long long)k * tile + c;
            float v = src[at];
            if (rep > 0) v = v + pending;
            if (store) scratch[at] = v;
#pragma unroll
            for (int q = 0; q < GATHER_ROWS / 4; ++q) {
                const float4 pk = s_pt[k * (GATHER_ROWS / 4) + q];
                row[4 * q + 0] = row[4 * q + 0] + pk.x * v;
                row[4 * q + 1] = row[4 * q + 1] + pk.y * v;
                row[4 * q + 2] = row[4 * q + 2] + pk.z * v;
                row[4 * q + 3] = row[4 * q + 3] + pk.w * v;
            }
        }
#pragma unroll
        for (int r = 1; r < GATHER_ROWS; ++r) bits ^= __float_as_uint(row[r]);
        pending = 1e-12f * row[0];
        acc = acc + row[0];
    }
    out[c] = acc;
    sink[c] = bits;
}

__global__ void __launch_bounds__(PROBE_BLOCK)
    skinny_probe_kernel(const float4* __restrict__ l, const float* __restrict__ r_in, float* __restrict__ out,
                        unsigned* __restrict__ sink, int m, int tile, int reps) {
    extern __shared__ float4 s_l[];  // [m][8]: two float4s a row
    for (int q = threadIdx.x; q < 2 * m; q += blockDim.x) s_l[q] = l[q];
    __syncthreads();
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= tile) return;
    float r[SKINNY_K];
#pragma unroll
    for (int i = 0; i < SKINNY_K; ++i) r[i] = r_in[(long long)i * tile + c];
    float acc = 0.0f;
    unsigned bits = 0u;
    for (int rep = 0; rep < reps; ++rep) {
        float row0 = 0.0f;
        for (int i = 0; i < m; ++i) {
            const float4 a = s_l[2 * i], b = s_l[2 * i + 1];
            float v = a.x * r[0];
            v = v + a.y * r[1];
            v = v + a.z * r[2];
            v = v + a.w * r[3];
            v = v + b.x * r[4];
            v = v + b.y * r[5];
            v = v + b.z * r[6];
            v = v + b.w * r[7];
            if (i == 0) {
                row0 = v;
            } else {
                bits ^= __float_as_uint(v);
            }
        }
        const float s = 1e-12f * row0;
#pragma unroll
        for (int i = 0; i < SKINNY_K; ++i) r[i] = r[i] + s;
        acc = acc + row0;
    }
    out[c] = acc;
    sink[c] = bits;
}

static unsigned blocks_for(long long n) { return (unsigned)((n + PROBE_BLOCK - 1) / PROBE_BLOCK); }

// Launchers: device pointers, the stream as a pointer; each returns
// cudaGetLastError() after its launch (0 on success). The wrappers in
// kernels/build.py check shapes and the 48 KB shared-memory limit.
extern "C" int rt_chain_fma(const void* x, void* out, long long n, int chain, void* stream) {
    chain_fma_kernel<<<blocks_for(n), PROBE_BLOCK, 0, (cudaStream_t)stream>>>((const float*)x, (float*)out, n,
                                                                               chain);
    return (int)cudaGetLastError();
}

extern "C" int rt_fma_peak(const void* x, void* out, int tile, int reps, void* stream) {
    fma_peak_kernel<<<blocks_for((long long)FMA_ACCS * tile), PROBE_BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, tile, reps);
    return (int)cudaGetLastError();
}

extern "C" int rt_sweep_probe(const void* table, int n_spheres, const void* o, const void* d, void* out, int n_lanes,
                              int reps, float t_min, void* stream) {
    const size_t smem = (size_t)n_spheres * P_ROWS * sizeof(float);
    sweep_probe_kernel<<<blocks_for(n_lanes), PROBE_BLOCK, smem, (cudaStream_t)stream>>>(
        (const float4*)table, n_spheres, (const float*)o, (const float*)d, (float*)out, n_lanes, reps, t_min);
    return (int)cudaGetLastError();
}

extern "C" int rt_gather_probe(const void* p, const void* oh, void* scratch, void* out, void* sink, int n, int tile,
                               int reps, void* stream) {
    const size_t smem = (size_t)n * GATHER_ROWS * sizeof(float);
    gather_probe_kernel<<<blocks_for(tile), PROBE_BLOCK, smem, (cudaStream_t)stream>>>(
        (const float*)p, (const float*)oh, (float*)scratch, (float*)out, (unsigned*)sink, n, tile, reps);
    return (int)cudaGetLastError();
}

extern "C" int rt_skinny_probe(const void* l, const void* r, void* out, void* sink, int m, int tile, int reps,
                               void* stream) {
    const size_t smem = (size_t)m * SKINNY_K * sizeof(float);
    skinny_probe_kernel<<<blocks_for(tile), PROBE_BLOCK, smem, (cudaStream_t)stream>>>(
        (const float4*)l, (const float*)r, (float*)out, (unsigned*)sink, m, tile, reps);
    return (int)cudaGetLastError();
}
