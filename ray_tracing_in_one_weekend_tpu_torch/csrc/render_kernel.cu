// Forward render kernel: one budgeted, resumable pass of the persistent-sample
// loop over the lane state. Hand-written for Hopper (sm_90a).
//
// Replaces ray_tracing_in_one_weekend_tpu/ops/pallas_render.py::_render_kernel,
// the Pallas TPU kernel, and computes what it computes: each lane (one flat
// pixel) traces its samples one bounce per iteration, accumulating radiance,
// and a lane whose ray retires starts its next sample at once. The pass stops
// when the lane is idle or after `budget` iterations, and writes the lane
// state back in the JAX row layout so the next pass resumes it.
//
// Layout on this card: one thread per lane, `tile` lanes per block, P / tile
// blocks. Each block first builds its sweep table in shared memory, one
// float4 (cx, cy, cz, |c|^2 - r^2) a sphere from the packed scene table ([N,
// 16] f32): 8 KB at N = 512. The per-thread loop then sweeps all N spheres
// with broadcast reads from it, eight spheres' tests in flight at a time,
// picks the winner with a strict < argmin in index order, and reads the
// winner's row of the packed table from device memory (the TPU kernel's
// one-hot MXU matmul and its transposed table copy are gone). Lanes are
// independent, so a lane's state after the pass equals the TPU's for every
// busy lane; only the SF_ITERS diagnostic differs: it holds the lane's own
// trip count here, where the TPU kernel wrote its tile's.
//
// What should bound it: the FP32 sweep, about N x 15 flops per bounce per
// lane (plus one sqrtf per sphere whose quadratic has real roots), with no
// device-memory traffic inside the sweep: the lane state is read once and
// written once per pass. Without contraction each of the 15 operations is
// one instruction, so the sweep is bound by issue: the design keeps a test
// at one shared-memory load and 15 FP32 instructions plus its share of the
// group's sign test and loop, and caps the kernel at RT_SWEEP_REGS (64)
// registers so that 8 blocks of 128 threads share an SM to hide each test's
// dependent chain (render_device.cuh, closest_hit). Not done: culling, and
// warp divergence between short and long paths (the lane scheduler's job).
//
// Build with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false and
// without --use_fast_math (see render_device.cuh and kernels/build.py). With
// no FMA contraction every operation rounds as in the plain PyTorch version,
// and the two produce bit-identical lane state on the card.
#include <cuda_runtime.h>

#include "render_device.cuh"

using namespace rt;

// Largest block the launcher accepts.
constexpr int MAX_TILE = 512;

SWEEP_KERNEL render_kernel(const float4* __restrict__ table, int n_spheres, const float* __restrict__ cam_vec,
                           const float* __restrict__ sf, const int* __restrict__ si, float* __restrict__ of,
                           int* __restrict__ oi, int n_lanes, int seed, int sample_offset, int budget, int spp,
                           int max_depth) {
    extern __shared__ float4 s_sweep[];
    __shared__ float s_cam[CAM_LEN];
    load_sweep_table(s_sweep, table, n_spheres);
    if (threadIdx.x < CAM_LEN) s_cam[threadIdx.x] = cam_vec[threadIdx.x];
    __syncthreads();

    const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n_lanes) return;
    const int64_t P = n_lanes;
    const Cam cam = unpack_cam(s_cam);

    // The lane's global pixel id and its per-pixel stream base, like
    // curand_init(seed, pixel_index, 0) (reference: src/gpu/camera.h:186).
    const int pix = si[SI_PIX * P + j];
    const float px = (float)(pix % cam.width);
    const float py = (float)(pix / cam.width);
    const uint32_t h0 = pcg((uint32_t)pix ^ pcg((uint32_t)seed));

    vec3 o = {sf[(SF_O + 0) * P + j], sf[(SF_O + 1) * P + j], sf[(SF_O + 2) * P + j]};
    vec3 d = {sf[(SF_D + 0) * P + j], sf[(SF_D + 1) * P + j], sf[(SF_D + 2) * P + j]};
    vec3 att = {sf[(SF_ATT + 0) * P + j], sf[(SF_ATT + 1) * P + j], sf[(SF_ATT + 2) * P + j]};
    vec3 rad = {sf[(SF_RAD + 0) * P + j], sf[(SF_RAD + 1) * P + j], sf[(SF_RAD + 2) * P + j]};
    float work = sf[SF_WORK * P + j];
    int started = si[SI_STARTED * P + j];
    int depth = si[SI_DEPTH * P + j];
    bool busy = si[SI_BUSY * P + j] > 0;
    Stream st = {(uint32_t)si[SI_STREAM * P + j], (uint32_t)si[SI_STREAM2 * P + j]};

    // An idle lane with samples left starts one (on entry, or right after its
    // ray retired); a busy lane advances one bounce per iteration.
    int iters = 0;
    for (;;) {
        if (!busy && started < spp) {
            camera_ray(cam, h0, px, py, (uint32_t)(started + sample_offset), o, d, st);
            ++started;
            depth = 0;
            att = {1.0f, 1.0f, 1.0f};
            busy = true;
        }
        if (!busy || iters >= budget) break;
        work += 1.0f;
        busy = bounce(s_sweep, table, n_spheres, cam.t_min, max_depth, o, d, att, rad, depth, st);
        ++iters;
    }

    of[(SF_O + 0) * P + j] = o.x;
    of[(SF_O + 1) * P + j] = o.y;
    of[(SF_O + 2) * P + j] = o.z;
    of[(SF_D + 0) * P + j] = d.x;
    of[(SF_D + 1) * P + j] = d.y;
    of[(SF_D + 2) * P + j] = d.z;
    of[(SF_ATT + 0) * P + j] = att.x;
    of[(SF_ATT + 1) * P + j] = att.y;
    of[(SF_ATT + 2) * P + j] = att.z;
    of[(SF_RAD + 0) * P + j] = rad.x;
    of[(SF_RAD + 1) * P + j] = rad.y;
    of[(SF_RAD + 2) * P + j] = rad.z;
    of[SF_ITERS * P + j] = (float)iters;
    of[SF_WORK * P + j] = work;
    for (int r = SF_WORK + 1; r < SF_ROWS; ++r) of[r * P + j] = 0.0f;
    oi[SI_PIX * P + j] = pix;
    oi[SI_STARTED * P + j] = started;
    oi[SI_STREAM * P + j] = (int)st.lo;
    oi[SI_DEPTH * P + j] = depth;
    oi[SI_BUSY * P + j] = busy ? 1 : 0;
    oi[SI_STREAM2 * P + j] = (int)st.hi;
    for (int r = SI_STREAM2 + 1; r < SI_ROWS; ++r) oi[r * P + j] = 0;
}

// The largest scene a block's sweep table takes beside the static camera
// vector, in the default 48 KB (no opt-in): what the launcher accepts.
extern "C" int rt_render_max_spheres() {
    return (int)((DEFAULT_BLOCK_SMEM - sizeof(float) * CAM_LEN) / sizeof(float4));
}

// Launch one pass on `stream`. table: [n_spheres, 16] f32; cam: [CAM_LEN] f32;
// sf/of: [SF_ROWS, n_lanes] f32; si/oi: [SI_ROWS, n_lanes] i32, all device
// pointers; n_lanes a multiple of tile. Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for a scene the sweep table
// cannot hold. The caller checks shapes and limits.
extern "C" int rt_render_pass(const void* table, int n_spheres, const void* cam, const void* sf, const void* si,
                              void* of, void* oi, int n_lanes, int tile, int seed, int sample_offset, int budget,
                              int spp, int max_depth, void* stream) {
    if (n_spheres <= 0 || n_spheres > rt_render_max_spheres()) return (int)cudaErrorInvalidValue;
    render_kernel<<<n_lanes / tile, tile, sweep_table_bytes(n_spheres), (cudaStream_t)stream>>>(
        (const float4*)table, n_spheres, (const float*)cam, (const float*)sf, (const int*)si, (float*)of, (int*)oi,
        n_lanes, seed, sample_offset, budget, spp, max_depth);
    return (int)cudaGetLastError();
}

extern "C" int rt_max_tile() { return MAX_TILE; }

// Resident blocks of `tile` threads an SM holds for a scene of `n_spheres`
// (registers, shared memory and the SM's limits), or minus the CUDA error.
extern "C" int rt_render_blocks_per_sm(int tile, int n_spheres) {
    int blocks = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, render_kernel, tile, sweep_table_bytes(n_spheres));
    return err == cudaSuccess ? blocks : -(int)err;
}

extern "C" const char* rt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
