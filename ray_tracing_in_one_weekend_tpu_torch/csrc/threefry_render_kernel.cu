// Forward render of the jnp backend on threefry keys, hand-written for Hopper
// (sm_90a).
//
// Replaces the JAX package's jnp path, ops/render.py::render_image ->
// ops/integrator.py::trace_rays (XLA-fused; there is no Pallas kernel), and
// computes what it computes: for each pixel, samples [sample_offset,
// sample_offset + spp) in order, each ray traced to a miss, an absorption or
// max_depth bounces, its radiance added to a float32 sum in sample order and
// the sum divided by spp. Every draw is a threefry2x32 uniform
// (threefry.cuh): sample s of global pixel p keys on
// fold_in(fold_in(base, p), s), the camera on fold_in(., 0) then domain
// 1 << 20, bounce i on fold_in(fold_in(., 1), i). The plain version is
// ops/render.py::render_pixels_threefry, operation for operation. The device
// functions and the pixel loop below live in threefry_device.cuh
// (trace_pixels<false>), which the keyed train step's recording forward
// (threefry_grad_kernel.cu) runs too, with records.
//
// Layout: persistent blocks of 128 threads, SMs x resident blocks of them
// (rt_threefry_grid; fewer for a small n), each thread one pixel at a time
// from a queue. Thread g starts on position g of `pix` (the global pixel
// ids that sharding and the caller's pixel subset give); when its pixel's
// spp samples are done it writes out[j] and work[j] and takes the next
// position from `queue`, one int32 in device memory that the wrapper zeroes
// for every launch and that hands out positions from the grid's thread count
// up. The lanes of a warp that finish a pixel in the same iteration take
// their positions with one atomicAdd through a leader. One thread still
// sums a pixel's samples in sample order and a pixel's value depends only
// on its global id, so the image and the work map are the same bits for
// any grid and any assignment of pixels to threads. The thread's loop runs
// one bounce an iteration, starts its next sample when a ray retires and
// its next pixel when a pixel is done, so no lane idles while the queue has
// work: a warp no longer waits for its longest pixel, only the last pixels
// handed out form a tail.
//
// Each block builds the sweep table in shared memory, one float4 (cx, cy,
// cz, |c|^2 - r^2) a sphere (8 KB at 512 slots), |c|^2 - r^2 being +inf for
// an inactive slot: then c = +inf, a c = +inf and disc = -inf (or NaN when
// a = 0), never > 0, so the sweep needs no mask.
//
// The sweep is the JAX formula for a direction that is not unit, with XLA's
// fused multiply-adds on the CPU (ops/intersect.py): per sphere two dot
// products of a multiply and two __fmaf_rn each, half_b, c = (|o|^2 -
// 2 o.c) + (|c|^2 - r^2), a c and disc = fma(half_b, half_b, -(a c)), then
// the roots only where disc > 0, with a strict < argmin in index order (the
// lowest index wins a tie). The ray's o2 = -2o is taken once, so o2.c is
// -2 (o.c) bit for bit (scaling by -2 is exact short of overflow) and c
// costs two adds: 16 FP32 operations a test, an FMA counting two. As in
// closest_hit (render_device.cuh), THREEFRY_GROUP (8) tests compute their
// discriminants together with no branch and their sign bits are tested
// once: only when one is clear (a root may exist; the test is
// conservative, +0 and NaN enter too) does the group look at its roots. It
// then marks its tests with disc > 0 and takes them in index order, each
// test computed again (the same operations, so the same bits) and its
// roots and the strict < update taken: a lane runs as many root steps as
// it has candidates in the group, not eight (a warp enters a group when any
// of its lanes has one there). The winner's row of the packed [N, 16]
// table is read from device memory.
//
// What bounds it: that FP32 sweep, N tests a bounce (13.62 SASS
// instructions a test: 5 FFMA, 3 FMUL, 3 FADD, the shared load and the
// group's share of its sign test and loop), beside about 6 threefry blocks
// a bounce (one fold_in and up to 5 uniforms; 20 rounds of an add, a
// funnel shift and a xor each) of integer work, a few hundred
// instructions against several thousand for the sweep at 485 spheres. No
// device memory is touched inside the loop but the winner's row and, once
// a pixel, its id, its outputs and the queue. The camera ray, the scatter
// and their threefry blocks are computed where a ray starts or bounces and
// hold no register across the sweep. The kernel runs under a register cap
// (__maxnreg__, RT_THREEFRY_REGS = 72: 71 registers, no spill, 7 blocks of
// 128 threads an SM). probes/sweep_variants.py chose it on an H100 80GB
// HBM3 at 700 W (the bench image, best / median of 7 rounds in turns):
// group 8 at cap 72 11.38 / 11.56 ms, at 64 (8 blocks an SM) 11.97 /
// 12.11, at 80 and 96 (78-79 registers, 6 blocks) 11.59-11.88 / 11.69-
// 11.95; group 4 12.19-12.71 / 12.40-12.82 at every cap; the earlier
// design (one thread a pixel fixed at launch, a branch a sphere test:
// 19.25 SASS a test, 96 registers, 5 blocks an SM) 31.89 / 31.96 ms. What
// the queue leaves is its tail: when it runs dry every warp still carries
// lanes with part of a pixel to finish, and a sweep costs a warp as much
// for one lane as for 32 (chip_smoke.py phase 15d measures it). Not done:
// culling, or handing out the costly pixels first.
//
// Build with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false and
// without --use_fast_math (kernels/build.py): each operation then rounds as
// in the plain PyTorch version on the card, whose fused multiply-adds are
// computed exactly (ops/vecmath.py fma), so the two agree bit for bit.
#include <cuda_runtime.h>

#include "threefry_device.cuh"

namespace tfr {

// The kernel's register cap (the source note); probes/sweep_variants.py
// builds others with -DRT_THREEFRY_REGS=r.
#ifndef RT_THREEFRY_REGS
#define RT_THREEFRY_REGS 72
#endif
#define THREEFRY_KERNEL __global__ void __maxnreg__(RT_THREEFRY_REGS)

THREEFRY_KERNEL threefry_render_kernel(const float4* __restrict__ table, int n_spheres,
                                       const float* __restrict__ cam_vec, const int* __restrict__ pix, int n,
                                       uint32_t key0, uint32_t key1, int sample_offset, int spp, int max_depth,
                                       float* __restrict__ out, int* __restrict__ work, int* __restrict__ queue) {
    extern __shared__ float4 s_sweep[];
    __shared__ float s_cam[rt::CAM_LEN];
    load_tables(s_sweep, s_cam, table, n_spheres, cam_vec);
    trace_pixels<false>(table, s_sweep, n_spheres, s_cam, pix, n, key0, key1, sample_offset, spp, max_depth, out,
                        work, queue, Arena{});
}

}  // namespace tfr

// The largest scene a block's sweep table takes beside the static camera
// vector, in the default 48 KB of shared memory.
extern "C" int rt_threefry_max_spheres() {
    return (int)((rt::DEFAULT_BLOCK_SMEM - sizeof(float) * rt::CAM_LEN) / sizeof(float4));
}

extern "C" int rt_threefry_block() { return tfr::BLOCK; }

// Resident blocks an SM holds for a scene of `n_spheres`, or minus the CUDA
// error.
extern "C" int rt_threefry_blocks_per_sm(int n_spheres) {
    return tfr::blocks_per_sm(tfr::threefry_render_kernel, rt::sweep_table_bytes(n_spheres));
}

// The persistent grid for `n` positions on the current device
// (tfr::persistent_grid), or minus the CUDA error.
extern "C" int rt_threefry_grid(int n_spheres, int n) {
    return tfr::persistent_grid(tfr::threefry_render_kernel, rt::sweep_table_bytes(n_spheres), n);
}

// Launch the render of `n` positions on `stream`. table: [n_spheres, 16]
// f32 (the transposed packed scene); cam: [CAM_LEN] f32; pix: [n] i32
// global pixel ids; out: [n, 3] f32; work: [n] i32 sweeps a pixel, or null;
// queue: one i32, zero on the stream before the launch. All device
// pointers. Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a scene the table cannot hold or an `n` whose
// positions past the grid do not fit in int32.
extern "C" int rt_threefry_render(const void* table, int n_spheres, const void* cam, const void* pix, int n,
                                  unsigned int key0, unsigned int key1, int sample_offset, int spp, int max_depth,
                                  void* out, void* work, void* queue, void* stream) {
    if (n_spheres <= 0 || n_spheres > rt_threefry_max_spheres()) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    const int grid = rt_threefry_grid(n_spheres, n);
    if (grid < 0) return -grid;
    // Each thread takes at most one position past n before it stops.
    if ((int64_t)n + (int64_t)grid * tfr::BLOCK > INT32_MAX) return (int)cudaErrorInvalidValue;
    tfr::threefry_render_kernel<<<grid, tfr::BLOCK, rt::sweep_table_bytes(n_spheres), (cudaStream_t)stream>>>(
        (const float4*)table, n_spheres, (const float*)cam, (const int*)pix, n, key0, key1, sample_offset, spp,
        max_depth, (float*)out, (int*)work, (int*)queue);
    return (int)cudaGetLastError();
}
