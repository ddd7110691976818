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
// ops/render.py::render_pixels_threefry, operation for operation.
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

#include "render_device.cuh"
#include "threefry.cuh"

namespace tfr {

using rt::vec3;

constexpr int BLOCK = 128;

// The sweep's group and the kernel's register cap (the source note);
// probes/sweep_variants.py builds others with -DRT_THREEFRY_GROUP=g
// -DRT_THREEFRY_REGS=r.
#ifndef RT_THREEFRY_GROUP
#define RT_THREEFRY_GROUP 8
#endif
#ifndef RT_THREEFRY_REGS
#define RT_THREEFRY_REGS 72
#endif
constexpr int THREEFRY_GROUP = RT_THREEFRY_GROUP;
#define THREEFRY_KERNEL __global__ void __maxnreg__(RT_THREEFRY_REGS)

constexpr float T_MAX = 1e30f;  // t_max: the JAX path's T_MISS
constexpr uint32_t CAMERA_DOMAIN = 1u << 20;

__device__ __forceinline__ float jnp_dot_fma(vec3 a, vec3 b) {
    return __fmaf_rn(a.z, b.z, __fmaf_rn(a.y, b.y, a.x * b.x));
}

// v * (1 / sqrt(|v|^2)), zero for a zero vector (vecmath.unit_vector_fma).
__device__ __forceinline__ vec3 jnp_unit_vector(vec3 v) {
    const float sq = jnp_dot_fma(v, v);
    const float scale = sq > 0.0f ? 1.0f / sqrtf(sq) : 0.0f;
    return v * scale;
}

__device__ __forceinline__ vec3 jnp_fma3(float s, vec3 v, vec3 c) {
    return {__fmaf_rn(s, v.x, c.x), __fmaf_rn(s, v.y, c.y), __fmaf_rn(s, v.z, c.z)};
}

// Box-Muller Gaussians from (u0, u1) and (u2, u3), normalized
// (sampling.unit_vector_from_uniforms).
__device__ __forceinline__ vec3 jnp_unit_from_uniforms(float u0, float u1, float u2, float u3) {
    const float r1 = sqrtf(-2.0f * logf(fmaxf(u0, 1e-12f)));
    const float r2 = sqrtf(-2.0f * logf(fmaxf(u2, 1e-12f)));
    const float t1 = rt::TWO_PI * u1;
    const float t2 = rt::TWO_PI * u3;
    const vec3 g = {r1 * cosf(t1), r1 * sinf(t1), r2 * cosf(t2)};
    return g * rsqrtf(fmaxf(jnp_dot_fma(g, g), 1e-12f));
}

// The camera ray of one sample (models/camera.get_rays): direction not unit.
__device__ __forceinline__ void jnp_camera_ray(const rt::Cam& cam, tf::Key ray_key, float px, float py,
                                               vec3& o, vec3& d) {
    const tf::Key k = tf::fold_in(ray_key, CAMERA_DOMAIN);
    const float fx = px + (tf::uniform(k, 0u) - 0.5f);
    const float fy = py + (tf::uniform(k, 1u) - 0.5f);
    const vec3 sample = jnp_fma3(fy, cam.delta_v, jnp_fma3(fx, cam.delta_u, cam.pixel00));
    if (cam.defocus) {
        const float r = sqrtf(tf::uniform(k, 2u));
        const float theta = rt::TWO_PI * tf::uniform(k, 3u);
        o = jnp_fma3(r * sinf(theta), cam.disk_v, jnp_fma3(r * cosf(theta), cam.disk_u, cam.center));
    } else {
        o = cam.center;
    }
    d = sample - o;
}

// The quadratic of one sphere test (intersect.sphere_hit_ts): returns disc,
// sets half_b. o2 = -2o, so o2.c is -2 (o.c) bit for bit.
__device__ __forceinline__ float jnp_disc(float4 c, vec3 o2, vec3 d, float a, float o_dot_d, float o_sq,
                                          float& half_b) {
    const float d_dot_c = __fmaf_rn(d.z, c.z, __fmaf_rn(d.y, c.y, d.x * c.x));
    const float o2_dot_c = __fmaf_rn(o2.z, c.z, __fmaf_rn(o2.y, c.y, o2.x * c.x));
    half_b = o_dot_d - d_dot_c;
    const float cc = (o_sq + o2_dot_c) + c.w;
    return __fmaf_rn(half_b, half_b, -(a * cc));
}

// The roots of one test where it has a real one (has_root: disc > 0), and
// the strict < update: the nearer root in (t_min, t_max), else the farther.
__device__ __forceinline__ void jnp_take_root(float half_b, float disc, int i, float inv_a, float t_min,
                                              float& t_best, int& best) {
    if (disc > 0.0f) {
        const float sqrt_d = sqrtf(disc);
        const float root_near = (-half_b - sqrt_d) * inv_a;
        const float t = (root_near > t_min && root_near < T_MAX) ? root_near : (-half_b + sqrt_d) * inv_a;
        if (t > t_min && t < T_MAX && t < t_best) {
            t_best = t;
            best = i;
        }
    }
}

// The nearest root in (t_min, t_max) over the sweep table; best = 0 and
// t_best = T_MISS on a miss (intersect.sphere_hit_ts, then the minimum).
// THREEFRY_GROUP tests a trip, roots only when a sign bit of the group's
// discs is clear (every bit set: each disc is < 0, -inf or a negative
// NaN, none > 0); slots past the last whole group go one by one.
__device__ __forceinline__ void jnp_closest_hit(const float4* sweep, int n, vec3 o, vec3 d, float t_min,
                                                float& t_best, int& best) {
    const float a = jnp_dot_fma(d, d);
    const float o_dot_d = jnp_dot_fma(o, d);
    const float o_sq = jnp_dot_fma(o, o);
    const float inv_a = 1.0f / a;
    const vec3 o2 = -2.0f * o;
    t_best = rt::T_MISS;
    best = 0;
    const float4* c = sweep;
    for (const float4* end = sweep + (n - n % THREEFRY_GROUP); c != end; c += THREEFRY_GROUP) {
        float half_b[THREEFRY_GROUP], disc[THREEFRY_GROUP];
        int signs = -1;
#pragma unroll
        for (int k = 0; k < THREEFRY_GROUP; ++k) {
            disc[k] = jnp_disc(c[k], o2, d, a, o_dot_d, o_sq, half_b[k]);
            signs &= __float_as_int(disc[k]);
        }
        if (signs >= 0) {
            // The tests with a root, in index order: each is taken again
            // (the same operations, so the same bits) and its roots found.
            unsigned roots = 0u;
#pragma unroll
            for (int k = 0; k < THREEFRY_GROUP; ++k) roots |= (disc[k] > 0.0f ? 1u : 0u) << k;
            const int i = (int)(c - sweep);
            while (roots != 0u) {
                const int k = __ffs(roots) - 1;
                roots &= roots - 1u;
                float hb;
                const float dk = jnp_disc(c[k], o2, d, a, o_dot_d, o_sq, hb);
                jnp_take_root(hb, dk, i + k, inv_a, t_min, t_best, best);
            }
        }
    }
    for (const float4* end = sweep + n; c != end; ++c) {
        float half_b;
        const float disc = jnp_disc(*c, o2, d, a, o_dot_d, o_sq, half_b);
        jnp_take_root(half_b, disc, (int)(c - sweep), inv_a, t_min, t_best, best);
    }
}

__device__ __forceinline__ vec3 jnp_sky(vec3 d) {
    const float a = 0.5f * (jnp_unit_vector(d).y + 1.0f);
    const float one_m_a = 1.0f - a;
    return {__fmaf_rn(a, 0.5f, one_m_a), __fmaf_rn(a, 0.7f, one_m_a), __fmaf_rn(a, 1.0f, one_m_a)};
}

// Scatter at the hit (materials.scatter_sampled): returns false for an
// absorbed metal ray; new_dir is not unit.
__device__ __forceinline__ bool jnp_scatter(vec3 d, vec3 n, bool front_face, float4 r1, float4 r2,
                                            tf::Key k, vec3& new_dir, vec3& atten) {
    const vec3 unit_in = jnp_unit_vector(d);
    const float mat = r2.z;
    if (mat < 1.5f) {
        const vec3 us = jnp_unit_from_uniforms(tf::uniform(k, 0u), tf::uniform(k, 1u), tf::uniform(k, 2u),
                                               tf::uniform(k, 3u));
        atten = {r1.y, r1.z, r1.w};
        if (mat < 0.5f) {  // lambertian
            const vec3 dir = n + us;
            const bool near_zero = fabsf(dir.x) < 1e-8f && fabsf(dir.y) < 1e-8f && fabsf(dir.z) < 1e-8f;
            new_dir = near_zero ? n : dir;
            return true;
        }
        const vec3 reflected = jnp_fma3(-2.0f * jnp_dot_fma(unit_in, n), n, unit_in);  // metal
        new_dir = jnp_fma3(r2.x, us, reflected);
        return jnp_dot_fma(new_dir, n) > 0.0f;
    }
    const float reflect_u = tf::uniform(k, 4u);  // dielectric
    const float ior = r2.y;
    const float ratio = front_face ? 1.0f / ior : ior;
    const float cos_theta = fminf(jnp_dot_fma(-unit_in, n), 1.0f);
    const float sin_theta = sqrtf(fmaxf(__fmaf_rn(-cos_theta, cos_theta, 1.0f), 1e-12f));
    float r0 = (1.0f - ratio) / (1.0f + ratio);
    r0 = r0 * r0;
    const float x = 1.0f - cos_theta;
    const float x2 = x * x;
    const float schlick = __fmaf_rn(1.0f - r0, x * (x2 * x2), r0);
    if (ratio * sin_theta > 1.0f || schlick > reflect_u) {
        new_dir = jnp_fma3(-2.0f * jnp_dot_fma(unit_in, n), n, unit_in);
    } else {
        const vec3 perp = ratio * jnp_fma3(cos_theta, n, unit_in);
        const float k2 = 1.0f - jnp_dot_fma(perp, perp);
        const float sqrt_k = k2 > 0.0f ? sqrtf(k2) : 0.0f;
        new_dir = jnp_fma3(-sqrt_k, n, perp);
    }
    atten = {1.0f, 1.0f, 1.0f};
    return true;
}

// The next position of the lanes that finished a pixel together: one
// atomicAdd a warp, through its lowest active lane, in lane order.
__device__ __forceinline__ int next_position(int* queue, int first) {
    const unsigned mask = __activemask();
    const int lane = (int)(threadIdx.x & 31u);
    const int leader = __ffs(mask) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(queue, __popc(mask));
    base = __shfl_sync(mask, base, leader);
    return first + base + __popc(mask & ((1u << lane) - 1u));
}

THREEFRY_KERNEL threefry_render_kernel(const float4* __restrict__ table, int n_spheres,
                                       const float* __restrict__ cam_vec, const int* __restrict__ pix, int n,
                                       uint32_t key0, uint32_t key1, int sample_offset, int spp, int max_depth,
                                       float* __restrict__ out, int* __restrict__ work, int* __restrict__ queue) {
    extern __shared__ float4 s_sweep[];
    __shared__ float s_cam[rt::CAM_LEN];
    for (int i = threadIdx.x; i < n_spheres; i += blockDim.x) {
        const float4 c = table[4 * i];  // cx, cy, cz, r
        const bool active = table[4 * i + 2].w > 0.5f;
        const float c_sq = __fmaf_rn(c.z, c.z, __fmaf_rn(c.y, c.y, c.x * c.x));
        s_sweep[i] = make_float4(c.x, c.y, c.z, active ? __fmaf_rn(-c.w, c.w, c_sq) : __int_as_float(0x7F800000));
    }
    if (threadIdx.x < rt::CAM_LEN) s_cam[threadIdx.x] = cam_vec[threadIdx.x];
    __syncthreads();

    const int first = (int)(gridDim.x * blockDim.x);  // the queue's first position
    int j = (int)(blockIdx.x * blockDim.x + threadIdx.x);
    if (j >= n) return;
    tf::Key pixel_key = tf::fold_in({key0, key1}, (uint32_t)pix[j]);
    vec3 acc = {0.0f, 0.0f, 0.0f};
    vec3 o, d, att;
    tf::Key trace_key;
    int s = 0, depth = 0, bounces = 0;
    bool busy = false;
    for (;;) {
        if (!busy) {
            if (s == spp) {  // the pixel is done: write it, take the next position
                const float inv = (float)spp;
                out[3 * (int64_t)j + 0] = acc.x / inv;
                out[3 * (int64_t)j + 1] = acc.y / inv;
                out[3 * (int64_t)j + 2] = acc.z / inv;
                if (work != nullptr) work[j] = bounces;
                j = next_position(queue, first);
                if (j >= n) break;
                pixel_key = tf::fold_in({key0, key1}, (uint32_t)pix[j]);
                acc = {0.0f, 0.0f, 0.0f};
                s = 0;
                bounces = 0;
            }
            const int p = pix[j];
            const rt::Cam cam = rt::unpack_cam(s_cam);
            const tf::Key k = tf::fold_in(pixel_key, (uint32_t)(sample_offset + s));
            jnp_camera_ray(cam, tf::fold_in(k, 0u), (float)(p % cam.width), (float)(p / cam.width), o, d);
            trace_key = tf::fold_in(k, 1u);
            att = {1.0f, 1.0f, 1.0f};
            depth = 0;
            busy = true;
        }
        float t_best;
        int best;
        jnp_closest_hit(s_sweep, n_spheres, o, d, s_cam[20], t_best, best);
        ++bounces;
        if (!(t_best < rt::T_MISS * 0.5f)) {  // miss: the sky, and the ray retires
            acc = acc + att * jnp_sky(d);
            busy = false;
            ++s;
            continue;
        }
        if (depth + 1 == max_depth) {  // out of depth: dark
            busy = false;
            ++s;
            continue;
        }
        const float4* row = table + 4 * best;
        const float4 r0 = __ldg(row), r1 = __ldg(row + 1), r2 = __ldg(row + 2);
        const vec3 point = jnp_fma3(t_best, d, o);
        const vec3 c = {r0.x, r0.y, r0.z};
        const vec3 outward = {(point.x - c.x) / r0.w, (point.y - c.y) / r0.w, (point.z - c.z) / r0.w};
        const bool front_face = jnp_dot_fma(d, outward) < 0.0f;
        const vec3 normal = front_face ? outward : -outward;
        vec3 new_dir, mat_att;
        if (!jnp_scatter(d, normal, front_face, r1, r2, tf::fold_in(trace_key, (uint32_t)depth), new_dir, mat_att)) {
            busy = false;  // absorbed: dark
            ++s;
            continue;
        }
        att = att * mat_att;
        o = point;
        d = new_dir;
        ++depth;
    }
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
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, tfr::threefry_render_kernel, tfr::BLOCK, rt::sweep_table_bytes(n_spheres));
    return err == cudaSuccess ? blocks : -(int)err;
}

// The persistent grid for `n` positions on the current device: SMs x
// resident blocks, at most one block a 128 positions. Minus the CUDA error
// on failure.
extern "C" int rt_threefry_grid(int n_spheres, int n) {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return -(int)err;
    const int per_sm = rt_threefry_blocks_per_sm(n_spheres);
    if (per_sm < 0) return per_sm;
    const int most = (n + tfr::BLOCK - 1) / tfr::BLOCK;
    const int grid = sms * (per_sm > 0 ? per_sm : 1);
    return grid < most ? grid : most;
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
