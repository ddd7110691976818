// Device functions of the keyed (threefry) path: the JAX package's jnp bounce
// with XLA's fused multiply-adds on the CPU, and the persistent pixel loop
// that threefry_render_kernel.cu (the forward) and threefry_grad_kernel.cu
// (the forward that records, for the backward) both run.
//
// The loop is one template, `trace_pixels<RECORD>`: the forward instantiates
// it without records, the recording forward with one 64-byte record a
// sweep. Both write the image and the work map and take their decisions
// (the winner, the root, front face, metal absorbed, must_reflect) by the
// same instructions, so with the same build flags (-fmad=false, explicit
// __fmaf_rn, no fast-math) the recording forward renders the forward's bits
// and its records are the forward's paths, so the keyed train step sweeps
// each bounce once. The recording instance adds a warp-aggregated atomicAdd
// and one 64-byte record store a sweep; what bounds both on the H100 is
// the FP32 sweep (threefry_render_kernel.cu's note). Each function is the
// counterpart of the plain PyTorch function it names (ops/intersect.py,
// ops/materials.py, ops/integrator.py, models/camera.py), operation for
// operation.
#pragma once

#include <cuda_runtime.h>

#include "render_device.cuh"
#include "threefry.cuh"

namespace tfr {

using rt::vec3;

constexpr int BLOCK = 128;

// The sweep's group (threefry_render_kernel.cu's source note);
// probes/sweep_variants.py builds others with -DRT_THREEFRY_GROUP=g.
#ifndef RT_THREEFRY_GROUP
#define RT_THREEFRY_GROUP 8
#endif
constexpr int THREEFRY_GROUP = RT_THREEFRY_GROUP;

constexpr float T_MAX = 1e30f;  // t_max: the JAX path's T_MISS
constexpr uint32_t CAMERA_DOMAIN = 1u << 20;

// Record words (float4 r[4]; int fields as int32 bits), the layout of the
// PCG replay (grad_kernel.cu) in words 0-13: r[0] = o, d.x; r[1] = d.y, d.z,
// att.x, att.y; r[2] = att.z, winner (-1 for a miss), trace key k0, k1; r[3]
// = bounce index, end, then the link: the arena index (int64, low word
// first) of the same path's previous record, -1 at its first. end: the path
// goes on after this bounce, ends without radiance (absorbed, or at the
// depth limit), or ends at the sky (a miss).
constexpr int END_NONE = 0, END_DARK = 1, END_SKY = 2;

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

// The unit sample of bounce draws k (uniforms 0-3).
__device__ __forceinline__ vec3 jnp_unit_sample(tf::Key k) {
    return jnp_unit_from_uniforms(tf::uniform(k, 0u), tf::uniform(k, 1u), tf::uniform(k, 2u), tf::uniform(k, 3u));
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

// A sphere's sweep-table entry (cx, cy, cz, |c|^2 - r^2) from its table row
// (cx, cy, cz, r); +inf in w for an inactive slot.
__device__ __forceinline__ float4 sweep_entry(float4 c, bool active) {
    const float c_sq = __fmaf_rn(c.z, c.z, __fmaf_rn(c.y, c.y, c.x * c.x));
    return make_float4(c.x, c.y, c.z, active ? __fmaf_rn(-c.w, c.w, c_sq) : __int_as_float(0x7F800000));
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
        const vec3 us = jnp_unit_sample(k);
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

// The next entry of a 64-bit queue for each active lane: one atomicAdd a
// warp, through its lowest active lane, so the lanes' entries are
// consecutive in lane order. The recording forward takes its arena slots so
// (a converged warp's 32 records are one run of 2 KB), the reverse walk its
// paths.
__device__ __forceinline__ long long queue_take(unsigned long long* total) {
    const unsigned mask = __activemask();
    const int lane = (int)(threadIdx.x & 31u);
    const int leader = __ffs(mask) - 1;
    unsigned long long base = 0;
    if (lane == leader) base = atomicAdd(total, (unsigned long long)__popc(mask));
    base = __shfl_sync(mask, base, leader);
    return (long long)base + __popc(mask & ((1u << lane) - 1u));
}

// Where the recording forward writes: `records` holds `capacity` records;
// `total` counts the slots taken (past `capacity` when the arena ran out: a
// slot there is counted and not written, so `total` ends as the exact
// number of sweeps); path k = position x spp + sample gets its sweeps in
// path_count[k] and the slot of its last record in path_last[k].
struct Arena {
    float4* records;
    long long capacity;
    unsigned long long* total;
    int* path_count;
    long long* path_last;
};

__device__ __forceinline__ void put_record(const Arena& arena, long long slot, vec3 o, vec3 d, vec3 att, int winner,
                                           tf::Key k, int depth, int end, long long prev) {
    if (slot >= arena.capacity) return;
    float4* rec = arena.records + 4 * slot;
    rec[0] = make_float4(o.x, o.y, o.z, d.x);
    rec[1] = make_float4(d.y, d.z, att.x, att.y);
    rec[2] = make_float4(att.z, __int_as_float(winner), __uint_as_float(k.k0), __uint_as_float(k.k1));
    rec[3] = make_float4(__int_as_float(depth), __int_as_float(end), __int_as_float((int)(prev & 0xFFFFFFFFll)),
                         __int_as_float((int)(prev >> 32)));
}

// A path's last record: its sweeps and where that record lies.
__device__ __forceinline__ void end_path(const Arena& arena, int j, int s, int spp, int depth, long long slot) {
    const long long k = (long long)j * spp + s;
    arena.path_count[k] = depth + 1;
    arena.path_last[k] = slot;
}

// Stage the sweep table and the camera in shared memory (every thread of the
// block, then a barrier).
__device__ __forceinline__ void load_tables(float4* s_sweep, float* s_cam, const float4* table, int n_spheres,
                                            const float* cam_vec) {
    for (int i = threadIdx.x; i < n_spheres; i += blockDim.x)
        s_sweep[i] = sweep_entry(table[4 * i], table[4 * i + 2].w > 0.5f);  // cx, cy, cz, r; active
    if (threadIdx.x < rt::CAM_LEN) s_cam[threadIdx.x] = cam_vec[threadIdx.x];
    __syncthreads();
}

// The persistent pixel loop (threefry_render_kernel.cu's source note): thread
// g starts on position g of `pix`, runs the pixel's spp samples a bounce an
// iteration, then takes its next position from `queue`. It writes out[j]
// (the sample mean) and work[j] (the sweeps) for each position; with RECORD
// also one record a sweep into the arena, in the order the sweeps are made,
// each linked to its path's previous one, and each path's table entries.
template <bool RECORD>
__device__ __forceinline__ void trace_pixels(const float4* __restrict__ table, const float4* s_sweep, int n_spheres,
                                             const float* s_cam, const int* __restrict__ pix, int n, uint32_t key0,
                                             uint32_t key1, int sample_offset, int spp, int max_depth,
                                             float* __restrict__ out, int* __restrict__ work,
                                             int* __restrict__ queue, Arena arena) {
    const int first = (int)(gridDim.x * blockDim.x);  // the queue's first position
    int j = (int)(blockIdx.x * blockDim.x + threadIdx.x);
    if (j >= n) return;
    tf::Key pixel_key = tf::fold_in({key0, key1}, (uint32_t)pix[j]);
    vec3 acc = {0.0f, 0.0f, 0.0f};
    vec3 o, d, att;
    tf::Key trace_key;
    int s = 0, depth = 0, bounces = 0;
    long long prev = -1;  // the path's previous record (RECORD)
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
            if constexpr (RECORD) prev = -1;
            busy = true;
        }
        float t_best;
        int best;
        jnp_closest_hit(s_sweep, n_spheres, o, d, s_cam[20], t_best, best);
        ++bounces;
        long long slot = 0;
        if constexpr (RECORD) slot = queue_take(arena.total);
        if (!(t_best < rt::T_MISS * 0.5f)) {  // miss: the sky, and the ray retires
            if constexpr (RECORD) {
                put_record(arena, slot, o, d, att, -1, trace_key, depth, END_SKY, prev);
                end_path(arena, j, s, spp, depth, slot);
            }
            acc = acc + att * jnp_sky(d);
            busy = false;
            ++s;
            continue;
        }
        if (depth + 1 == max_depth) {  // out of depth: dark
            if constexpr (RECORD) {
                put_record(arena, slot, o, d, att, best, trace_key, depth, END_DARK, prev);
                end_path(arena, j, s, spp, depth, slot);
            }
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
            if constexpr (RECORD) {
                put_record(arena, slot, o, d, att, best, trace_key, depth, END_DARK, prev);
                end_path(arena, j, s, spp, depth, slot);
            }
            busy = false;  // absorbed: dark
            ++s;
            continue;
        }
        if constexpr (RECORD) {
            put_record(arena, slot, o, d, att, best, trace_key, depth, END_NONE, prev);
            prev = slot;
        }
        att = att * mat_att;
        o = point;
        d = new_dir;
        ++depth;
    }
}

// Resident blocks an SM holds of `kernel` (a BLOCK-thread kernel with
// `smem_bytes` of dynamic shared memory: a sweep table's
// rt::sweep_table_bytes, or 0), or minus the CUDA error.
template <typename Kernel>
inline int blocks_per_sm(Kernel kernel, size_t smem_bytes) {
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, BLOCK, smem_bytes);
    return err == cudaSuccess ? blocks : -(int)err;
}

// `kernel`'s persistent grid for `n` items (positions, or paths) on the
// current device: SMs x resident blocks, at most one block a 128 items.
// Minus the CUDA error on failure.
template <typename Kernel>
inline int persistent_grid(Kernel kernel, size_t smem_bytes, long long n) {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return -(int)err;
    const int per_sm = blocks_per_sm(kernel, smem_bytes);
    if (per_sm < 0) return per_sm;
    const long long most = (n + BLOCK - 1) / BLOCK;
    const int grid = sms * (per_sm > 0 ? per_sm : 1);
    return grid < most ? grid : (int)most;
}

}  // namespace tfr
