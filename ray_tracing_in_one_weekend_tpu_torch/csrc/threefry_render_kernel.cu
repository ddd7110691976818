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
// Layout: one thread per pixel (ids from `pix`, which sharding and the
// caller's pixel subset give), 128 threads a block. Each block builds the
// sweep table in shared memory, one float4 (cx, cy, cz, |c|^2 - r^2) a
// sphere (8 KB at 512 slots), |c|^2 - r^2 being +inf for an inactive slot:
// then c = +inf, a c = +inf and disc = -inf (or NaN when a = 0), never > 0,
// so the sweep needs no mask. The thread's loop runs one bounce an
// iteration and starts its next sample when a ray retires, so a warp runs
// until its pixels' summed path lengths are done, not each sample's longest.
//
// The sweep is the JAX formula for a direction that is not unit, with XLA's
// fused multiply-adds on the CPU (ops/intersect.py): per sphere two dot
// products of a multiply and two __fmaf_rn each, half_b, c (a multiply, a
// subtraction, an add), a c and disc = fma(half_b, half_b, -(a c)): 11
// FP32 operations and a compare, then the roots only where disc > 0, with a
// strict < argmin in index order (the lowest index wins a tie). The winner's
// row of the packed [N, 16] table is read from device memory.
//
// What bounds it: that FP32 sweep, about 11 operations a sphere test and N
// tests a bounce, beside about 6 threefry blocks a bounce (one fold_in and
// up to 5 uniforms; 20 rounds of an add, a funnel shift and a xor each) of
// integer work, a few hundred instructions against ~5000 for the sweep at
// 485 spheres. No device memory is touched inside the loop but the winner's
// row. Not done: culling, or regrouping rays across pixels by path length.
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

// The nearest root in (t_min, t_max) over the sweep table; best = 0 and
// t_best = T_MISS on a miss (intersect.sphere_hit_ts, then the minimum).
__device__ __forceinline__ void jnp_closest_hit(const float4* sweep, int n, vec3 o, vec3 d, float t_min,
                                                float& t_best, int& best) {
    const float a = jnp_dot_fma(d, d);
    const float o_dot_d = jnp_dot_fma(o, d);
    const float o_sq = jnp_dot_fma(o, o);
    const float inv_a = 1.0f / a;
    t_best = rt::T_MISS;
    best = 0;
    for (int i = 0; i < n; ++i) {
        const float4 c = sweep[i];
        const float d_dot_c = __fmaf_rn(d.z, c.z, __fmaf_rn(d.y, c.y, d.x * c.x));
        const float o_dot_c = __fmaf_rn(o.z, c.z, __fmaf_rn(o.y, c.y, o.x * c.x));
        const float half_b = o_dot_d - d_dot_c;
        const float cc = (o_sq - 2.0f * o_dot_c) + c.w;
        const float disc = __fmaf_rn(half_b, half_b, -(a * cc));
        if (disc > 0.0f) {
            const float sqrt_d = sqrtf(disc);
            const float root_near = (-half_b - sqrt_d) * inv_a;
            const float t =
                (root_near > t_min && root_near < T_MAX) ? root_near : (-half_b + sqrt_d) * inv_a;
            if (t > t_min && t < T_MAX && t < t_best) {
                t_best = t;
                best = i;
            }
        }
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

__global__ void __launch_bounds__(BLOCK) threefry_render_kernel(
    const float4* __restrict__ table, int n_spheres, const float* __restrict__ cam_vec, const int* __restrict__ pix,
    int n, uint32_t key0, uint32_t key1, int sample_offset, int spp, int max_depth, float* __restrict__ out,
    int* __restrict__ work) {
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

    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n) return;
    const rt::Cam cam = rt::unpack_cam(s_cam);
    const int p = pix[j];
    const float px = (float)(p % cam.width);
    const float py = (float)(p / cam.width);
    const tf::Key pixel_key = tf::fold_in({key0, key1}, (uint32_t)p);

    vec3 acc = {0.0f, 0.0f, 0.0f};
    vec3 o, d, att;
    tf::Key trace_key;
    int s = 0, depth = 0, bounces = 0;
    bool busy = false;
    for (;;) {
        if (!busy) {
            if (s == spp) break;
            const tf::Key k = tf::fold_in(pixel_key, (uint32_t)(sample_offset + s));
            jnp_camera_ray(cam, tf::fold_in(k, 0u), px, py, o, d);
            trace_key = tf::fold_in(k, 1u);
            att = {1.0f, 1.0f, 1.0f};
            depth = 0;
            busy = true;
        }
        float t_best;
        int best;
        jnp_closest_hit(s_sweep, n_spheres, o, d, cam.t_min, t_best, best);
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
    const float inv = (float)spp;
    out[3 * (int64_t)j + 0] = acc.x / inv;
    out[3 * (int64_t)j + 1] = acc.y / inv;
    out[3 * (int64_t)j + 2] = acc.z / inv;
    if (work != nullptr) work[j] = bounces;
}

}  // namespace tfr

// The largest scene a block's sweep table takes beside the static camera
// vector, in the default 48 KB of shared memory.
extern "C" int rt_threefry_max_spheres() {
    return (int)((rt::DEFAULT_BLOCK_SMEM - sizeof(float) * rt::CAM_LEN) / sizeof(float4));
}

extern "C" int rt_threefry_block() { return tfr::BLOCK; }

// Launch the render of `n` pixels on `stream`. table: [n_spheres, 16] f32
// (the transposed packed scene); cam: [CAM_LEN] f32; pix: [n] i32 global
// pixel ids; out: [n, 3] f32; work: [n] i32 sweeps a pixel, or null. All
// device pointers. Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for a scene the table cannot hold.
extern "C" int rt_threefry_render(const void* table, int n_spheres, const void* cam, const void* pix, int n,
                                  unsigned int key0, unsigned int key1, int sample_offset, int spp, int max_depth,
                                  void* out, void* work, void* stream) {
    if (n_spheres <= 0 || n_spheres > rt_threefry_max_spheres()) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    const int blocks = (n + tfr::BLOCK - 1) / tfr::BLOCK;
    tfr::threefry_render_kernel<<<blocks, tfr::BLOCK, rt::sweep_table_bytes(n_spheres), (cudaStream_t)stream>>>(
        (const float4*)table, n_spheres, (const float*)cam, (const int*)pix, n, key0, key1, sample_offset, spp,
        max_depth, (float*)out, (int*)work);
    return (int)cudaGetLastError();
}

// Resident blocks an SM holds for a scene of `n_spheres`, or minus the CUDA
// error.
extern "C" int rt_threefry_blocks_per_sm(int n_spheres) {
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, tfr::threefry_render_kernel, tfr::BLOCK, rt::sweep_table_bytes(n_spheres));
    return err == cudaSuccess ? blocks : -(int)err;
}
