// Device functions of the forward render kernel (render_kernel.cu).
//
// They live in a header so that a later backward kernel can replay each
// (pixel, sample) path with the very same code: the same float values and
// the same discrete decisions as the forward render. Each function is the
// counterpart of the plain PyTorch function of the same name in
// ops/cuda_render.py, and spells out its operation order.
//
// Build without --use_fast_math: the sweep relies on IEEE compares, and
// sqrtf, sinf, cosf and the divisions stay at full precision. Build with
// -fmad=false: without contraction each operation rounds as the plain
// version's does, so both take the same discrete decisions on every path.
#pragma once

#include <cstdint>

namespace rt {

// Packed scene table, [N, 16] float32: row i is sphere i (the transpose of
// ops/cuda_render.py pack_scene). As float4s: [4i] = (cx, cy, cz, r),
// [4i+1] = (r^2, albedo rgb), [4i+2] = (fuzz, ior, mat, active),
// [4i+3] = (-2cx, -2cy, -2cz, |c|^2 - r^2).
constexpr int P_ROWS = 16;
// Lane state rows (row r, lane j at r * P + j).
constexpr int SF_O = 0, SF_D = 3, SF_ATT = 6, SF_RAD = 9, SF_ITERS = 12, SF_WORK = 13, SF_ROWS = 16;
constexpr int SI_PIX = 0, SI_STARTED = 1, SI_STREAM = 2, SI_DEPTH = 3, SI_BUSY = 4, SI_STREAM2 = 5,
              SI_ROWS = 8;
constexpr int CAM_LEN = 24;
constexpr float T_MISS = 1e30f;
constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr uint32_t GOLDEN2 = 0x85EBCA6Bu;
constexpr float TWO_PI = 6.283185307179586f;  // float32(2 pi), as the plain version rounds it

struct vec3 {
    float x, y, z;
};
__device__ __forceinline__ vec3 operator+(vec3 a, vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ vec3 operator-(vec3 a, vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ vec3 operator-(vec3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ vec3 operator*(vec3 a, vec3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ vec3 operator*(float s, vec3 v) { return {s * v.x, s * v.y, s * v.z}; }
__device__ __forceinline__ vec3 operator*(vec3 v, float s) { return {v.x * s, v.y * s, v.z * s}; }

__device__ __forceinline__ float dot3(vec3 a, vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ vec3 normalize3(vec3 v) { return v * rsqrtf(fmaxf(dot3(v, v), 1e-20f)); }

// ---------------------------------------------------------------------------
// Counter-based PCG streams: pure uint32 arithmetic, bit-equal to the plain
// version and to the JAX kernel.
// ---------------------------------------------------------------------------

struct Stream {
    uint32_t lo, hi;
};

__device__ __forceinline__ uint32_t pcg(uint32_t x) {
    const uint32_t state = x * 747796405u + 2891336453u;
    const uint32_t word = ((state >> ((state >> 28u) + 4u)) ^ state) * 277803737u;
    return (word >> 22u) ^ word;
}

// uint32 -> (0, 1) with a 24-bit mantissa. The _rn intrinsics keep nvcc from
// contracting the two steps into an FMA, so the value is bit-exact.
__device__ __forceinline__ float to_unit_float(uint32_t bits) {
    return __fadd_rn(__fmul_rn((float)(bits >> 8), 1.0f / 16777216.0f), 0.5f / 16777216.0f);
}

__device__ __forceinline__ float u01(Stream s, uint32_t counter) {
    return to_unit_float(pcg(pcg(s.lo ^ (counter * GOLDEN)) + s.hi));
}

// Uniform direction on S^2 by the cylinder map: z ~ U(-1,1), phi ~ U(0,2pi).
__device__ __forceinline__ vec3 unit_vectors(Stream s, uint32_t counter) {
    const float z = 2.0f * u01(s, counter) - 1.0f;
    const float phi = TWO_PI * u01(s, counter + 1u);
    const float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
    return {r * cosf(phi), r * sinf(phi), z};
}

// ---------------------------------------------------------------------------
// Camera.
// ---------------------------------------------------------------------------

struct Cam {
    vec3 center, pixel00, delta_u, delta_v, disk_u, disk_v;
    bool defocus;
    int width;
    float t_min;
};

__device__ __forceinline__ Cam unpack_cam(const float* c) {
    Cam cam;
    cam.center = {c[0], c[1], c[2]};
    cam.pixel00 = {c[3], c[4], c[5]};
    cam.delta_u = {c[6], c[7], c[8]};
    cam.delta_v = {c[9], c[10], c[11]};
    cam.disk_u = {c[12], c[13], c[14]};
    cam.disk_v = {c[15], c[16], c[17]};
    cam.defocus = c[18] > 0.0f;
    cam.width = (int)c[19];
    cam.t_min = c[20];
    return cam;
}

// Camera ray and 64-bit stream for the GLOBAL sample index s: both stream
// words mix the global pixel hash h0 with s, so streams do not depend on
// the pass or lane layout (reference: src/gpu/camera.h:140-167).
__device__ __forceinline__ void camera_ray(const Cam& cam, uint32_t h0, float px, float py, uint32_t s,
                                           vec3& o, vec3& d, Stream& st) {
    st.lo = pcg(h0 ^ (s * GOLDEN));
    st.hi = pcg((h0 + s) * GOLDEN2);
    const float jx = u01(st, 0u) - 0.5f;
    const float jy = u01(st, 1u) - 0.5f;
    const vec3 sample_pos = cam.pixel00 + (px + jx) * cam.delta_u + (py + jy) * cam.delta_v;
    if (cam.defocus) {
        const float disk_r = sqrtf(u01(st, 2u));
        const float disk_t = TWO_PI * u01(st, 3u);
        o = cam.center + (disk_r * cosf(disk_t)) * cam.disk_u + (disk_r * sinf(disk_t)) * cam.disk_v;
    } else {
        o = cam.center;
    }
    d = normalize3(sample_pos - o);
}

// ---------------------------------------------------------------------------
// Closest hit: the nearest root beyond t_min over every sphere, `d` unit.
//
// The sweep reads its own table, one float4 a sphere, (cx, cy, cz,
// |c|^2 - r^2), which each block builds in shared memory from rows 4i and
// 4i+3 of the packed table (load_sweep_table): one 16-byte load a sphere
// test, 8 KB at 512 slots. The -2c row is not read: the ray's o2 = -2o is
// taken once, and c.x * o2.x equals (-2 c.x) * o.x bit for bit (scaling by
// -2 is exact short of overflow, and the two products have the same real
// value and sign), so cc_part, and every t, keep the plain version's bits.
// This needs rows 12-14 to hold -2 times rows 0-2, as pack_scene makes them.
//
// Spheres are tested SWEEP_GROUP (8) at a time: the group's discriminants
// are independent, so their loads and arithmetic overlap, and the roots are
// taken only when one of them is >= 0. The group's (t_best, best) updates
// then run in index order with the strict <, so the result is that of one
// sphere after another: on an exact tie the lowest index wins. Slots past
// the last whole group go one by one. A trip of 8 tests issues 141 SASS
// instructions (17.6 a test: the 15 FP32 operations, the load and the
// group's share of its sign test, branch and pointer step), against 23.25
// a test when each test loaded two float4s and branched alone; groups of 4
// issue 18.75 and ran 8-9% slower on an H100 (probes/sweep_variants.py,
// PERF.md).
// ---------------------------------------------------------------------------

#ifndef RT_SWEEP_GROUP
#define RT_SWEEP_GROUP 8
#endif
constexpr int SWEEP_GROUP = RT_SWEEP_GROUP;

// Register cap of the three kernels that sweep (render, replay, sweep
// probe): at 64, eight blocks of 128 threads (32 warps) share an SM. The
// render and replay kernels spill a few words outside the sweep loop at 64
// and still ran faster on an H100 than at 72 or 80 (probes/sweep_variants.py
// builds other caps with -DRT_SWEEP_REGS=N; PERF.md has the times).
#ifndef RT_SWEEP_REGS
#define RT_SWEEP_REGS 64
#endif
#define SWEEP_KERNEL __global__ void __maxnreg__(RT_SWEEP_REGS)

// A block gets 48 KB of shared memory without an opt-in; the sweep table
// takes one float4 a sphere of what its kernel's static arrays leave.
constexpr size_t DEFAULT_BLOCK_SMEM = 48 * 1024;
__host__ __device__ constexpr size_t sweep_table_bytes(int n) { return (size_t)n * sizeof(float4); }

// The block's sweep table from the packed table; the caller syncs.
__device__ __forceinline__ void load_sweep_table(float4* s_sweep, const float4* __restrict__ table, int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float4 c = table[4 * i];
        s_sweep[i] = make_float4(c.x, c.y, c.z, table[4 * i + 3].w);
    }
}

// The quadratic of one sphere test: returns disc, sets half_b.
__device__ __forceinline__ float sphere_disc(float4 c, vec3 o2, vec3 d, float o_dot_d, float o_sq,
                                             float& half_b) {
    const float d_dot_c = c.x * d.x + c.y * d.y + c.z * d.z;
    const float cc_part = c.w + c.x * o2.x + c.y * o2.y + c.z * o2.z;
    half_b = o_dot_d - d_dot_c;
    const float cc = o_sq + cc_part;
    return half_b * half_b - cc;
}

// NaN-as-miss: sqrtf of a negative disc is NaN, and every compare with NaN
// is false, so such a pair falls through to T_MISS in the plain version.
// Skipping !(disc >= 0) here gives the identical t. Padding slots have
// r^2 = -1, so disc <= -1 for them.
__device__ __forceinline__ void take_root(float half_b, float disc, int i, float t_min, float& t_best,
                                          int& best) {
    if (disc >= 0.0f) {
        const float sqrt_d = sqrtf(disc);
        const float root_near = -half_b - sqrt_d;
        const float t = root_near > t_min ? root_near : -half_b + sqrt_d;
        if (t > t_min && t < t_best) {
            t_best = t;
            best = i;
        }
    }
}

__device__ __forceinline__ void closest_hit(const float4* sweep, int n, vec3 o, vec3 d, float t_min,
                                            float& t_best, int& best) {
    const float o_dot_d = dot3(o, d);
    const float o_sq = dot3(o, o);
    const vec3 o2 = -2.0f * o;
    t_best = T_MISS;
    best = 0;
    // One pointer step a group: a sphere's index is needed only for a root.
    const float4* c = sweep;
    for (const float4* end = sweep + (n - n % SWEEP_GROUP); c != end; c += SWEEP_GROUP) {
        float half_b[SWEEP_GROUP], disc[SWEEP_GROUP];
        int signs = -1;
#pragma unroll
        for (int k = 0; k < SWEEP_GROUP; ++k) {
            disc[k] = sphere_disc(c[k], o2, d, o_dot_d, o_sq, half_b[k]);
            signs &= __float_as_int(disc[k]);
        }
        // Every sign bit set: each disc is < 0 or a NaN, none a root (disc
        // is never -0: half_b^2 is +0 or more, and +0 - cc is not -0).
        if (signs >= 0) {
            const int i = (int)(c - sweep);
#pragma unroll
            for (int k = 0; k < SWEEP_GROUP; ++k) take_root(half_b[k], disc[k], i + k, t_min, t_best, best);
        }
    }
    for (const float4* end = sweep + n; c != end; ++c) {
        float half_b;
        const float disc = sphere_disc(*c, o2, d, o_dot_d, o_sq, half_b);
        take_root(half_b, disc, (int)(c - sweep), t_min, t_best, best);
    }
}

// ---------------------------------------------------------------------------
// Scatter (reference: src/gpu/material.h). `row` is the hit sphere's row of
// the packed table in device memory; `d` is unit and so is the returned
// direction. Returns false when a metal ray scatters below the surface (the
// path is absorbed).
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool scatter(vec3 d, vec3 n, bool front_face, const float4* row, Stream st,
                                        uint32_t ctr, vec3& new_dir, vec3& atten) {
    const float4 r1 = __ldg(row + 1);  // r^2, albedo rgb
    const float4 r2 = __ldg(row + 2);  // fuzz, ior, mat, active
    const float mat = r2.z;
    const bool is_lam = mat < 0.5f;
    const bool is_metal = mat >= 0.5f && mat < 1.5f;
    vec3 dir;
    bool ok = true;
    if (is_lam || is_metal) {
        const vec3 unit_sample = unit_vectors(st, ctr);
        if (is_lam) {
            dir = n + unit_sample;
            if (dot3(dir, dir) < 1e-16f) dir = n;
        } else {
            const vec3 reflected = d - (2.0f * dot3(d, n)) * n;
            dir = reflected + r2.x * unit_sample;
            ok = dot3(dir, n) > 0.0f;
        }
        atten = {r1.y, r1.z, r1.w};
    } else {
        const float reflect_u = u01(st, ctr + 4u);
        const float ior = r2.y;
        const float ratio = front_face ? 1.0f / ior : ior;
        const float cos_theta = fminf(dot3(-d, n), 1.0f);
        const float s2 = fmaxf(1.0f - cos_theta * cos_theta, 0.0f);
        const float sin_theta = s2 > 0.0f ? sqrtf(s2) : 0.0f;
        const bool cannot_refract = ratio * sin_theta > 1.0f;
        float r0 = (1.0f - ratio) / (1.0f + ratio);
        r0 = r0 * r0;
        const float one_m_cos = 1.0f - cos_theta;
        const float omc2 = one_m_cos * one_m_cos;
        const float schlick = r0 + (1.0f - r0) * (one_m_cos * (omc2 * omc2));
        if (cannot_refract || schlick > reflect_u) {
            dir = d - (2.0f * dot3(d, n)) * n;
        } else {
            const vec3 r_perp = ratio * (d + cos_theta * n);
            const float k = fmaxf(1.0f - dot3(r_perp, r_perp), 0.0f);
            dir = r_perp + (-(k > 0.0f ? sqrtf(k) : 0.0f)) * n;
        }
        atten = {1.0f, 1.0f, 1.0f};
    }
    new_dir = normalize3(dir);
    return ok;
}

// ---------------------------------------------------------------------------
// One bounce of a busy lane: closest hit over the block's sweep table, sky
// on a miss, signed-radius normal, scatter with the winner's row of the
// packed table (device memory, one read a bounce). Updates the lane's ray,
// attenuation, radiance and depth; returns whether the path continues.
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool bounce(const float4* sweep, const float4* __restrict__ table, int n_spheres,
                                       float t_min, int max_depth, vec3& o, vec3& d, vec3& att, vec3& rad,
                                       int& depth, Stream st) {
    float t_best;
    int best;
    closest_hit(sweep, n_spheres, o, d, t_min, t_best, best);
    const uint32_t ctr = 8u + (uint32_t)depth * 16u;
    depth += 1;
    if (!(t_best < T_MISS * 0.5f)) {
        // miss -> sky, retire (reference: src/gpu/camera.h:118-124)
        const float a = 0.5f * (d.y + 1.0f);
        const vec3 sky = {(1.0f - a) + a * 0.5f, (1.0f - a) + a * 0.7f, (1.0f - a) + a * 1.0f};
        rad = rad + att * sky;
        return false;
    }
    const float4* row = table + 4 * best;
    const float4 c = __ldg(row);
    const vec3 p = o + t_best * d;
    // The SIGNED radius divides the normal (reference: src/gpu/sphere.h:40-42).
    const float inv_r = 1.0f / (fabsf(c.w) > 1e-8f ? c.w : 1.0f);
    const vec3 outward = (p - vec3{c.x, c.y, c.z}) * inv_r;
    const bool front_face = dot3(d, outward) < 0.0f;
    const vec3 n = front_face ? outward : -outward;
    vec3 new_dir, mat_atten;
    const bool ok = scatter(d, n, front_face, row, st, ctr, new_dir, mat_atten);
    const bool cont = ok && depth < max_depth;
    if (cont) {
        att = att * mat_atten;
        o = p;
        d = new_dir;
    }
    return cont;
}

}  // namespace rt
