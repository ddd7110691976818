// Backward kernels of the keyed (threefry) path, hand-written for Hopper
// (sm_90a): the gradient of the jnp render with respect to the packed scene.
//
// Replace the JAX package's parallel/dist.py::render_grads (jax.grad of the
// jnp path, ops/integrator.py::trace_rays; there is no Pallas kernel) and
// compute what it computes: the Monte-Carlo-discrete gradient of each
// (pixel, sample) path, its decisions constants, summed over the paths.
// The PCG backward (grad_kernel.cu) cannot serve: it recomputes each
// bounce's draws from the PCG stream, its primal from the packed -2c and
// |c|^2 - r^2 rows for a unit direction, and clips every step to +-1e6.
// Here the draws are threefry uniforms from the trace key, the directions
// are not unit (a = |d|^2), the fused multiply-adds are XLA's, and there is
// no clip and no disc floor: the jnp path has neither. Two kernels:
//
// * threefry_replay_kernel: the forward's persistent pixel loop
//   (threefry_device.cuh, trace_pixels<true>), one 64-byte record a sweep:
//   the pre-bounce o, d, att, the winner (-1 for a miss), the sample's trace
//   key, the bounce index and how the path goes on. The forward and the
//   replay take their decisions by the same instructions, so the records
//   are the forward's paths. A pixel's slots start at the exclusive prefix
//   sum, in pixel-id order, of the forward's per-pixel sweeps
//   (kernels/build.py event_slots), so they do not depend on the order in
//   which the queue hands pixels out. A pixel that would run past its range
//   or end short of it raises a flag, and the wrapper refuses the records.
// * threefry_reverse_kernel: one thread a position walks its records from
//   the last to the first. At each path's last bounce the adjoints start
//   from zero, from the sky's adjoint if the path reached the sky; each
//   earlier bounce of such a path takes keyed_bounce_adjoint. Every record
//   is overwritten in place with its bounce's event, the PCG event layout
//   (winner, 13 cotangent rows), so grad_kernel.cu's reduction
//   (grad_reduce_chunks + grad_reduce_partials) turns the events into the
//   [16, N] cotangent in a fixed order.
//
// keyed_bounce_adjoint is the vector-Jacobian product of the plain keyed
// bounce (ops/cuda_threefry.py _keyed_bounce: intersect._winner_t, the hit
// point and the outward normal (p - c) / r, materials.scatter_sampled and
// the attenuation), whose torch.autograd the plain reverse takes. Its primal
// is recomputed with the forward's device functions on the record's o and
// d, so the root, front face and must_reflect are the forward's; the draws
// come again from fold_in(trace key, bounce) and are constants. Kinks follow
// torch: a clamp passes the gradient at equality, the double-where square
// roots none where they guard. The cotangent reaches rows 0-3 (center,
// radius) and 5-9 (albedo, fuzz, ior) of the winner: the keyed sweep takes
// |c|^2 - r^2 from center and radius, not from rows 12-15.
//
// Build with the forward kernel's flags (nvcc -gencode arch=compute_90a,
// code=sm_90a -O3 -fmad=false, no --use_fast_math): the replay knows the
// forward's decisions only by recomputing them.
#include <cuda_runtime.h>

#include "threefry_device.cuh"

namespace tfr {

// The replay's register cap: the forward's loop plus the record stores.
#ifndef RT_THREEFRY_REPLAY_REGS
#define RT_THREEFRY_REPLAY_REGS 80
#endif

// The cotangent of a sphere's parameters that a keyed bounce makes.
struct KeyedPBar {
    vec3 c;       // center (rows 0-2)
    float r;      // radius (row 3)
    vec3 albedo;  // rows 5-7
    float fuzz;   // row 8
    float ior;    // row 9
};

using rt::dot3;  // a.x b.x + a.y b.y + a.z b.z, for the adjoints' unfused dots

// d_bar and n_bar of reflect(v, n) = v - 2 (v.n) n for the cotangent rb.
__device__ __forceinline__ void reflect_adjoint(vec3 v, vec3 n, vec3 rb, vec3& v_bar, vec3& n_bar) {
    const float vn = jnp_dot_fma(v, n);
    const float rb_n = dot3(rb, n);
    v_bar = v_bar + rb - (2.0f * rb_n) * n;
    n_bar = n_bar - (2.0f * vn) * rb - (2.0f * rb_n) * v;
}

// unit = v * (1 / sqrt(|v|^2)), zero for a zero vector: adds to v_bar the
// cotangent of v for the cotangent u_bar of unit.
__device__ __forceinline__ void unit_vector_adjoint(vec3 v, vec3 u_bar, vec3& v_bar) {
    const float sq = jnp_dot_fma(v, v);
    if (!(sq > 0.0f)) return;
    const float y = sqrtf(sq);
    const float scale = 1.0f / y;
    const float scale_bar = dot3(u_bar, v);
    const float sq_bar = (-scale_bar / (y * y)) * (0.5f / y);
    v_bar = v_bar + scale * u_bar + (2.0f * sq_bar) * v;
}

// The path's last bounce, a miss: radiance att * sky(d). Given the radiance
// cotangent g, sets the adjoints of d and att.
__device__ __forceinline__ void keyed_sky_adjoint(vec3 d, vec3 att, vec3 g, vec3& db, vec3& ab) {
    ab = g * jnp_sky(d);
    const vec3 q = g * att;
    // sky = a * blue + (1 - a), a = 0.5 (unit(d).y + 1).
    const float a_bar = q.x * (0.5f - 1.0f) + q.y * (0.7f - 1.0f) + q.z * (1.0f - 1.0f);
    db = {0.0f, 0.0f, 0.0f};
    unit_vector_adjoint(d, {0.0f, 0.5f * a_bar, 0.0f}, db);
}

// A bounce that continues off sphere `row` (its table row): o' = p, d' = the
// scatter direction, att' = att * the material's attenuation. On entry ob,
// db, ab are the cotangents of o', d', att'; on exit those of o, d, att, and
// pb holds the sphere's parameter cotangent.
__device__ __forceinline__ void keyed_bounce_adjoint(const float4* row, float t_min, vec3 o, vec3 d, vec3 att,
                                                     tf::Key k, vec3& ob, vec3& db, vec3& ab, KeyedPBar& pb) {
    // ---- primal, as the forward computes it ----
    const float4 c4 = row[0];  // cx, cy, cz, r
    const float4 r1 = row[1];  // r^2, albedo rgb
    const float4 r2 = row[2];  // fuzz, ior, mat, active
    const vec3 c = {c4.x, c4.y, c4.z};
    const float r = c4.w;
    const float4 entry = sweep_entry(c4, true);
    const float a = jnp_dot_fma(d, d);
    const float o_dot_d = jnp_dot_fma(o, d);
    const float o_sq = jnp_dot_fma(o, o);
    const float inv_a = 1.0f / a;
    float half_b;
    const float disc = jnp_disc(entry, -2.0f * o, d, a, o_dot_d, o_sq, half_b);
    const float cc = (o_sq + (-2.0f * jnp_dot_fma(o, c))) + entry.w;  // as jnp_disc takes it
    const float sqrt_d = sqrtf(disc);
    const float x_near = -half_b - sqrt_d;
    const float root_near = x_near * inv_a;
    const bool near = root_near > t_min && root_near < T_MAX;
    const float x = near ? x_near : -half_b + sqrt_d;
    const float t = near ? root_near : x * inv_a;
    const vec3 point = jnp_fma3(t, d, o);
    const vec3 pc = {point.x - c.x, point.y - c.y, point.z - c.z};
    const vec3 outward = {pc.x / r, pc.y / r, pc.z / r};
    const bool front_face = jnp_dot_fma(d, outward) < 0.0f;
    const vec3 n = front_face ? outward : -outward;
    const vec3 unit_in = jnp_unit_vector(d);
    const float mat = r2.z;

    // ---- adjoint of the scatter ----
    pb = KeyedPBar{};
    vec3 n_bar = {0.0f, 0.0f, 0.0f}, ui_bar = {0.0f, 0.0f, 0.0f};
    if (mat < 1.5f) {
        // att' = att * albedo.
        pb.albedo = ab * att;
        ab = ab * vec3{r1.y, r1.z, r1.w};
        if (mat < 0.5f) {
            n_bar = db;  // lambertian: n + u, or n where that is near zero
        } else {
            pb.fuzz = dot3(db, jnp_unit_sample(k));  // metal: reflect(unit_in, n) + fuzz u
            reflect_adjoint(unit_in, n, db, ui_bar, n_bar);
        }
    } else {
        // The forward's decision: reflect or refract.
        const float reflect_u = tf::uniform(k, 4u);
        const float ior = r2.y;
        const float ratio = front_face ? 1.0f / ior : ior;
        const float cos_in = jnp_dot_fma(-unit_in, n);
        const float cos_theta = fminf(cos_in, 1.0f);
        const float sin_theta = sqrtf(fmaxf(__fmaf_rn(-cos_theta, cos_theta, 1.0f), 1e-12f));
        float r0 = (1.0f - ratio) / (1.0f + ratio);
        r0 = r0 * r0;
        const float xc = 1.0f - cos_theta;
        const float xc2 = xc * xc;
        const float schlick = __fmaf_rn(1.0f - r0, xc * (xc2 * xc2), r0);
        if (ratio * sin_theta > 1.0f || schlick > reflect_u) {
            reflect_adjoint(unit_in, n, db, ui_bar, n_bar);
        } else {
            // dir = perp - sqrt_k n, perp = ratio w, w = cos_theta n + unit_in,
            // sqrt_k = sqrt(1 - |perp|^2) where that is > 0, else 0.
            const vec3 w = jnp_fma3(cos_theta, n, unit_in);
            const vec3 perp = ratio * w;
            const float k2 = 1.0f - jnp_dot_fma(perp, perp);
            const float sqrt_k = k2 > 0.0f ? sqrtf(k2) : 0.0f;
            vec3 perp_bar = db;
            n_bar = n_bar - sqrt_k * db;
            if (k2 > 0.0f) {
                const float k_bar = -dot3(db, n) * (0.5f / sqrt_k);
                perp_bar = perp_bar - (2.0f * k_bar) * perp;
            }
            const float ratio_bar = dot3(perp_bar, w);
            const vec3 w_bar = ratio * perp_bar;
            ui_bar = ui_bar + w_bar;
            n_bar = n_bar + cos_theta * w_bar;
            if (cos_in <= 1.0f) {
                const float cos_bar = dot3(w_bar, n);
                ui_bar = ui_bar - cos_bar * n;
                n_bar = n_bar - cos_bar * unit_in;
            }
            pb.ior = front_face ? -ratio_bar * (ratio * ratio) : ratio_bar;
        }
    }
    vec3 d_bar = {0.0f, 0.0f, 0.0f};
    unit_vector_adjoint(d, ui_bar, d_bar);

    // ---- the normal: n = +-(p - c) / r ----
    const vec3 out_bar = front_face ? n_bar : -n_bar;
    const vec3 p_bar = {ob.x + out_bar.x / r, ob.y + out_bar.y / r, ob.z + out_bar.z / r};
    vec3 c_bar = {-out_bar.x / r, -out_bar.y / r, -out_bar.z / r};
    float r_bar = -dot3(out_bar, pc) / (r * r);

    // ---- the hit point: p = o + t d ----
    vec3 o_bar = p_bar;
    d_bar = d_bar + t * p_bar;
    const float t_bar = dot3(p_bar, d);

    // ---- the root: t = (-half_b -+ sqrt(disc)) / a ----
    const float hb_bar0 = -t_bar * inv_a;
    const float sd_bar = near ? -t_bar * inv_a : t_bar * inv_a;
    const float inv_a_bar = t_bar * x;
    float a_bar = -inv_a_bar / (a * a);
    const float disc_bar = sd_bar * (0.5f / sqrt_d);
    const float hb_bar = hb_bar0 + 2.0f * half_b * disc_bar;
    a_bar = a_bar - cc * disc_bar;
    const float cc_bar = -a * disc_bar;
    // half_b = o.d - d.c; cc = |o|^2 - 2 o.c + |c|^2 - r^2; a = |d|^2.
    o_bar = o_bar + hb_bar * d + (2.0f * cc_bar) * o - (2.0f * cc_bar) * c;
    d_bar = d_bar + hb_bar * o - hb_bar * c + (2.0f * a_bar) * d;
    c_bar = c_bar - hb_bar * d - (2.0f * cc_bar) * o + (2.0f * cc_bar) * c;
    r_bar = r_bar - 2.0f * r * cc_bar;

    pb.c = c_bar;
    pb.r = r_bar;
    ob = o_bar;
    db = d_bar;
}

__device__ __forceinline__ void put_keyed_event(float4* ev, int winner, const KeyedPBar& p) {
    ev[0] = make_float4(__int_as_float(winner), p.c.x, p.c.y, p.c.z);
    ev[1] = make_float4(p.r, p.albedo.x, p.albedo.y, p.albedo.z);
    ev[2] = make_float4(p.fuzz, p.ior, 0.0f, 0.0f);
    ev[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// No sphere, no cotangent: all 16 words written, so none of the record stays.
__device__ __forceinline__ void put_empty_keyed_event(float4* ev) {
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    ev[0] = make_float4(__int_as_float(-1), 0.0f, 0.0f, 0.0f);
    ev[1] = z;
    ev[2] = z;
    ev[3] = z;
}

__global__ void __maxnreg__(RT_THREEFRY_REPLAY_REGS)
    threefry_replay_kernel(const float4* __restrict__ table, int n_spheres, const float* __restrict__ cam_vec,
                           const int* __restrict__ pix, int n, uint32_t key0, uint32_t key1, int sample_offset,
                           int spp, int max_depth, const long long* __restrict__ ev_start,
                           const int* __restrict__ ev_count, float4* __restrict__ records, int* __restrict__ flags,
                           int* __restrict__ queue) {
    extern __shared__ float4 s_sweep[];
    __shared__ float s_cam[rt::CAM_LEN];
    load_tables(s_sweep, s_cam, table, n_spheres, cam_vec);
    trace_pixels<true>(table, s_sweep, n_spheres, s_cam, pix, n, key0, key1, sample_offset, spp, max_depth, nullptr,
                       nullptr, queue, Slots{ev_start, ev_count, records, flags});
}

__global__ void __launch_bounds__(BLOCK)
    threefry_reverse_kernel(const float4* __restrict__ table, const float* __restrict__ cam_vec,
                            const float* __restrict__ g, const long long* __restrict__ ev_start,
                            const int* __restrict__ ev_count, float4* __restrict__ records, long long n_records,
                            int n) {
    const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n) return;
    const long long first = ev_start[j];
    // A slot range outside the records (not one the replay gave) is left alone.
    if (first < 0 || first + ev_count[j] > n_records) return;
    const float t_min = cam_vec[20];
    const vec3 gl = {g[j], g[n + j], g[2 * (int64_t)n + j]};
    // Whether the path being walked carries radiance, and its adjoints.
    bool live = false;
    vec3 ob = {0.0f, 0.0f, 0.0f}, db = ob, ab = ob;
    for (long long i = first + ev_count[j] - 1; i >= first; --i) {
        float4* rec = records + 4 * i;
        const float4 w0 = rec[0], w1 = rec[1], w2 = rec[2], w3 = rec[3];
        const vec3 d = {w0.w, w1.x, w1.y};
        const vec3 att = {w1.z, w1.w, w2.x};
        const int end = __float_as_int(w3.y);
        if (end != END_NONE) {
            // A path's last bounce: its adjoints start here. Only a path that
            // reached the sky carries radiance; the bounce itself has no
            // sphere (a miss) or no radiance.
            live = end == END_SKY;
            if (live) {
                ob = {0.0f, 0.0f, 0.0f};
                keyed_sky_adjoint(d, att, gl, db, ab);
            }
            put_empty_keyed_event(rec);
        } else if (!live) {
            put_empty_keyed_event(rec);
        } else {
            const int best = __float_as_int(w2.y);
            const tf::Key trace_key = {__float_as_uint(w2.z), __float_as_uint(w2.w)};
            const tf::Key k = tf::fold_in(trace_key, (uint32_t)__float_as_int(w3.x));
            KeyedPBar pb;
            keyed_bounce_adjoint(table + 4 * best, t_min, {w0.x, w0.y, w0.z}, d, att, k, ob, db, ab, pb);
            put_keyed_event(rec, best, pb);
        }
    }
}

}  // namespace tfr

// The forward's largest scene (threefry_render_kernel.cu): the replay's
// sweep table is the same.
extern "C" int rt_threefry_max_spheres();

// Resident replay blocks an SM holds for a scene of `n_spheres`, or minus
// the CUDA error.
extern "C" int rt_threefry_replay_blocks_per_sm(int n_spheres) {
    return tfr::blocks_per_sm(tfr::threefry_replay_kernel, n_spheres);
}

// Launch the replay of `n` positions on `stream`. table: [n_spheres, 16] f32
// (the transposed packed scene); cam: [CAM_LEN] f32; pix: [n] i32 global
// pixel ids; ev_start [n] i64 and ev_count [n] i32: each position's record
// slots; records: [sum(ev_count), 16] f32; flags: two i32, zero; queue: one
// i32, zero. All device pointers, the zeros on the stream before the launch.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a scene the table cannot hold or an `n` whose positions past the grid do
// not fit in int32.
extern "C" int rt_threefry_replay(const void* table, int n_spheres, const void* cam, const void* pix, int n,
                                  unsigned int key0, unsigned int key1, int sample_offset, int spp, int max_depth,
                                  const void* ev_start, const void* ev_count, void* records, void* flags,
                                  void* queue, void* stream) {
    if (n_spheres <= 0 || n_spheres > rt_threefry_max_spheres()) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    const int grid = tfr::persistent_grid(tfr::threefry_replay_kernel, n_spheres, n);
    if (grid < 0) return -grid;
    if ((int64_t)n + (int64_t)grid * tfr::BLOCK > INT32_MAX) return (int)cudaErrorInvalidValue;
    tfr::threefry_replay_kernel<<<grid, tfr::BLOCK, rt::sweep_table_bytes(n_spheres), (cudaStream_t)stream>>>(
        (const float4*)table, n_spheres, (const float*)cam, (const int*)pix, n, key0, key1, sample_offset, spp,
        max_depth, (const long long*)ev_start, (const int*)ev_count, (float4*)records, (int*)flags, (int*)queue);
    return (int)cudaGetLastError();
}

// Launch the reverse walk on `stream`: records [n_records, 16] f32 from the
// replay, with the same ev_start and ev_count, are overwritten by events; g
// [3, n] f32, each position's radiance cotangent of one sample. Returns
// cudaGetLastError().
extern "C" int rt_threefry_reverse(const void* table, const void* cam, const void* g, const void* ev_start,
                                   const void* ev_count, void* records, long long n_records, int n, void* stream) {
    if (n <= 0) return 0;
    tfr::threefry_reverse_kernel<<<(n + tfr::BLOCK - 1) / tfr::BLOCK, tfr::BLOCK, 0, (cudaStream_t)stream>>>(
        (const float4*)table, (const float*)cam, (const float*)g, (const long long*)ev_start, (const int*)ev_count,
        (float4*)records, n_records, n);
    return (int)cudaGetLastError();
}
