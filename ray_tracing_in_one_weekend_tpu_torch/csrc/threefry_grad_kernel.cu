// The keyed train step's kernels, hand-written for Hopper (sm_90a): a
// forward that records its paths, and the backward that walks them: the
// gradient of the jnp render with respect to the packed scene.
//
// Replace the JAX package's parallel/dist.py::render_grads (jax.grad of the
// jnp path, ops/integrator.py::trace_rays; there is no Pallas kernel) and
// compute what it computes: the image, and the Monte-Carlo-discrete
// gradient of each (pixel, sample) path, its decisions constants, summed
// over the paths. The PCG backward (grad_kernel.cu) cannot serve: it
// recomputes each bounce's draws from the PCG stream, its primal from the
// packed -2c and |c|^2 - r^2 rows for a unit direction, and clips every step
// to +-1e6. Here the draws are threefry uniforms from the trace key, the
// directions are not unit (a = |d|^2), the fused multiply-adds are XLA's,
// and there is no clip and no disc floor: the jnp path has neither.
//
// * threefry_record_kernel: the forward's persistent pixel loop and pixel
//   queue (threefry_device.cuh, trace_pixels<true>). It writes the image and
//   the work map, by the forward's instructions, so with its bits; and one
//   64-byte record a sweep: the pre-bounce o, d, att, the winner (-1 for a
//   miss), the sample's trace key, the bounce index, how the path goes on,
//   and the link to the path's previous record. The records go to an arena
//   in the order they are made: at each sweep the lanes of a warp take
//   consecutive slots by one atomicAdd, so a converged warp writes one run
//   of 2 KB in whole 128-byte lines. Each path (position x spp + sample)
//   leaves its sweeps and its last record's slot in two tables. It
//   replaces the replay, which ran the forward's loop a second time in the
//   backward only to learn its decisions, because its record slots followed
//   the pixel ids and so waited for the forward's per-pixel counts. What
//   bounds it on the H100 is the forward's: the FP32 sweep (threefry_render_
//   kernel.cu's note), 3.16 ms at the bench preset; the records add 64
//   bytes a sweep of stores, 1.75 GB there (0.52 ms at 3.35 TB/s), which
//   overlap the sweep. Under __maxnreg__ 80 it holds 79 registers and 6
//   blocks an SM (72 gives 7 blocks and was 2% slower in
//   probes/sweep_variants.py; PERF.md). The arena is sized from the last
//   exact count at the same shapes (kernels/build.py); a sweep past its end
//   is counted and not written, so the counter ends as the exact count and
//   the wrapper runs the kernel once more at that size.
// * threefry_reverse_kernel: persistent blocks whose threads each walk one
//   path at a time, from its last record to its first along the links,
//   taking the next path from a queue (one atomicAdd a warp): a thread walks
//   at most max_depth records, and no lane waits for a long path of
//   another. A path that ended at the sky takes the sky's adjoint at its
//   last bounce, then keyed_bounce_adjoint at each earlier one; a path that
//   ended dark writes empty events and reads nothing but its last record's
//   end word. The event of bounce d goes to slot L[k] + d of a separate
//   buffer, L the exclusive prefix sum of the paths' sweeps in (pixel id,
//   sample) order (kernels/build.py path_slots), in the PCG event layout
//   (winner, 13 cotangent rows): where the replay used to hold them, so
//   grad_kernel.cu's reduction (grad_reduce_chunks + grad_reduce_partials)
//   sums the same events in the same order. What bounds it is bytes: the
//   records read, the events written, the path tables, about 1.07 ms at
//   the bench preset. The records are random 64-byte reads; what the walk
//   gains on it comes from the lanes of a warp taking consecutive paths
//   together (their events lie side by side: handing a lane 2-8 paths at a
//   time was 7-30% slower), records read by ld.global.nc and events
//   written by st.global.cs (8%), and a taken path's first bounce walked
//   in the same iteration (5%), as measured on an H100 (PERF.md); the load
//   of the previous record goes out before the current bounce's adjoint.
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
// code=sm_90a -O3 -fmad=false, no --use_fast_math): the recording forward
// renders the forward's bits only by computing as it does.
#include <cuda_runtime.h>

#include "threefry_device.cuh"

namespace tfr {

// The recording forward's register cap: the forward's loop plus the record
// stores (probes/sweep_variants.py builds others with
// -DRT_THREEFRY_RECORD_REGS=r).
#ifndef RT_THREEFRY_RECORD_REGS
#define RT_THREEFRY_RECORD_REGS 80
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

// The reverse walk reads each record once by ld.global.nc and writes each
// event once by st.global.cs (evict first): 8% faster than ld.global.cs
// and plain stores (probes/sweep_variants.py, PERF.md).
__device__ __forceinline__ float4 load_word4(const float4* p) { return __ldg(p); }

__device__ __forceinline__ void store_word4(float4* p, float4 v) { __stcs(p, v); }

__device__ __forceinline__ void put_keyed_event(float4* ev, int winner, const KeyedPBar& p) {
    store_word4(ev, make_float4(__int_as_float(winner), p.c.x, p.c.y, p.c.z));
    store_word4(ev + 1, make_float4(p.r, p.albedo.x, p.albedo.y, p.albedo.z));
    store_word4(ev + 2, make_float4(p.fuzz, p.ior, 0.0f, 0.0f));
    store_word4(ev + 3, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
}

// No sphere, no cotangent: all 16 words written (the events buffer starts
// uninitialized).
__device__ __forceinline__ void put_empty_keyed_event(float4* ev) {
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    store_word4(ev, make_float4(__int_as_float(-1), 0.0f, 0.0f, 0.0f));
    store_word4(ev + 1, z);
    store_word4(ev + 2, z);
    store_word4(ev + 3, z);
}

__global__ void __maxnreg__(RT_THREEFRY_RECORD_REGS)
    threefry_record_kernel(const float4* __restrict__ table, int n_spheres, const float* __restrict__ cam_vec,
                           const int* __restrict__ pix, int n, uint32_t key0, uint32_t key1, int sample_offset,
                           int spp, int max_depth, float* __restrict__ out, int* __restrict__ work,
                           int* __restrict__ queue, Arena arena) {
    extern __shared__ float4 s_sweep[];
    __shared__ float s_cam[rt::CAM_LEN];
    load_tables(s_sweep, s_cam, table, n_spheres, cam_vec);
    trace_pixels<true>(table, s_sweep, n_spheres, s_cam, pix, n, key0, key1, sample_offset, spp, max_depth, out,
                       work, queue, arena);
}

__device__ __forceinline__ long long record_link(float4 w3) {
    return (long long)(((unsigned long long)__float_as_uint(w3.w) << 32) | __float_as_uint(w3.z));
}

__device__ __forceinline__ void load_record(const float4* __restrict__ arena, long long at, float4& w0, float4& w1,
                                            float4& w2, float4& w3) {
    const float4* rec = arena + 4 * at;
    w0 = load_word4(rec);
    w1 = load_word4(rec + 1);
    w2 = load_word4(rec + 2);
    w3 = load_word4(rec + 3);
}

__global__ void __launch_bounds__(BLOCK)
    threefry_reverse_kernel(const float4* __restrict__ table, const float* __restrict__ cam_vec,
                            const float* __restrict__ g, int n, int spp, const float4* __restrict__ arena,
                            long long capacity, const long long* __restrict__ path_last,
                            const int* __restrict__ path_count, const long long* __restrict__ slots,
                            float4* __restrict__ events, long long n_events, unsigned long long* __restrict__ queue) {
    const long long paths = (long long)n * spp;
    const long long first_queued = (long long)gridDim.x * blockDim.x;  // the queue's first path
    long long path = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // the thread's first path, then the queue's
    bool taken = false;  // the thread's first path is taken: the next comes from the queue
    const float t_min = cam_vec[20];
    int left = 0;          // events of the path in hand still to write
    long long base = 0;    // its first event slot
    bool lit = false;      // it reached the sky, so its bounces carry adjoints
    float4 w0, w1, w2, w3;  // a lit path's record of bounce left - 1
    vec3 ob, db, ab;        // the adjoints of that bounce's outputs
    for (;;) {
        if (left == 0) {  // take a path: its last bounce now, the rest an iteration each
            if (taken) path = first_queued + queue_take(queue);
            taken = true;
            if (path >= paths) break;
            const long long first = slots[path], last = path_last[path];
            const int count = path_count[path];
            // A pad position (no slots), or a path whose slots lie outside
            // the buffer, is left alone.
            if (first < 0 || count <= 0 || first + count > n_events) continue;
            base = first;
            // A last record or a link outside the arena leaves the path's
            // events to the dark paths' branch below, which writes them empty:
            // no slot stays uninitialized (the wrapper's checks make both
            // unreachable).
            if (last < 0 || last >= capacity) {
                left = count;
                lit = false;
                continue;
            }
            // The last record's end word first: its other words (one 32-byte
            // sector of two) only for a path that reached the sky.
            w3 = load_word4(arena + 4 * last + 3);
            put_empty_keyed_event(events + 4 * (first + count - 1));  // a miss, or no radiance
            left = count - 1;
            lit = __float_as_int(w3.y) == END_SKY;
            if (left == 0) continue;
            if (lit) {
                w0 = load_word4(arena + 4 * last);
                w1 = load_word4(arena + 4 * last + 1);
                w2 = load_word4(arena + 4 * last + 2);
                const long long at = record_link(w3);
                if (at >= 0 && at < capacity) {
                    const int64_t j = path / spp;
                    ob = {0.0f, 0.0f, 0.0f};
                    keyed_sky_adjoint({w0.w, w1.x, w1.y}, {w1.z, w1.w, w2.x},
                                      {g[j], g[n + j], g[2 * (int64_t)n + j]}, db, ab);
                    load_record(arena, at, w0, w1, w2, w3);
                } else {
                    lit = false;
                }
            }
        }
        --left;
        if (!lit) {  // a path that ended dark: no bounce of it carries radiance
            put_empty_keyed_event(events + 4 * (base + left));
            continue;
        }
        // The previous record's load goes out before this bounce's adjoint.
        const long long next = record_link(w3);
        const bool more = left > 0 && next >= 0 && next < capacity;
        float4 n0, n1, n2, n3;
        if (more) load_record(arena, next, n0, n1, n2, n3);
        const int best = __float_as_int(w2.y);
        const tf::Key trace_key = {__float_as_uint(w2.z), __float_as_uint(w2.w)};
        const tf::Key key = tf::fold_in(trace_key, (uint32_t)__float_as_int(w3.x));
        KeyedPBar pb;
        keyed_bounce_adjoint(table + 4 * best, t_min, {w0.x, w0.y, w0.z}, {w0.w, w1.x, w1.y}, {w1.z, w1.w, w2.x},
                             key, ob, db, ab, pb);
        put_keyed_event(events + 4 * (base + left), best, pb);
        if (!more) {  // the path's first bounce; or a broken link, and its earlier events are written empty
            lit = false;
            continue;
        }
        w0 = n0;
        w1 = n1;
        w2 = n2;
        w3 = n3;
    }
}

}  // namespace tfr

// The forward's largest scene (threefry_render_kernel.cu): the recording
// forward's sweep table is the same.
extern "C" int rt_threefry_max_spheres();

// Resident recording blocks an SM holds for a scene of `n_spheres`, or
// minus the CUDA error.
extern "C" int rt_threefry_record_blocks_per_sm(int n_spheres) {
    return tfr::blocks_per_sm(tfr::threefry_record_kernel, rt::sweep_table_bytes(n_spheres));
}

// Launch the recording forward of `n` positions on `stream`. table:
// [n_spheres, 16] f32 (the transposed packed scene); cam: [CAM_LEN] f32;
// pix: [n] i32 global pixel ids; out: [n, 3] f32; work: [n] i32; queue: one
// i32, zero; records: [capacity, 16] f32; total: one u64, zero; path_count
// [n * spp] i32 and path_last [n * spp] i64. All device pointers, the zeros
// on the stream before the launch. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a scene
// the table cannot hold or an `n` whose positions past the grid do not fit
// in int32.
extern "C" int rt_threefry_record(const void* table, int n_spheres, const void* cam, const void* pix, int n,
                                  unsigned int key0, unsigned int key1, int sample_offset, int spp, int max_depth,
                                  void* out, void* work, void* queue, void* records, long long capacity, void* total,
                                  void* path_count, void* path_last, void* stream) {
    if (n_spheres <= 0 || n_spheres > rt_threefry_max_spheres()) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    const int grid = tfr::persistent_grid(tfr::threefry_record_kernel, rt::sweep_table_bytes(n_spheres), n);
    if (grid < 0) return -grid;
    if ((int64_t)n + (int64_t)grid * tfr::BLOCK > INT32_MAX) return (int)cudaErrorInvalidValue;
    const tfr::Arena arena{(float4*)records, capacity, (unsigned long long*)total, (int*)path_count,
                           (long long*)path_last};
    tfr::threefry_record_kernel<<<grid, tfr::BLOCK, rt::sweep_table_bytes(n_spheres), (cudaStream_t)stream>>>(
        (const float4*)table, n_spheres, (const float*)cam, (const int*)pix, n, key0, key1, sample_offset, spp,
        max_depth, (float*)out, (int*)work, (int*)queue, arena);
    return (int)cudaGetLastError();
}

// Launch the reverse walk of the n x spp paths on `stream`: records
// [capacity, 16] f32 and the path tables from the recording forward (no
// slot past `capacity` taken), slots [n * spp] i64 each path's
// first event (-1: none), events [n_events, 16] f32 written; g [3, n] f32,
// each position's radiance cotangent of one sample; queue: one u64, zero on
// the stream before the launch. Returns cudaGetLastError().
extern "C" int rt_threefry_reverse(const void* table, const void* cam, const void* g, int n, int spp,
                                   const void* records, long long capacity, const void* path_last,
                                   const void* path_count, const void* slots, void* events, long long n_events,
                                   void* queue, void* stream) {
    const long long paths = (long long)n * spp;
    if (paths <= 0) return 0;
    const int grid = tfr::persistent_grid(tfr::threefry_reverse_kernel, 0, paths);
    if (grid < 0) return -grid;
    tfr::threefry_reverse_kernel<<<grid, tfr::BLOCK, 0, (cudaStream_t)stream>>>(
        (const float4*)table, (const float*)cam, (const float*)g, n, spp, (const float4*)records, capacity,
        (const long long*)path_last, (const int*)path_count, (const long long*)slots, (float4*)events, n_events,
        (unsigned long long*)queue);
    return (int)cudaGetLastError();
}
