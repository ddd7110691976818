// Backward render kernel: the gradient of the rendered image with respect to
// the packed scene, by replaying each path and walking it in reverse.
// Hand-written for Hopper (sm_90a).
//
// Replaces ray_tracing_in_one_weekend_tpu/ops/pallas_grad.py::_bwd_kernel,
// the Pallas TPU kernel, and computes what it computes: for every (pixel,
// sample) path it replays the forward bounces with the forward kernel's own
// device functions (render_device.cuh), then pulls the radiance cotangent
// back through each bounce in reverse (grad_device.cuh, the hand-written
// adjoint of the JAX kernel's `F`), clipping every adjoint and parameter
// cotangent to +-1e6 per step, and adds each bounce's cotangent into the
// winning sphere's column of a [16, N] result. Adjoints start at zero for
// every sample, as the JAX kernel's reset at a regen boundary does.
//
// Layout on this card: one thread per lane (a lane is a pixel, given as data,
// so the caller may sort lanes by cost), `tile` lanes per block, the scene
// table in shared memory as in the forward kernel. A lane runs its samples
// one after another, and each sample is replayed and then reversed before the
// next starts. Two TPU-isms are gone:
//
// * the VMEM trajectory slab per persistent-loop iteration (at the bench
//   preset 64 KB per lane). A sample's trajectory (pre-bounce o, d, att and
//   the winner, 10 words per bounce) goes to a device-memory scratch of
//   max_depth entries per lane, laid out [bounce][row][lane] so that a
//   warp's accesses coalesce;
// * the one-hot MXU matmul that scattered the cotangents. Float atomics
//   would make the gradient depend on timing, so each bounce writes one
//   64-byte event record (winner, 13 cotangent rows) into a slot of its
//   own: a lane's events start at the exclusive prefix sum of the forward's
//   per-pixel bounce counts in pixel order, and follow sample by sample,
//   bounce by bounce. The replay takes the forward's decisions, so a lane
//   fills exactly its range; if it would not, the kernel raises a flag and
//   the wrapper refuses the result. grad_reduce_chunks then sums fixed
//   chunks of events in order, thread t owning sphere t, and
//   grad_reduce_partials sums the chunks in order. The result is the same
//   bits for any lane order and any tile.
//
// What should bound it: the replay's sphere sweep (N x ~15 flops per bounce,
// as in the forward), plus the trajectory and event traffic to device memory:
// about 40 B written and read back per bounce, and 64 B per event written
// and read once by the reduction. Tuning is for later work.
//
// Build with the forward kernel's flags (nvcc -gencode arch=compute_90a,
// code=sm_90a -O3 -fmad=false, no --use_fast_math): the replay knows the
// forward's decisions only by recomputing them, so both must round alike.
#include <cuda_runtime.h>

#include "grad_device.cuh"

using namespace rt;

constexpr int MAX_GRAD_TILE = 512;
constexpr int TRAJ_ROWS = 10;  // o, d, att, winner (int bits)
// Events per reduction block, and per shared-memory stage within it. Fixed:
// the summation order must not depend on the launch.
constexpr int CHUNK_EVENTS = 8192;
constexpr int STAGE_EVENTS = 256;
// flags[0]: a lane had more bounces than its slot range; flags[1]: fewer.
constexpr int FLAG_OVER = 0, FLAG_UNDER = 1;

__device__ __forceinline__ void put_event(float4* ev, int winner, const PBar& p) {
    ev[0] = make_float4(__int_as_float(winner), p.c.x, p.c.y, p.c.z);
    ev[1] = make_float4(p.r, p.albedo.x, p.albedo.y, p.albedo.z);
    ev[2] = make_float4(p.fuzz, p.ior, p.m2c.x, p.m2c.y);
    ev[3] = make_float4(p.m2c.z, p.csq, 0.0f, 0.0f);
}

__device__ __forceinline__ void put_empty_event(float4* ev) {
    ev[0] = make_float4(__int_as_float(-1), 0.0f, 0.0f, 0.0f);
}

__global__ void __launch_bounds__(MAX_GRAD_TILE)
    grad_kernel(const float4* __restrict__ table, int n_spheres, const float* __restrict__ cam_vec,
                const int* __restrict__ pix_lanes, const float* __restrict__ g,
                const long long* __restrict__ ev_start, const int* __restrict__ ev_count,
                float* __restrict__ traj, float4* __restrict__ events, int* __restrict__ flags, int n_lanes,
                int n_live, int seed, int sample_offset, int spp, int max_depth) {
    extern __shared__ float4 s_table[];
    __shared__ float s_cam[CAM_LEN];
    for (int k = threadIdx.x; k < 4 * n_spheres; k += blockDim.x) s_table[k] = table[k];
    if (threadIdx.x < CAM_LEN) s_cam[threadIdx.x] = cam_vec[threadIdx.x];
    __syncthreads();

    const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n_lanes) return;
    const int64_t P = n_lanes;
    long long slot = ev_start[j];
    const long long end = slot + ev_count[j];
    const int pix = pix_lanes[j];
    if (pix < 0 || pix >= n_live) {  // pad lane: idle
        if (slot != end) atomicOr(&flags[FLAG_UNDER], 1);
        return;
    }
    const Cam cam = unpack_cam(s_cam);
    const float px = (float)(pix % cam.width);
    const float py = (float)(pix / cam.width);
    const uint32_t h0 = pcg((uint32_t)pix ^ pcg((uint32_t)seed));
    const vec3 gl = {g[j], g[P + j], g[2 * P + j]};
    float* tr = traj + j;  // row r of bounce k at tr[(k * TRAJ_ROWS + r) * P]

    for (int s = 0; s < spp; ++s) {
        vec3 o, d;
        Stream st;
        camera_ray(cam, h0, px, py, (uint32_t)(s + sample_offset), o, d, st);
        vec3 att = {1.0f, 1.0f, 1.0f};

        // Replay, recording the pre-bounce state and the winner (-1: miss).
        int n = 0;
        bool miss = false;
        for (int depth = 0; depth < max_depth;) {
            float* e = tr + (int64_t)n * TRAJ_ROWS * P;
            e[0 * P] = o.x;
            e[1 * P] = o.y;
            e[2 * P] = o.z;
            e[3 * P] = d.x;
            e[4 * P] = d.y;
            e[5 * P] = d.z;
            e[6 * P] = att.x;
            e[7 * P] = att.y;
            e[8 * P] = att.z;
            float t_best;
            int best;
            closest_hit(s_table, n_spheres, o, d, cam.t_min, t_best, best);
            const uint32_t ctr = 8u + (uint32_t)depth * 16u;
            depth += 1;
            ++n;
            if (!(t_best < T_MISS * 0.5f)) {
                e[9 * P] = __int_as_float(-1);
                miss = true;
                break;
            }
            e[9 * P] = __int_as_float(best);
            // The rest of render_device.cuh's bounce(), expression for expression.
            const float4* row = s_table + 4 * best;
            const float4 c = row[0];
            const vec3 p = o + t_best * d;
            const float inv_r = 1.0f / (fabsf(c.w) > 1e-8f ? c.w : 1.0f);
            const vec3 outward = (p - vec3{c.x, c.y, c.z}) * inv_r;
            const bool front_face = dot3(d, outward) < 0.0f;
            const vec3 nrm = front_face ? outward : -outward;
            vec3 new_dir, mat_atten;
            const bool ok = scatter(d, nrm, front_face, row, st, ctr, new_dir, mat_atten);
            if (!(ok && depth < max_depth)) break;  // absorbed or out of depth: radiance 0
            att = att * mat_atten;
            o = p;
            d = new_dir;
        }
        if (slot + n > end) {
            atomicOr(&flags[FLAG_OVER], 1);
            return;
        }

        // Reverse. Only a path that reached the sky carries radiance; the
        // others add nothing, and their events are empty.
        float4* ev = events + 4 * slot;
        put_empty_event(ev + 4 * (n - 1));
        if (miss) {
            const float* e = tr + (int64_t)(n - 1) * TRAJ_ROWS * P;
            vec3 ob = {0.0f, 0.0f, 0.0f}, db, ab;
            sky_adjoint({e[3 * P], e[4 * P], e[5 * P]}, {e[6 * P], e[7 * P], e[8 * P]}, gl, db, ab);
            db = clip3(db);
            ab = clip3(ab);
            for (int k = n - 2; k >= 0; --k) {
                e = tr + (int64_t)k * TRAJ_ROWS * P;
                const vec3 o_k = {e[0], e[P], e[2 * P]};
                const vec3 dk = {e[3 * P], e[4 * P], e[5 * P]};
                const vec3 ak = {e[6 * P], e[7 * P], e[8 * P]};
                const int best = __float_as_int(e[9 * P]);
                PBar pb;
                bounce_adjoint(s_table + 4 * best, o_k, dk, ak, st, 8u + (uint32_t)k * 16u, cam.t_min, ob, db,
                               ab, pb);
                ob = clip3(ob);
                db = clip3(db);
                ab = clip3(ab);
                clip_pbar(pb);
                put_event(ev + 4 * k, best, pb);
            }
        } else {
            for (int k = n - 2; k >= 0; --k) put_empty_event(ev + 4 * k);
        }
        slot += n;
    }
    if (slot != end) atomicOr(&flags[FLAG_UNDER], 1);
}

// Sum events [CHUNK_EVENTS * b, CHUNK_EVENTS * (b + 1)) in order: thread t
// owns sphere t. Writes the chunk's [16, n_spheres] partial.
__global__ void grad_reduce_chunks(const float4* __restrict__ events, long long n_events, int n_spheres,
                                   float* __restrict__ partials) {
    __shared__ float4 s_ev[4 * STAGE_EVENTS];
    const int t = threadIdx.x;
    float acc[13];
    for (int r = 0; r < 13; ++r) acc[r] = 0.0f;
    const long long c0 = (long long)blockIdx.x * CHUNK_EVENTS;
    const long long c1 = min(c0 + CHUNK_EVENTS, n_events);
    for (long long e0 = c0; e0 < c1; e0 += STAGE_EVENTS) {
        const int m = (int)min((long long)STAGE_EVENTS, c1 - e0);
        __syncthreads();
        for (int k = t; k < 4 * m; k += blockDim.x) s_ev[k] = events[4 * e0 + k];
        __syncthreads();
        if (t < n_spheres) {
            for (int e = 0; e < m; ++e) {
                const float4 w0 = s_ev[4 * e];
                if (__float_as_int(w0.x) != t) continue;
                const float4 w1 = s_ev[4 * e + 1], w2 = s_ev[4 * e + 2], w3 = s_ev[4 * e + 3];
                acc[0] += w0.y;
                acc[1] += w0.z;
                acc[2] += w0.w;
                acc[3] += w1.x;
                acc[4] += w1.y;
                acc[5] += w1.z;
                acc[6] += w1.w;
                acc[7] += w2.x;
                acc[8] += w2.y;
                acc[9] += w2.z;
                acc[10] += w2.w;
                acc[11] += w3.x;
                acc[12] += w3.y;
            }
        }
    }
    if (t >= n_spheres) return;
    // Event rows -> P rows (r^2, mat and active, rows 4, 10, 11, stay 0).
    const int rows[13] = {0, 1, 2, 3, 5, 6, 7, 8, 9, 12, 13, 14, 15};
    float* out = partials + (size_t)blockIdx.x * P_ROWS * n_spheres;
    for (int r = 0; r < P_ROWS; ++r) out[(size_t)r * n_spheres + t] = 0.0f;
    for (int r = 0; r < 13; ++r) out[(size_t)rows[r] * n_spheres + t] = acc[r];
}

// out[i] = sum of partials[c][i] over chunks c in order.
__global__ void grad_reduce_partials(const float* __restrict__ partials, int n_chunks, int n_out,
                                     float* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_out) return;
    float s = 0.0f;
    for (int c = 0; c < n_chunks; ++c) s += partials[(size_t)c * n_out + i];
    out[i] = s;
}

// Launch the replay on `stream`. table [n_spheres, 16] f32; cam [CAM_LEN] f32;
// pix [n_lanes] i32; g [3, n_lanes] f32; ev_start [n_lanes] i64, ev_count
// [n_lanes] i32; traj [max_depth, TRAJ_ROWS, n_lanes] f32 scratch; events
// [n_events, 16] f32; flags [2] i32, zeroed. Returns cudaGetLastError().
extern "C" int rt_grad_pass(const void* table, int n_spheres, const void* cam, const void* pix, const void* g,
                            const void* ev_start, const void* ev_count, void* traj, void* events, void* flags,
                            int n_lanes, int tile, int n_live, int seed, int sample_offset, int spp, int max_depth,
                            void* stream) {
    const size_t smem = (size_t)n_spheres * P_ROWS * sizeof(float);
    grad_kernel<<<n_lanes / tile, tile, smem, (cudaStream_t)stream>>>(
        (const float4*)table, n_spheres, (const float*)cam, (const int*)pix, (const float*)g,
        (const long long*)ev_start, (const int*)ev_count, (float*)traj, (float4*)events, (int*)flags, n_lanes,
        n_live, seed, sample_offset, spp, max_depth);
    return (int)cudaGetLastError();
}

// Reduce `n_events` event records into out [16, n_spheres] through partials
// [ceil(n_events / CHUNK_EVENTS), 16, n_spheres]. n_spheres <= 1024.
extern "C" int rt_grad_reduce(const void* events, long long n_events, int n_spheres, void* partials, void* out,
                              void* stream) {
    const int n_chunks = (int)((n_events + CHUNK_EVENTS - 1) / CHUNK_EVENTS);
    if (n_chunks > 0) {
        const int threads = (n_spheres + 31) / 32 * 32;
        grad_reduce_chunks<<<n_chunks, threads, 0, (cudaStream_t)stream>>>((const float4*)events, n_events,
                                                                           n_spheres, (float*)partials);
        const int err = (int)cudaGetLastError();
        if (err != 0) return err;
    }
    const int n_out = P_ROWS * n_spheres;
    grad_reduce_partials<<<(n_out + 255) / 256, 256, 0, (cudaStream_t)stream>>>((const float*)partials,
                                                                               n_chunks, n_out, (float*)out);
    return (int)cudaGetLastError();
}

// The hand-written adjoint alone, one thread per recorded bounce: how the
// checks hold bounce_adjoint against torch.autograd of the plain `_bounce_f`.
// Rows of [R, n] arrays at r * n + i; ob, db, ab [3, n] are read as the
// cotangents of the bounce's outputs and overwritten with its inputs'.
__global__ void bounce_adjoint_kernel(const float4* __restrict__ table, float t_min, int n,
                                      const float* __restrict__ o, const float* __restrict__ d,
                                      const float* __restrict__ att, const int* __restrict__ winner,
                                      const int* __restrict__ lo, const int* __restrict__ hi,
                                      const int* __restrict__ depth, float* ob, float* db, float* ab,
                                      float* __restrict__ pbar) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    auto ld = [&](const float* a) { return vec3{a[i], a[n + i], a[2 * n + i]}; };
    auto st3 = [&](float* a, vec3 v) {
        a[i] = v.x;
        a[n + i] = v.y;
        a[2 * n + i] = v.z;
    };
    vec3 ob_ = ld(ob), db_ = ld(db), ab_ = ld(ab);
    PBar pb;
    const Stream st = {(uint32_t)lo[i], (uint32_t)hi[i]};
    bounce_adjoint(table + 4 * winner[i], ld(o), ld(d), ld(att), st, 8u + (uint32_t)depth[i] * 16u, t_min, ob_,
                   db_, ab_, pb);
    st3(ob, ob_);
    st3(db, db_);
    st3(ab, ab_);
    const float rows[P_ROWS] = {pb.c.x,      pb.c.y,      pb.c.z, pb.r,     0.0f,     pb.albedo.x,
                                pb.albedo.y, pb.albedo.z, pb.fuzz, pb.ior,  0.0f,     0.0f,
                                pb.m2c.x,    pb.m2c.y,    pb.m2c.z, pb.csq};
    for (int r = 0; r < P_ROWS; ++r) pbar[r * n + i] = rows[r];
}

extern "C" int rt_bounce_adjoint(const void* table, float t_min, int n, const void* o, const void* d,
                                 const void* att, const void* winner, const void* lo, const void* hi,
                                 const void* depth, void* ob, void* db, void* ab, void* pbar, void* stream) {
    bounce_adjoint_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        (const float4*)table, t_min, n, (const float*)o, (const float*)d, (const float*)att, (const int*)winner,
        (const int*)lo, (const int*)hi, (const int*)depth, (float*)ob, (float*)db, (float*)ab, (float*)pbar);
    return (int)cudaGetLastError();
}

extern "C" int rt_max_grad_tile() { return MAX_GRAD_TILE; }

extern "C" long long rt_chunk_events() { return CHUNK_EVENTS; }
