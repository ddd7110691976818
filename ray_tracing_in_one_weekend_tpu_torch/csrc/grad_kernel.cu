// Backward render kernels: the gradient of the rendered image with respect to
// the packed scene. Hand-written for Hopper (sm_90a).
//
// Together they replace ray_tracing_in_one_weekend_tpu/ops/pallas_grad.py::
// _bwd_kernel, the Pallas TPU kernel, and compute what it computes: every
// (pixel, sample) path is replayed with the forward kernel's own device
// functions (render_device.cuh), then the radiance cotangent is pulled back
// through each bounce in reverse (grad_device.cuh, the hand-written adjoint
// of the JAX kernel's `F`), every adjoint and parameter cotangent clipped to
// +-1e6 per step, and each bounce's cotangent is added into the winning
// sphere's column of a [16, N] result. Adjoints start at zero for every
// path, as the JAX kernel's reset at a regen boundary does. The JAX kernel's
// two phases are two kernels here:
//
// * grad_replay_kernel, its Phase A: the forward's persistent-sample loop
//   (render_kernel.cu), one thread per lane (a lane is a pixel, given as
//   data, so the caller may sort lanes by cost), `tile` lanes a block, the
//   scene table in shared memory. A lane starts its next sample as soon as a
//   path retires, so a warp pays the max over its lanes of each lane's sum
//   of bounces, not the sum over samples of the per-sample max. Each bounce
//   writes one 64-byte record: the pre-bounce o, d, att, the winner (-1 for
//   a miss), the stream words, the depth and how the path goes on. There is
//   no adjoint code here: it is the forward kernel plus record stores.
// * grad_reverse_kernel, its Phase B: one thread per lane walks its records
//   from the last to the first. At each path's last bounce the adjoints
//   start from zero (from the sky's adjoint if the path reached the sky),
//   and each earlier bounce of such a path takes bounce_adjoint. It
//   overwrites every record in place with that bounce's event (winner,
//   13 cotangent rows): the thread that reads a slot is the one that writes
//   it, and the record buffer becomes the event buffer.
//
// Two TPU-isms are gone. The VMEM trajectory slab goes to device memory as
// the records, one per bounce and no more. The one-hot MXU matmul that
// scattered the cotangents is gone too: float atomics would make the
// gradient depend on timing, so every bounce owns a slot. A lane's slots
// start at the exclusive prefix sum of the forward's per-pixel bounce counts
// in pixel order and follow sample by sample, bounce by bounce. The replay
// takes the forward's decisions, so a lane fills exactly its range; if it
// would not, the replay raises a flag and the wrapper refuses the records.
// grad_reduce_chunks then sums fixed chunks of events in order, thread t
// owning sphere t, and grad_reduce_partials sums the chunks in order. The
// result is the same bits for any lane order and any tile.
//
// Bounds on this card (counted from this run's bounces by chip_smoke.py):
// the replay by operations, the forward's sweep of N x 15 flops per bounce
// (at the bench preset 26.5M bounces x 512 x 15 over 67 TFLOP/s = 3.04 ms;
// its 1.7 GB of records take 0.51 ms at 3.35 TB/s); the reverse by bytes,
// each record read once and overwritten once (1.7 + 1.7 GB, 1.01 ms). The
// design's answer: max-of-sums occupancy in the replay, the adjoint out of
// the sweep kernel's registers, and records overwritten in place, so the
// reverse moves no trajectory besides them and allocates nothing.
//
// Build with the forward kernel's flags (nvcc -gencode arch=compute_90a,
// code=sm_90a -O3 -fmad=false, no --use_fast_math): the replay knows the
// forward's decisions only by recomputing them, so both must round alike.
#include <cuda_runtime.h>

#include "grad_device.cuh"

using namespace rt;

constexpr int MAX_GRAD_TILE = 512;
// Record words (float4 r[4]; int fields as int32 bits): r[0] = o, d.x;
// r[1] = d.y, d.z, att.x, att.y; r[2] = att.z, winner, stream lo, stream hi;
// r[3] = depth, end, 0, 0.
// end: the path goes on after this bounce, ends without radiance (absorbed,
// or at the depth limit), or ends at the sky (a miss).
constexpr int END_NONE = 0, END_DARK = 1, END_SKY = 2;
// Events per reduction block, and per shared-memory stage within it. Fixed:
// the summation order must not depend on the launch.
constexpr int CHUNK_EVENTS = 8192;
constexpr int STAGE_EVENTS = 256;
// flags[0]: a lane had more bounces than its slot range; flags[1]: fewer.
constexpr int FLAG_OVER = 0, FLAG_UNDER = 1;

__device__ __forceinline__ void put_record(float4* rec, vec3 o, vec3 d, vec3 att, int winner, Stream st, int depth,
                                           int end) {
    rec[0] = make_float4(o.x, o.y, o.z, d.x);
    rec[1] = make_float4(d.y, d.z, att.x, att.y);
    rec[2] = make_float4(att.z, __int_as_float(winner), __uint_as_float(st.lo), __uint_as_float(st.hi));
    rec[3] = make_float4(__int_as_float(depth), __int_as_float(end), 0.0f, 0.0f);
}

__device__ __forceinline__ void put_event(float4* ev, int winner, const PBar& p) {
    ev[0] = make_float4(__int_as_float(winner), p.c.x, p.c.y, p.c.z);
    ev[1] = make_float4(p.r, p.albedo.x, p.albedo.y, p.albedo.z);
    ev[2] = make_float4(p.fuzz, p.ior, p.m2c.x, p.m2c.y);
    ev[3] = make_float4(p.m2c.z, p.csq, 0.0f, 0.0f);
}

// No sphere, no cotangent: all 16 words written, so none of the record stays.
__device__ __forceinline__ void put_empty_event(float4* ev) {
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    ev[0] = make_float4(__int_as_float(-1), 0.0f, 0.0f, 0.0f);
    ev[1] = z;
    ev[2] = z;
    ev[3] = z;
}

__global__ void __launch_bounds__(MAX_GRAD_TILE)
    grad_replay_kernel(const float4* __restrict__ table, int n_spheres, const float* __restrict__ cam_vec,
                       const int* __restrict__ pix_lanes, const long long* __restrict__ ev_start,
                       const int* __restrict__ ev_count, float4* __restrict__ records, int* __restrict__ flags,
                       int n_lanes, int n_live, int seed, int sample_offset, int spp, int max_depth) {
    extern __shared__ float4 s_table[];
    __shared__ float s_cam[CAM_LEN];
    for (int k = threadIdx.x; k < 4 * n_spheres; k += blockDim.x) s_table[k] = table[k];
    if (threadIdx.x < CAM_LEN) s_cam[threadIdx.x] = cam_vec[threadIdx.x];
    __syncthreads();

    const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n_lanes) return;
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

    // The forward's loop: an idle lane with samples left starts one, a busy
    // lane advances one bounce per iteration, with no budget.
    vec3 o, d, att;
    Stream st;
    int started = 0, depth = 0;
    bool busy = false;
    for (;;) {
        if (!busy) {
            if (started >= spp) break;
            camera_ray(cam, h0, px, py, (uint32_t)(started + sample_offset), o, d, st);
            ++started;
            depth = 0;
            att = {1.0f, 1.0f, 1.0f};
            busy = true;
        }
        if (slot >= end) {
            atomicOr(&flags[FLAG_OVER], 1);
            return;
        }
        float4* rec = records + 4 * slot++;
        float t_best;
        int best;
        closest_hit(s_table, n_spheres, o, d, cam.t_min, t_best, best);
        if (!(t_best < T_MISS * 0.5f)) {
            put_record(rec, o, d, att, -1, st, depth, END_SKY);
            busy = false;
            continue;
        }
        // The rest of render_device.cuh's bounce(), expression for expression.
        const float4* row = s_table + 4 * best;
        const float4 c = row[0];
        const vec3 p = o + t_best * d;
        const float inv_r = 1.0f / (fabsf(c.w) > 1e-8f ? c.w : 1.0f);
        const vec3 outward = (p - vec3{c.x, c.y, c.z}) * inv_r;
        const bool front_face = dot3(d, outward) < 0.0f;
        const vec3 nrm = front_face ? outward : -outward;
        vec3 new_dir, mat_atten;
        const bool ok = scatter(d, nrm, front_face, row, st, 8u + (uint32_t)depth * 16u, new_dir, mat_atten);
        depth += 1;
        busy = ok && depth < max_depth;  // absorbed or out of depth: radiance 0
        put_record(rec, o, d, att, best, st, depth - 1, busy ? END_NONE : END_DARK);
        if (busy) {
            att = att * mat_atten;
            o = p;
            d = new_dir;
        }
    }
    if (slot != end) atomicOr(&flags[FLAG_UNDER], 1);
}

__global__ void __launch_bounds__(MAX_GRAD_TILE)
    grad_reverse_kernel(const float4* __restrict__ table, const float* __restrict__ cam_vec,
                        const float* __restrict__ g, const long long* __restrict__ ev_start,
                        const int* __restrict__ ev_count, float4* __restrict__ records, long long n_records,
                        int n_lanes) {
    const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n_lanes) return;
    const long long first = ev_start[j];
    // A slot range outside the records (not one the replay gave) is left alone.
    if (first < 0 || first + ev_count[j] > n_records) return;
    const int64_t P = n_lanes;
    const float t_min = cam_vec[20];
    const vec3 gl = {g[j], g[P + j], g[2 * P + j]};
    // Whether the path being walked carries radiance, and its adjoints.
    bool live = false;
    vec3 ob = {0.0f, 0.0f, 0.0f}, db = ob, ab = ob;
    for (long long k = first + ev_count[j] - 1; k >= first; --k) {
        float4* rec = records + 4 * k;
        const float4 r0 = rec[0], r1 = rec[1], r2 = rec[2], r3 = rec[3];
        const vec3 d = {r0.w, r1.x, r1.y};
        const vec3 att = {r1.z, r1.w, r2.x};
        const int end = __float_as_int(r3.y);
        if (end != END_NONE) {
            // A path's last bounce: its adjoints start here. Only a path that
            // reached the sky carries radiance; the others add nothing. The
            // bounce itself has no sphere (a miss) or no radiance.
            live = end == END_SKY;
            if (live) {
                ob = {0.0f, 0.0f, 0.0f};
                sky_adjoint(d, att, gl, db, ab);
                db = clip3(db);
                ab = clip3(ab);
            }
            put_empty_event(rec);
        } else if (!live) {
            put_empty_event(rec);
        } else {
            const int best = __float_as_int(r2.y);
            const Stream st = {__float_as_uint(r2.z), __float_as_uint(r2.w)};
            PBar pb;
            bounce_adjoint(table + 4 * best, {r0.x, r0.y, r0.z}, d, att, st,
                           8u + (uint32_t)__float_as_int(r3.x) * 16u, t_min, ob, db, ab, pb);
            ob = clip3(ob);
            db = clip3(db);
            ab = clip3(ab);
            clip_pbar(pb);
            put_event(rec, best, pb);
        }
    }
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
// pix [n_lanes] i32; ev_start [n_lanes] i64, ev_count [n_lanes] i32; records
// [n_events, 16] f32; flags [2] i32, zeroed. Returns cudaGetLastError().
extern "C" int rt_grad_replay(const void* table, int n_spheres, const void* cam, const void* pix,
                              const void* ev_start, const void* ev_count, void* records, void* flags, int n_lanes,
                              int tile, int n_live, int seed, int sample_offset, int spp, int max_depth,
                              void* stream) {
    const size_t smem = (size_t)n_spheres * P_ROWS * sizeof(float);
    grad_replay_kernel<<<n_lanes / tile, tile, smem, (cudaStream_t)stream>>>(
        (const float4*)table, n_spheres, (const float*)cam, (const int*)pix, (const long long*)ev_start,
        (const int*)ev_count, (float4*)records, (int*)flags, n_lanes, n_live, seed, sample_offset, spp, max_depth);
    return (int)cudaGetLastError();
}

// Launch the reverse walk on `stream`: records [n_events, 16] f32 from the
// replay, with the same ev_start and ev_count, are overwritten by events; g
// [3, n_lanes] f32. Returns cudaGetLastError().
extern "C" int rt_grad_reverse(const void* table, const void* cam, const void* g, const void* ev_start,
                               const void* ev_count, void* records, long long n_records, int n_lanes, int tile,
                               void* stream) {
    grad_reverse_kernel<<<n_lanes / tile, tile, 0, (cudaStream_t)stream>>>(
        (const float4*)table, (const float*)cam, (const float*)g, (const long long*)ev_start,
        (const int*)ev_count, (float4*)records, n_records, n_lanes);
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
