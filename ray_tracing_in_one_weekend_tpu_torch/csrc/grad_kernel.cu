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
//   forward's sweep table in shared memory, its closest_hit and its
//   register cap. A lane starts its next sample as soon as a path retires,
//   so a warp pays the max over its lanes of each lane's sum of bounces,
//   not the sum over samples of the per-sample max. Each bounce
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
// grad_reduce_chunks then sums fixed chunks of events in order, and
// grad_reduce_partials sums the chunks in order (see the reduction's note
// below). The result is the same bits for any lane order and any tile.
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
// Events per reduction block: fixed, since the summation order must not
// depend on the launch. Per shared-memory stage within it: four a lane of
// a warp (the stage does not enter the order).
constexpr int CHUNK_EVENTS = 8192;
constexpr int STAGE_EVENTS = 128;
// The largest scene the reduction takes (its accumulators then take 52 KB
// of shared memory a block).
constexpr int MAX_REDUCE_SPHERES = 1024;
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

SWEEP_KERNEL grad_replay_kernel(const float4* __restrict__ table, int n_spheres, const float* __restrict__ cam_vec,
                                const int* __restrict__ pix_lanes, const long long* __restrict__ ev_start,
                                const int* __restrict__ ev_count, float4* __restrict__ records,
                                int* __restrict__ flags, int n_lanes, int n_live, int seed, int sample_offset,
                                int spp, int max_depth) {
    extern __shared__ float4 s_sweep[];
    __shared__ float s_cam[CAM_LEN];
    load_sweep_table(s_sweep, table, n_spheres);
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
        closest_hit(s_sweep, n_spheres, o, d, cam.t_min, t_best, best);
        if (!(t_best < T_MISS * 0.5f)) {
            put_record(rec, o, d, att, -1, st, depth, END_SKY);
            busy = false;
            continue;
        }
        // The rest of render_device.cuh's bounce(), expression for expression.
        const float4* row = table + 4 * best;
        const float4 c = __ldg(row);
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

// ---------------------------------------------------------------------------
// The reduction: events -> [16, N], in an order fixed by the event index.
//
// Replaces the one-hot scatter of ray_tracing_in_one_weekend_tpu/ops/
// pallas_grad.py::_bwd_kernel (:476-498), an MXU matmul of each bounce's
// cotangent by the winner's one-hot row. Here the order is the contract:
// chunk c is events [CHUNK_EVENTS * c, CHUNK_EVENTS * (c + 1)); its partial
// for (sphere, row) is ((+0 + e0) + e1) + ... over that sphere's events in
// increasing index, and the result is ((+0 + p0) + p1) + ... over chunks in
// order. So the gradient is the same bits for any lane order, any tile and
// any launch shape.
//
// Bound by bytes: each 64-byte event read once (at the bench preset 26.5M
// events, 1.7 GB: 0.51 ms at 3.35 TB/s). The design's answer: work per
// event, not per sphere x event. A block takes one chunk. It stages
// STAGE_EVENTS events at a time in a ring in shared memory by cp.async,
// the next stage in flight while one is added, and copies the stage's
// winners apart. Warp w owns the spheres s with s % REDUCE_WARPS == w:
// ballots over the winners list its own events in index order, and it
// adds each with one lane a cotangent row (13 independent folds, so the
// heaviest sphere's serial chain is one add an event), a batch of events'
// loads in flight before their adds. The sphere being added to stays in
// registers; its 13 accumulators go to shared memory when the warp turns
// to another sphere, and start at +0. What bounds the kernel is then the
// chunk's heaviest sphere, the ground in the image's lower half (2,487
// events of a chunk's 8,192 at the median, bench preset): its events
// are listed apart and added last, in a loop without a branch, so the
// warp turns to another sphere at most a few times a stage. Every add of
// a sphere's events is made in increasing index, on the same values, as
// the contract orders it: the bits are those of _reduce_events_ordered
// (ops/cuda_grad.py).
// ---------------------------------------------------------------------------

constexpr int EVENT_ROWS = 13;  // cotangent words 1-13 of an event
constexpr int REDUCE_THREADS = 256;
constexpr int REDUCE_WARPS = REDUCE_THREADS / 32;
constexpr int STAGE_LOADS = 4 * STAGE_EVENTS / REDUCE_THREADS;  // float4 a thread a stage
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int REDUCE_BUFFERS = 2;  // stages in the ring: one in flight while one is added
constexpr int FOLD_BATCH = 4;      // events a warp loads before adding them
// A warp's list: a stage's events, the hot ones from a multiple of 4, and
// the over-read of the batch after the last.
constexpr int LIST_LEN = STAGE_EVENTS + 4 + 2 * FOLD_BATCH;
static_assert(FOLD_BATCH % 4 == 0 && STAGE_EVENTS == 4 * 32, "list entries: int4 loads; four events a lane");
static_assert(STAGE_LOADS * REDUCE_THREADS == 4 * STAGE_EVENTS, "reduction stage");
static_assert((REDUCE_WARPS & (REDUCE_WARPS - 1)) == 0, "sphere owners by a mask");

// Shared memory of a grad_reduce_chunks block: the ring of staged events,
// the stage's winners, each warp's list of its own events of the stage,
// then each sphere's 13 accumulators.
__host__ __device__ constexpr size_t reduce_smem_bytes(int n_spheres) {
    return sizeof(float4) * 4 * STAGE_EVENTS * REDUCE_BUFFERS + sizeof(int) * (STAGE_EVENTS + LIST_LEN * REDUCE_WARPS) +
           sizeof(float) * (size_t)n_spheres * EVENT_ROWS;
}

// 16 bytes from device memory to shared memory, without registers.
__device__ __forceinline__ void copy16(float4* smem, const float4* gmem) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// Stage k's events go to ring slot k % REDUCE_BUFFERS by cp.async, one
// commit group a stage (empty past the chunk's end).
__device__ __forceinline__ void fetch_stage(float4* ring, const float4* src, int k, int n, int n_stages, int t) {
    if (k < n_stages) {
        const int words = 4 * min(STAGE_EVENTS, n - k * STAGE_EVENTS);
        float4* dst = ring + 4 * STAGE_EVENTS * (k % REDUCE_BUFFERS);
#pragma unroll
        for (int j = 0; j < STAGE_LOADS; ++j) {
            const int i = t + j * REDUCE_THREADS;
            if (i < words) copy16(dst + i, src + 4 * STAGE_EVENTS * k + i);
        }
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

// Entries q .. q + FOLD_BATCH - 1 of a warp's list and their events' row
// r (positions masked to the stage, so a stale entry reads inside it).
__device__ __forceinline__ void load_batch(const int* list, const float* ev, int q, int r, int (&x)[FOLD_BATCH],
                                           float (&v)[FOLD_BATCH]) {
#pragma unroll
    for (int i = 0; i < FOLD_BATCH; i += 4) {
        const int4 l4 = *reinterpret_cast<const int4*>(list + q + i);
        x[i] = l4.x;
        x[i + 1] = l4.y;
        x[i + 2] = l4.z;
        x[i + 3] = l4.w;
    }
#pragma unroll
    for (int i = 0; i < FOLD_BATCH; ++i) v[i] = ev[16 * (x[i] & (STAGE_EVENTS - 1)) + 1 + r];
}

// The warp's accumulator turns from sphere `cur` to sphere `s` (-1: none):
// the old one's rows go to shared memory, the new one's come from there.
__device__ __forceinline__ void turn_to(float* acc, int& cur, float& a, int s, int lane) {
    if (cur >= 0 && lane < EVENT_ROWS) acc[EVENT_ROWS * cur + lane] = a;
    cur = s;
    if (s >= 0) a = acc[EVENT_ROWS * s + min(lane, EVENT_ROWS - 1)];
}

// Chunk blockIdx.x's partial, [EVENT_ROWS, n_spheres] at partials +
// blockIdx.x * EVENT_ROWS * n_spheres. A winner outside [0, n_spheres)
// (-1: no sphere) adds nothing.
__global__ void __launch_bounds__(REDUCE_THREADS)
    grad_reduce_chunks(const float4* __restrict__ events, long long n_events, int n_spheres,
                       float* __restrict__ partials) {
    extern __shared__ float4 s_ring[];                                 // [REDUCE_BUFFERS][4 * STAGE_EVENTS]
    int* s_win = reinterpret_cast<int*>(s_ring + 4 * STAGE_EVENTS * REDUCE_BUFFERS);  // [STAGE_EVENTS]
    int* s_list = s_win + STAGE_EVENTS;                                // [REDUCE_WARPS][LIST_LEN]
    float* s_acc = reinterpret_cast<float*>(s_list + LIST_LEN * REDUCE_WARPS);  // [n_spheres][EVENT_ROWS]
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    for (int i = t; i < EVENT_ROWS * n_spheres; i += REDUCE_THREADS) s_acc[i] = 0.0f;

    const long long c0 = (long long)blockIdx.x * CHUNK_EVENTS;
    const int n = (int)min((long long)CHUNK_EVENTS, n_events - c0);
    const int n_stages = (n + STAGE_EVENTS - 1) / STAGE_EVENTS;
    const float4* src = events + 4 * c0;
    for (int k = 0; k < REDUCE_BUFFERS - 1; ++k) fetch_stage(s_ring, src, k, n, n_stages, t);
    // The sphere this warp adds to, and its accumulator (row r on lane r;
    // lanes 13-31 repeat row 12 and store nothing).
    const int r = min(lane, EVENT_ROWS - 1);
    int cur = -1;
    float a = 0.0f;
    int* list = s_list + LIST_LEN * warp;
    int hot = -1;
    for (int k = 0; k < n_stages; ++k) {
        const int m = min(STAGE_EVENTS, n - k * STAGE_EVENTS);
        const float4* s_ev = s_ring + 4 * STAGE_EVENTS * (k % REDUCE_BUFFERS);
        asm volatile("cp.async.wait_group %0;\n" ::"n"(REDUCE_BUFFERS - 2));  // this thread's copies of stage k
        // Every copy of stage k has landed, and every warp is done with stage
        // k - 1: its ring slot takes stage k + REDUCE_BUFFERS - 1.
        __syncthreads();
        if (t < m) s_win[t] = __float_as_int(s_ev[4 * t].x);
        fetch_stage(s_ring, src, k + REDUCE_BUFFERS - 1, n, n_stages, t);
        __syncthreads();
        const float* ev = reinterpret_cast<const float*>(s_ev);

        // This warp's events of the stage in index order, in two lists:
        // the others as (winner << 8) | position, then, from the next
        // multiple of 4, those of sphere `hot` (the sphere its registers
        // hold, as a rule the chunk's heaviest) as positions. The two
        // lists share no sphere, so adding the others first and then the
        // hot ones keeps every sphere's order. Lane l reads the winners of
        // events 4l .. 4l + 3.
        const int4 w4 = *reinterpret_cast<const int4*>(s_win + 4 * lane);
        const int wv[4] = {w4.x, w4.y, w4.z, w4.w};
        unsigned hot_bits[4], other_bits[4];
        int n_hot = 0, n_other = 0, hot_below = 0, other_below = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const bool own = 4 * lane + j < m && (unsigned)wv[j] < (unsigned)n_spheres &&
                             (wv[j] & (REDUCE_WARPS - 1)) == warp;
            hot_bits[j] = __ballot_sync(FULL_MASK, own && wv[j] == hot);
            other_bits[j] = __ballot_sync(FULL_MASK, own && wv[j] != hot);
            const unsigned below = (1u << lane) - 1u;
            n_hot += __popc(hot_bits[j]);
            n_other += __popc(other_bits[j]);
            hot_below += __popc(hot_bits[j] & below);
            other_below += __popc(other_bits[j] & below);
        }
        const int hot_at = (n_other + 3) & ~3;  // int4 loads of the hot list
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (other_bits[j] >> lane & 1u) list[other_below++] = (wv[j] << 8) | (4 * lane + j);
            if (hot_bits[j] >> lane & 1u) list[hot_at + hot_below++] = 4 * lane + j;
        }
        __syncwarp();
        // FOLD_BATCH at a time, the next batch's list entries and values
        // loaded while this one's are added, in index order (entries past
        // the list's end are stale and not added): the others, turning the
        // registers from sphere to sphere, then the hot ones without a
        // branch.
        int x[FOLD_BATCH];
        float v[FOLD_BATCH];
        load_batch(list, ev, 0, r, x, v);
        for (int q = 0; q < n_other; q += FOLD_BATCH) {
            int xn[FOLD_BATCH];
            float vn[FOLD_BATCH];
            load_batch(list, ev, q + FOLD_BATCH, r, xn, vn);
#pragma unroll
            for (int i = 0; i < FOLD_BATCH; ++i) {
                if (q + i < n_other) {
                    if ((x[i] >> 8) != cur) turn_to(s_acc, cur, a, x[i] >> 8, lane);
                    a += v[i];
                }
            }
#pragma unroll
            for (int i = 0; i < FOLD_BATCH; ++i) {
                x[i] = xn[i];
                v[i] = vn[i];
            }
        }
        if (n_hot > 0) {
            if (cur != hot) turn_to(s_acc, cur, a, hot, lane);
            load_batch(list, ev, hot_at, r, x, v);
            for (int q = 0; q < n_hot; q += FOLD_BATCH) {
                int xn[FOLD_BATCH];
                float vn[FOLD_BATCH];
                load_batch(list, ev, hot_at + q + FOLD_BATCH, r, xn, vn);
#pragma unroll
                for (int i = 0; i < FOLD_BATCH; ++i)
                    if (q + i < n_hot) a += v[i];
#pragma unroll
                for (int i = 0; i < FOLD_BATCH; ++i) {
                    x[i] = xn[i];
                    v[i] = vn[i];
                }
            }
        }
        // The next stage's hot sphere: this one's while it holds most of
        // the warp's events, else the sphere of the first other event.
        if (n_other > n_hot) hot = list[0] >> 8;
    }
    turn_to(s_acc, cur, a, -1, lane);
    __syncthreads();
    float* out = partials + (size_t)blockIdx.x * EVENT_ROWS * n_spheres;
    for (int i = t; i < EVENT_ROWS * n_spheres; i += REDUCE_THREADS) {
        const int row = i / n_spheres, s = i - row * n_spheres;
        out[i] = s_acc[EVENT_ROWS * s + row];
    }
}

// The fold over chunks: out[row][s] = ((+0 + p_0) + p_1) + ... over the
// chunks' partials of (row, s) in chunk order; rows 4, 10 and 11 (r^2, mat
// and active: no event carries them) are +0. One thread an output stays,
// since the fold is serial; a block takes 32 columns of one row, and its 8
// warps keep FOLD_ROUND partials a column in flight while warp 0 adds the
// last round's from shared memory.
constexpr int FOLD_THREADS = 256;
constexpr int FOLD_UNROLL = 16;
constexpr int FOLD_ROUND = FOLD_THREADS / 32 * FOLD_UNROLL;

__global__ void __launch_bounds__(FOLD_THREADS)
    grad_reduce_partials(const float* __restrict__ partials, int n_chunks, int n_spheres, float* __restrict__ out) {
    __shared__ float s_buf[FOLD_ROUND][32];
    const int row = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int col = blockIdx.x * 32 + lane;
    // P row -> event row (words 1-13 of an event hold rows 0-3, 5-9, 12-15).
    const int r = row < 4 ? row : row == 4 ? -1 : row < 10 ? row - 1 : row < 12 ? -1 : row - 3;
    if (r < 0) {
        if (warp == 0 && col < n_spheres) out[(size_t)row * n_spheres + col] = 0.0f;
        return;
    }
    const bool live = col < n_spheres;
    const float* src = partials + (size_t)r * n_spheres + col;
    const size_t stride = (size_t)EVENT_ROWS * n_spheres;
    float v[FOLD_UNROLL];
    auto fetch = [&](int c0) {
#pragma unroll
        for (int u = 0; u < FOLD_UNROLL; ++u) {
            const int c = c0 + warp * FOLD_UNROLL + u;
            v[u] = live && c < n_chunks ? src[c * stride] : 0.0f;
        }
    };
    fetch(0);
    float s = 0.0f;
    for (int c0 = 0; c0 < n_chunks; c0 += FOLD_ROUND) {
        __syncthreads();  // warp 0 has added the last round
#pragma unroll
        for (int u = 0; u < FOLD_UNROLL; ++u) s_buf[warp * FOLD_UNROLL + u][lane] = v[u];
        __syncthreads();
        if (c0 + FOLD_ROUND < n_chunks) fetch(c0 + FOLD_ROUND);
        if (warp == 0) {
            const int k = min(FOLD_ROUND, n_chunks - c0);
#pragma unroll 8
            for (int i = 0; i < k; ++i) s += s_buf[i][lane];
        }
    }
    if (warp == 0 && live) out[(size_t)row * n_spheres + col] = s;
}

// The largest scene the replay's sweep table takes beside its static camera
// vector, in the default 48 KB (no opt-in): what the launcher accepts.
extern "C" int rt_replay_max_spheres() {
    return (int)((DEFAULT_BLOCK_SMEM - sizeof(float) * CAM_LEN) / sizeof(float4));
}

// Launch the replay on `stream`. table [n_spheres, 16] f32; cam [CAM_LEN] f32;
// pix [n_lanes] i32; ev_start [n_lanes] i64, ev_count [n_lanes] i32; records
// [n_events, 16] f32; flags [2] i32, zeroed. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a scene the sweep table cannot hold.
extern "C" int rt_grad_replay(const void* table, int n_spheres, const void* cam, const void* pix,
                              const void* ev_start, const void* ev_count, void* records, void* flags, int n_lanes,
                              int tile, int n_live, int seed, int sample_offset, int spp, int max_depth,
                              void* stream) {
    if (n_spheres <= 0 || n_spheres > rt_replay_max_spheres()) return (int)cudaErrorInvalidValue;
    grad_replay_kernel<<<n_lanes / tile, tile, sweep_table_bytes(n_spheres), (cudaStream_t)stream>>>(
        (const float4*)table, n_spheres, (const float*)cam, (const int*)pix, (const long long*)ev_start,
        (const int*)ev_count, (float4*)records, (int*)flags, n_lanes, n_live, seed, sample_offset, spp, max_depth);
    return (int)cudaGetLastError();
}

// Resident replay blocks of `tile` threads an SM holds for a scene of
// `n_spheres`, or minus the CUDA error.
extern "C" int rt_replay_blocks_per_sm(int tile, int n_spheres) {
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, grad_replay_kernel, tile,
                                                                          sweep_table_bytes(n_spheres));
    return err == cudaSuccess ? blocks : -(int)err;
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

static cudaError_t reduce_smem_ready(int n_spheres) {
    return cudaFuncSetAttribute(grad_reduce_chunks, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)reduce_smem_bytes(n_spheres));
}

// Reduce `n_events` event records into out [16, n_spheres] through partials
// [ceil(n_events / CHUNK_EVENTS), 13, n_spheres]. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for more spheres than the reduction takes.
extern "C" int rt_grad_reduce(const void* events, long long n_events, int n_spheres, void* partials, void* out,
                              void* stream) {
    if (n_spheres <= 0 || n_spheres > MAX_REDUCE_SPHERES || n_events < 0) return (int)cudaErrorInvalidValue;
    const int n_chunks = (int)((n_events + CHUNK_EVENTS - 1) / CHUNK_EVENTS);
    if (n_chunks > 0) {
        const cudaError_t set = reduce_smem_ready(n_spheres);
        if (set != cudaSuccess) return (int)set;
        grad_reduce_chunks<<<n_chunks, REDUCE_THREADS, reduce_smem_bytes(n_spheres), (cudaStream_t)stream>>>(
            (const float4*)events, n_events, n_spheres, (float*)partials);
        const int err = (int)cudaGetLastError();
        if (err != 0) return err;
    }
    grad_reduce_partials<<<dim3((n_spheres + 31) / 32, P_ROWS), FOLD_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)partials, n_chunks, n_spheres, (float*)out);
    return (int)cudaGetLastError();
}

// Resident grad_reduce_chunks blocks an SM holds for a scene of
// `n_spheres`, or minus the CUDA error.
extern "C" int rt_reduce_blocks_per_sm(int n_spheres) {
    if (n_spheres <= 0 || n_spheres > MAX_REDUCE_SPHERES) return -(int)cudaErrorInvalidValue;
    cudaError_t err = reduce_smem_ready(n_spheres);
    int blocks = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, grad_reduce_chunks, REDUCE_THREADS,
                                                            reduce_smem_bytes(n_spheres));
    return err == cudaSuccess ? blocks : -(int)err;
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

extern "C" int rt_reduce_max_spheres() { return MAX_REDUCE_SPHERES; }

// The reduction's walk inside a chunk (no part of its order): events a
// shared-memory stage, warps that own spheres, chunks a round of the fold
// over chunks. tests/test_torch_reduce.py emulates the walk with them.
extern "C" int rt_reduce_stage_events() { return STAGE_EVENTS; }

extern "C" int rt_reduce_warps() { return REDUCE_WARPS; }

extern "C" int rt_reduce_fold_round() { return FOLD_ROUND; }
