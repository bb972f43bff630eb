// K6a preempt_sweep: the minimal victim prefix per (preemptor, node).
//
// Replaces: kubernetes_tpu/ops/preempt.py `preempt_sweep` (:44, jitted at
// :109), the resource half of the reference's per-node preemption dry run
// (default_preemption.go:219 SelectVictimsOnNode) for every node at once.
// The twin is kubernetes_tpu_torch/ops/preempt.py:preempt_sweep (through
// kernels/preempt.py:preempt_sweep_ref); the static filters it folds in
// come from K1 (phase1_static.cu) with every feature active.
//
// The victims of node n, sorted from the least important up, free
// `cumsum[n, k, c]` of resource column `cols[c]` when the first k of them
// are evicted (k = 0 frees nothing). For pod p on node n:
//
//   base[r]  = (free[n, r] - nom[n, r]) + (n == nominated_row[p] ? req[p, r]
//              : 0)                       the fit baseline of the pipeline
//   ok_rest  = for every column r that no victim frees (r not in cols):
//              req[p, r] <= base[r]
//   fit(k)   = ok_rest and for every c: req[p, cols[c]] <= base[cols[c]]
//              + cumsum[n, k, c]
//
// and the output is the first k with fit(k), or NONE when K1's static_ok
// is false, when the request exceeds the node's allocatable in some
// column, or when no prefix fits. Padding entries of `cols` alias an
// active column and carry 3.0e38 in the cumsum, so they never bind; they
// never widen the set of columns ok_rest skips either, since that set is
// the set of values in `cols`, which the aliases repeat.
//
// Design (a group of `lanes` lanes takes one (pod, node): 8 lanes where
// R <= 8, a lane a column; 16 up to SWEEP_SPAN columns a lane; a warp past
// that):
// - every load a thread needs is issued at its start, before the CTA's one
//   barrier: the CTA stages its pod's request row, the columns and the
//   freed-column set (a bitmask built once from `cols`) in shared memory,
//   and each lane loads, in the same round, its node's K1 byte, its
//   columns of free / nom / alloc (up to SWEEP_CHUNKS a lane, in
//   registers; adjacent lanes on adjacent columns) and its prefix's first
//   SWEEP_PRE cumsum entries. So a launch waits on memory about once,
//   where a chain of dependent loads would wait on it several times. The
//   pod's fields are read in place from its packed rows, free / nom /
//   alloc from the cluster blob's rows at their stride (the live-free
//   override at its own), so the wrapper copies and casts nothing;
// - past SWEEP_LANES lanes (R > 8) a node's rows are loaded only once its
//   K1 byte has passed: a group then reads up to 3 x R x 4 bytes more, so
//   where most nodes fail K1 the reads it saves outweigh the second wait;
// - a node that fails K1 is written NONE without a look at its loads;
// - "unresolvable or a kept column does not fit" combines by a vote; each
//   lane keeps its columns' bases in the node's shared row, so the freed
//   columns' bases are read there, not formed again;
// - the lanes take the prefixes (lane k its C entries), and the first
//   fitting k is a ballot and __ffs;
// - every vote and ballot takes the whole warp, each group reading its
//   own bits: a warp whose groups passed masks of their own ran them one
//   after another (measured 1.2x slower).
//
// Every comparison is an exact f32 compare of the twin's operands, added
// in the twin's order, and the output is an integer: card and twin agree
// exactly (-fmad=false; no product is formed).
//
// What bounds it on an H100: latency. At P = 1 over N = 8,192 nodes with
// K + 1 = 9 prefixes of C = 4 columns the data it reads is under 2 MB
// (three [N, R] row slices and the cumsum's first prefixes), under a µs
// at 3.35 TB/s. The launch of the grid alone (-DSWEEP_EMPTY) measured
// about 1 µs there, and a warp's one round of loads with the barrier most
// of the rest; the design keeps each warp to that one round and its
// votes whole-warp (groups voting by masks of their own measured 1.2x
// slower), with 8 lanes a node at R <= 8 (256 CTAs of 32 nodes).

#include <cuda_runtime.h>
#include <stdint.h>

#define NONE (-1)
#define SWEEP_THREADS 256
#define SWEEP_LANES 8
#define SWEEP_LANES_MAX 32
#define SWEEP_SPAN 8                  // columns a lane takes before the
                                      // group widens
#define SWEEP_SMEM_MAX 49152
#define SWEEP_CHUNKS 4
#define SWEEP_PRE 8

// >>> sweep plan (host and device; tests/test_torch_kernel_layout.py
// compiles this block on the host and holds kernels/preempt.py's mirror
// against it)

// Mirrored by kernels/preempt.py:_SweepPlan (same members, same order).
struct SweepPlan {
    int lanes;     // lanes a (pod, node) group: a power of two, 1 to 32
    int nodes;     // nodes a CTA (SWEEP_THREADS / lanes)
    int ctas_x;    // CTAs along the node axis; the grid's y is P
    int smem;      // dynamic shared bytes a CTA
};

// shared memory of a CTA (4-byte words): the freed-column mask, the pod's
// request row, the column list, each node's row of bases
__host__ __device__ inline int sweep_mask_words(int R) {
    return (R + 31) / 32;
}

__host__ __device__ inline int sweep_smem(int R, int C, int nodes) {
    return 4 * (sweep_mask_words(R) + R + C + nodes * R);
}

// 8 lanes a node where R <= 8 (a lane a column), 16 up to SWEEP_SPAN
// columns a lane, a warp past that
extern "C" int sweep_plan(int P, int N, int R, int K1, int C,
                          SweepPlan* out) {
    if (P < 0 || N < 0 || R < 1 || K1 < 1 || C < 1) return 0;
    int lanes = R <= SWEEP_LANES ? SWEEP_LANES : 2 * SWEEP_LANES;
    while (lanes * SWEEP_SPAN < R && lanes < SWEEP_LANES_MAX) lanes *= 2;
    out->lanes = lanes;
    out->nodes = SWEEP_THREADS / lanes;
    out->ctas_x = (N + out->nodes - 1) / out->nodes;
    out->smem = sweep_smem(R, C, out->nodes);
    return out->smem <= SWEEP_SMEM_MAX;
}

// <<< sweep plan

// Mirrored by kernels/preempt.py:_SweepArgs (same members, same order).
// Row strides in elements; each pointer is the field's first element.
struct SweepArgs {
    int P, N, R, K1, C;
    int node_stride;            // node rows of free (from the blob), nom,
                                // alloc
    int free_stride;            // rows of free (the override's or the blob's)
    int pod_f32_stride;         // pod rows of req
    int pod_i32_stride;         // pod rows of nominated_row
    const uint8_t* static_ok;   // [P, N] (K1)
    const float* free;          // [N, R]
    const float* nom;           // [N, R]
    const float* alloc;         // [N, R]
    const float* req;           // [P, R]
    const int* nominated_row;   // [P]
    const float* cumsum;        // [N, K1, C] contiguous
    const int* cols;            // [C]
    int* kmin;                  // [P, N]
};

// Measurement builds: -DSWEEP_EMPTY launches the same grid with no work
// (the grid's own floor); -DSWEEP_PROFILE stamps each warp's start, its
// passing of the CTA's barrier and its end (%globaltimer, ns) and its SM,
// for sweep_read_profile.
#define SWEEP_PROF_WARPS 16384
#ifdef SWEEP_PROFILE
__device__ unsigned long long sweep_prof_t[3 * SWEEP_PROF_WARPS];
__device__ unsigned sweep_prof_sm[SWEEP_PROF_WARPS];
#endif

__device__ __forceinline__ unsigned long long sweep_clock() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__device__ __forceinline__ long sweep_warp() {
    return ((long)blockIdx.y * gridDim.x + blockIdx.x)
           * (SWEEP_THREADS / 32) + threadIdx.x / 32;
}

template <int LANES>
__device__ __forceinline__ void sweep_body(const SweepArgs& S) {
    extern __shared__ unsigned smem[];
    constexpr int NODES = SWEEP_THREADS / LANES;
    const int R = S.R, C = S.C, K1 = S.K1;
    const int words = sweep_mask_words(R);
    unsigned* s_freed = smem;
    float* s_req = (float*)(smem + words);
    int* s_cols = (int*)(s_req + R);
    float* s_base = (float*)(s_cols + C);

    const int tid = threadIdx.x;
    const int p = blockIdx.y;
    const int g = tid / LANES;                 // group in the CTA
    const int gl = tid & (LANES - 1);          // lane in the group
    const int shift = (tid & 31) & ~(LANES - 1);   // the group's first lane
    const int n = blockIdx.x * NODES + g;
    const bool live = n < S.N;
    const long pn = (long)p * S.N + n;
    const float* fr = S.free + (long)n * S.free_stride;
    const float* nm = S.nom + (long)n * S.node_stride;
    const float* al = S.alloc + (long)n * S.node_stride;
    const float* cs = S.cumsum + (long)n * K1 * C;

    // one round of loads: the CTA's staging (the pod's own row, its
    // request, the columns) first, then the node's K1 byte, the lane's
    // columns and its prefix's first entries; no store waits on a load
    // until all are out. Past SWEEP_LANES lanes the columns and prefixes
    // wait for the K1 byte (a node that fails it loads neither)
    const float* req = S.req + (long)p * S.pod_f32_stride;
    const int own_row = S.nominated_row[(long)p * S.pod_i32_stride];
    const float q_st = tid < R ? req[tid] : 0.0f;
    const int col_st = tid < 32 && tid < C ? S.cols[tid] : -1;
    const bool ok = live && S.static_ok[pn];
    const bool load = LANES > SWEEP_LANES ? ok : live;
    float f[SWEEP_CHUNKS], m[SWEEP_CHUNKS], a[SWEEP_CHUNKS], pre[SWEEP_PRE];
#pragma unroll
    for (int j = 0; j < SWEEP_CHUNKS; ++j) {
        int r = gl + j * LANES;
        if (load && r < R) {
            f[j] = fr[r];
            m[j] = nm[r];
            a[j] = al[r];
        }
    }
#pragma unroll
    for (int c = 0; c < SWEEP_PRE; ++c)
        if (load && gl < K1 && c < C) pre[c] = cs[gl * C + c];
    if (tid < R) s_req[tid] = q_st;
    for (int r = tid + SWEEP_THREADS; r < R; r += SWEEP_THREADS)
        s_req[r] = req[r];
    if (tid < 32) {
        // the first warp: the columns, a lane a column, and the freed set,
        // a word at a time by one OR across the warp
        for (int c0 = 0; c0 < C; c0 += 32) {
            int c = c0 + tid;
            int col = c0 == 0 ? col_st : c < C ? S.cols[c] : -1;
            if (c < C) s_cols[c] = col;
            for (int w = 0; w < words; ++w) {
                unsigned bits = __reduce_or_sync(
                    0xffffffffu, col >= 0 && (col >> 5) == w
                                     ? 1u << (col & 31) : 0u);
                if (tid == 0) s_freed[w] = c0 == 0 ? bits : s_freed[w] | bits;
            }
        }
    }
    __syncthreads();
#ifdef SWEEP_PROFILE
    if ((tid & 31) == 0 && sweep_warp() < SWEEP_PROF_WARPS)
        sweep_prof_t[3 * sweep_warp() + 1] = sweep_clock();
#endif

    // the votes below take the whole warp (its groups together): a warp
    // whose groups passed different masks would run them one after another
    const unsigned low = LANES == 32 ? 0xffffffffu : (1u << LANES) - 1u;
    const unsigned mask = 0xffffffffu;
    int* out = S.kmin + pn;
    bool done = !ok;                   // past N, or NONE by K1
    if (live && !ok && gl == 0) *out = NONE;
    if (__all_sync(mask, done)) return;
    const bool own = n == own_row;
    float* base = s_base + g * R;

    // unresolvable (req > alloc anywhere) or a column no victim frees
    // that does not fit its base: NONE either way
    bool bad = false;
    if (!done) {
#pragma unroll
        for (int j = 0; j < SWEEP_CHUNKS; ++j) {
            int r = gl + j * LANES;
            if (r < R) {
                float q = s_req[r];
                bool freed = (s_freed[r >> 5] >> (r & 31)) & 1u;
                float b = f[j] - m[j];
                b = b + (own ? q : 0.0f);
                base[r] = b;
                bad |= (q > a[j]) || (!freed && !(q <= b));
            }
        }
        for (int r = gl + SWEEP_CHUNKS * LANES; r < R; r += LANES) {
            float q = s_req[r];
            bool freed = (s_freed[r >> 5] >> (r & 31)) & 1u;
            float b = fr[r] - nm[r];
            b = b + (own ? q : 0.0f);
            base[r] = b;
            bad |= (q > al[r]) || (!freed && !(q <= b));
        }
    }
    const unsigned votes = __ballot_sync(mask, bad);
    if (!done && ((votes >> shift) & low)) {
        if (gl == 0) *out = NONE;
        done = true;
    }
    if (__all_sync(mask, done)) return;
    __syncwarp(mask);

    // lanes over the prefixes: the first k whose every column fits
    for (int k0 = 0; k0 < K1; k0 += LANES) {
        int k = k0 + gl;
        bool fit = !done && k < K1;
        if (fit) {
            const float* row = cs + (long)k * C;
            if (k0 == 0) {
#pragma unroll
                for (int c = 0; c < SWEEP_PRE; ++c) {
                    if (c < C) {
                        int col = s_cols[c];
                        fit = fit && s_req[col] <= base[col] + pre[c];
                    }
                }
            }
            for (int c = k0 == 0 ? SWEEP_PRE : 0; c < C && fit; ++c) {
                int col = s_cols[c];
                fit = s_req[col] <= base[col] + row[c];
            }
        }
        const unsigned hit = (__ballot_sync(mask, fit) >> shift) & low;
        if (!done && hit) {
            if (gl == 0) *out = k0 + __ffs(hit) - 1;
            done = true;
        }
        if (__all_sync(mask, done)) return;
    }
    if (!done && gl == 0) *out = NONE;
}

template <int LANES>
__global__ void __launch_bounds__(SWEEP_THREADS)
preempt_sweep(SweepArgs S) {
#ifdef SWEEP_PROFILE
    const unsigned long long t0 = sweep_clock();
#endif
#ifndef SWEEP_EMPTY
    sweep_body<LANES>(S);
#endif
#ifdef SWEEP_PROFILE
    __syncwarp();
    const long w = sweep_warp();
    if ((threadIdx.x & 31) == 0 && w < SWEEP_PROF_WARPS) {
        unsigned sm;
        asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
        sweep_prof_t[3 * w] = t0;
        sweep_prof_t[3 * w + 2] = sweep_clock();
        sweep_prof_sm[w] = sm;
    }
#endif
}

#ifdef SWEEP_PROFILE
// the stamps of the last launch's first n warps (n <= SWEEP_PROF_WARPS:
// start, barrier, end), then cleared for the next
extern "C" int sweep_read_profile(unsigned long long* t, unsigned* sm,
                                  int n) {
    cudaError_t e = cudaMemcpyFromSymbol(t, sweep_prof_t, 24 * (size_t)n);
    if (e == cudaSuccess)
        e = cudaMemcpyFromSymbol(sm, sweep_prof_sm, 4 * (size_t)n);
    void* p;
    if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, sweep_prof_t);
    if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(sweep_prof_t));
    return (int)e;
}
#endif

template <int LANES>
static void sweep_run(const SweepArgs& S, const SweepPlan& L,
                      cudaStream_t stream) {
    dim3 grid((unsigned)L.ctas_x, (unsigned)S.P);
    preempt_sweep<LANES><<<grid, SWEEP_THREADS, L.smem, stream>>>(S);
}

extern "C" int preempt_sweep_launch(const SweepArgs* args, void* stream) {
    SweepArgs S = *args;
    SweepPlan L;
    if (!sweep_plan(S.P, S.N, S.R, S.K1, S.C, &L))
        return (int)cudaErrorInvalidValue;
    if ((long)S.P * S.N > 0) {
        cudaStream_t st = (cudaStream_t)stream;
        switch (L.lanes) {
        case 1: sweep_run<1>(S, L, st); break;
        case 2: sweep_run<2>(S, L, st); break;
        case 4: sweep_run<4>(S, L, st); break;
        case 8: sweep_run<8>(S, L, st); break;
        case 16: sweep_run<16>(S, L, st); break;
        case 32: sweep_run<32>(S, L, st); break;
        default: return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
