// K6b preempt_feasible: the full-filter dry-run fold of one pod over every
// node, against a masked pod table and an overridden free matrix.
//
// Replaces: kubernetes_tpu/ops/preempt.py `preempt_feasible` (:115, jitted
// at :196), the exact per-node dry run of the reference's preemption
// (default_preemption.go:219: remove the victims, re-run every filter),
// for every node in one pass. The twin is
// kubernetes_tpu_torch/ops/preempt.py:preempt_feasible (through
// kernels/preempt.py:preempt_feasible_ref).
//
// The card path has three steps (kernels/preempt.py): K1 on the pod's row
// with every feature active (static_ok, the TaintToleration and
// NodeAffinity masks), K5's three stages over a copy of the table blob
// whose pod-valid column is ANDed with the victim mask, then this fold,
// one launch. K5's maps are exactly the reference's dry-run maps on the
// hard columns: its spread counts and domain-presence maps use, for a
// DoNotSchedule constraint, the eligibility over the hard constraints
// alone, which is what the dry run builds (`el_hard`); the fold reads no
// soft column.
//
// What it computes, for every node n:
//   ok = static_ok[n]
//     and (fit on) for every r: req[r] <= (free[n, r] - nom[n, r])
//                                + (n == nominated_row ? req[r] : 0)
//     and (spread on) for every hard constraint c in use: the node carries
//         the key (dom_ok) and (match_static[n, c] + self_match[c])
//         - min_cnt[c] <= maxSkew[c], where min_cnt[c] is the least count
//         over the domains present among the hard-eligible nodes (0 when
//         there is none), then 0 when minDomains is set and fewer domains
//         are present
//     and (inter-pod affinity on) anti_ok[n] and, when the pod has a
//         required affinity term, either every term has a matching pod in
//         the node's domain (term_static) or the first-pod rule holds: the
//         pod matches its own terms, no table pod matched any term, and
//         the node carries every term's key.
// Without topology (the twin's early return) only the first two lines are
// evaluated.
//
// Design: one launch, FOLD_THREADS threads a CTA, one warp a run of 32
// nodes. Each warp reads the pod's constraint and term slots at once (a
// lane each) into bit sets: the device decides whether a constraint needs
// its minimum (the host reads nothing), and every CTA decides alike. Each
// CTA then takes the minimum of every DoNotSchedule constraint in use over
// the D domains itself, before its nodes (a domain's flag and count read
// together, 4 domains a load; a min of integer-valued f32 and a count:
// exact in any order), and CTA 0 writes them to `min_cnt`. (Splitting the
// domains over a cluster of 8 CTAs, the partials merged through
// distributed shared memory, measured no faster: PERF.md §6.) The fit:
// each lane walks its own node's free and nominated rows, stopping at the
// first column that fails; a warp's rows are contiguous, and a lane's
// consecutive columns share a line. (Staging the warp's rows through
// shared memory, consecutive lanes on consecutive words, measured slower
// at R = 8 and at R = 74: PERF.md §6.) Only the constraints and terms in
// use are read, and a node reads nothing after its first failure. The
// pod's fields are read in place from its packed row (the launch's
// pointers point into the blob), and the nominated reservations from the
// node blob at its row stride.
//
// Built with -fmad=false; every f32 operation repeats the twin's operands
// in the twin's order and the output is a bool: card and twin agree
// exactly.
//
// What bounds it on an H100: launch latency. Over N = 8,192 nodes it reads
// at most two [N, R] matrices, a few bytes of statics per (node, term) and
// C x D counts, under 1 MB, and writes N bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NONE (-1)
#define FOLD_THREADS 256   // a CTA: 8 warps, a run of 32 nodes each
#define FOLD_C_MAX 64      // spread constraints (and affinity terms) a launch
#define FULL 0xffffffffu

// Mirrored by kernels/preempt.py:_FoldArgs (same members, same order).
struct FoldArgs {
    int N, R, C, A, D;
    int fit_on, topo, spread_on, ipa_on;
    int nom_stride;              // floats from one node's nom row to the next
    const uint8_t* static_ok;    // [N]      K1
    const float* free;           // [N, R]
    const float* nom;            // [N] rows of nom_stride floats, R read
    const float* req;            // [R]      the pod's packed rows from here
    const int* nominated_row;    // [1]
    const int* tsc_tk;           // [C]
    const int* tsc_hard;         // [C] 0 / 1
    const int* max_skew;         // [C]
    const int* min_domains;      // [C]
    const int* aff_tk;           // [A]
    const int* aff_self;         // [1] 0 / 1
    const float* self_match;     // [C]      K5 from here
    const float* cnt;            // [C, D]
    const uint8_t* exists_hard;  // [C, D]
    const float* match_static;   // [N, C]
    const uint8_t* dom_ok;       // [N, C]
    const uint8_t* any_match;    // [1]
    const uint8_t* anti_ok;      // [N]
    const uint8_t* term_static;  // [N, A]
    const uint8_t* has_lbl;      // [N, A]
    float* min_cnt;              // [C] the minima the launch took
    uint8_t* out;                // [N]
};

// CTAs of the launch: a run of 32 nodes a warp
__host__ __device__ inline int fold_ctas(int N) {
    return (N + FOLD_THREADS - 1) / FOLD_THREADS;
}

__device__ __forceinline__ float warp_minf(float v) {
    for (int o = 16; o > 0; o >>= 1)
        v = fminf(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

__device__ __forceinline__ int warp_sumi(int v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

// bits of slots [0, k) for which `f(i)` holds, lane-parallel (k <= 64);
// every lane of the warp calls it
template <typename F>
__device__ __forceinline__ unsigned long long slot_bits(int k, F f) {
    const int lane = threadIdx.x & 31;
    const unsigned lo = __ballot_sync(FULL, lane < k && f(lane));
    const unsigned hi = __ballot_sync(FULL, lane + 32 < k && f(lane + 32));
    return (unsigned long long)hi << 32 | lo;
}

// the least count over the D domains present among the hard-eligible
// nodes of constraint row (ex, ct), and how many are present: 4 domains'
// flags and counts a pair of loads, a thread's loads issued together (8
// pairs at D = 8,192; no load waits on another); a min of integer-valued
// f32 and a count, exact in any order
__device__ __forceinline__ void row_min(const uint8_t* ex, const float* ct,
                                        int D, float& m, int& num) {
    const int tid = threadIdx.x;
    int head = 0;
    if ((reinterpret_cast<uintptr_t>(ex) & 3) == 0
            && (reinterpret_cast<uintptr_t>(ct) & 15) == 0) {
        const unsigned* e4 = reinterpret_cast<const unsigned*>(ex);
        const float4* c4 = reinterpret_cast<const float4*>(ct);
#pragma unroll 8
        for (int k = tid; k < D / 4; k += blockDim.x) {
            const unsigned e = __ldg(e4 + k);
            const float4 v = __ldg(c4 + k);
            const float c[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int u = 0; u < 4; ++u)
                if ((e >> (8 * u)) & 0xffu) {
                    m = fminf(m, c[u]);
                    num += 1;
                }
        }
        head = D & ~3;
    }
    for (int d = head + tid; d < D; d += blockDim.x)
        if (ex[d]) {
            m = fminf(m, ct[d]);
            num += 1;
        }
}

__global__ void __launch_bounds__(FOLD_THREADS)
feasible_fold(FoldArgs S) {
    __shared__ float s_fin[FOLD_C_MAX];      // the minima the fold reads
    __shared__ float s_wm[FOLD_THREADS / 32][FOLD_C_MAX];
    __shared__ int s_wn[FOLD_THREADS / 32][FOLD_C_MAX];
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int n = blockIdx.x * FOLD_THREADS + w * 32 + lane;
    bool ok = n < S.N && S.static_ok[n] != 0;
    // the pod's DoNotSchedule constraints and affinity terms in use and
    // its first-pod flag, a warp's lanes reading the slots at once (every
    // warp and CTA alike)
    const bool spread = S.topo && S.spread_on, ipa = S.topo && S.ipa_on;
    const int aff_self = ipa ? S.aff_self[0] : 0;
    const int any_match = ipa ? S.any_match[0] : 1;
    const unsigned long long used = slot_bits(S.C, [&](int c) {
        return spread && S.tsc_tk[c] != NONE && S.tsc_hard[c] != 0;
    });
    const unsigned long long terms = slot_bits(S.A, [&](int a) {
        return ipa && S.aff_tk[a] != NONE;
    });
    const bool self = aff_self != 0 && !any_match;

    // the spread minima of the DoNotSchedule constraints in use, each CTA
    // its own copy before its nodes (C x D reads from L2, every warp's
    // partials folded in warp order; none when no constraint is in use)
    if (used) {
        for (unsigned long long u = used; u; u &= u - 1) {
            const int c = __ffsll((long long)u) - 1;
            float m = INFINITY;
            int num = 0;
            row_min(S.exists_hard + (long)c * S.D, S.cnt + (long)c * S.D,
                    S.D, m, num);
            m = warp_minf(m);
            num = warp_sumi(num);
            if (lane == 0) {
                s_wm[w][c] = m;
                s_wn[w][c] = num;
            }
        }
        __syncthreads();
        if (tid < S.C && ((used >> tid) & 1ull)) {
            float m = INFINITY;
            int num = 0;
            for (int k = 0; k < FOLD_THREADS / 32; ++k) {
                m = fminf(m, s_wm[k][tid]);
                num += s_wn[k][tid];
            }
            float mc = isinf(m) ? 0.0f : m;
            const int md = S.min_domains[tid];
            if (md > 0 && num < md) mc = 0.0f;
            s_fin[tid] = mc;
        }
        __syncthreads();
    }
    if (blockIdx.x == 0)
        for (int c = tid; c < S.C; c += blockDim.x)
            S.min_cnt[c] = ((used >> c) & 1ull) ? s_fin[c] : 0.0f;

    if (S.fit_on) {
        // each lane walks its own node's rows
        const bool own = n == S.nominated_row[0];
        for (int k = 0; k < S.R && ok; ++k) {
            const float q = __ldg(S.req + k);
            float eff = S.free[(long)n * S.R + k]
                        - S.nom[(long)n * S.nom_stride + k];
            eff = eff + (own ? q : 0.0f);
            ok = q <= eff;
        }
    }
    if (ok && used) {
        for (unsigned long long u = used; u && ok; u &= u - 1) {
            const int c = __ffsll((long long)u) - 1;
            const long i = (long)n * S.C + c;
            float skew = S.match_static[i] + S.self_match[c];
            skew = skew - s_fin[c];
            ok = S.dom_ok[i] && skew <= (float)S.max_skew[c];
        }
    }
    if (ok && S.topo && S.ipa_on) {
        bool exist = true, all_lbl = true;
        for (unsigned long long u = terms; u; u &= u - 1) {
            const int a = __ffsll((long long)u) - 1;
            const long i = (long)n * S.A + a;
            exist = exist && S.term_static[i];
            all_lbl = all_lbl && S.has_lbl[i];
        }
        const bool aff_ok = terms ? (exist || (self && all_lbl)) : true;
        ok = S.anti_ok[n] && aff_ok;
    }
    if (n < S.N) S.out[n] = ok ? 1 : 0;
}

// the fold of one dry run: one launch (kernels/preempt.py FoldLaunch.run);
// a shape out of range is an error
extern "C" int preempt_feasible_launch(const FoldArgs* args, void* stream) {
    FoldArgs S = *args;
    if (S.N < 1 || S.R < 1 || S.C < 0 || S.C > FOLD_C_MAX || S.A < 0
            || S.A > FOLD_C_MAX || S.nom_stride < S.R
            || (S.topo && S.D < 1))
        return (int)cudaErrorInvalidValue;
    feasible_fold<<<fold_ctas(S.N), FOLD_THREADS, 0, (cudaStream_t)stream>>>(
        S);
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
