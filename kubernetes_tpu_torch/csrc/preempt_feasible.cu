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
// whose pod-valid column is ANDed with the victim mask, then this fold.
// K5's maps are exactly the reference's dry-run maps on the hard columns:
// its spread counts and domain-presence maps use, for a DoNotSchedule
// constraint, the eligibility over the hard constraints alone, which is
// what the dry run builds (`el_hard`); the fold reads no soft column.
//
// Two __global__ functions, each a stage of the C entry, launched in order
// on one stream and counted apart by the wrapper:
//
// 1. feasible_min: one block per spread constraint c, launched only when
//    the pod's spread filter runs and the pod has a DoNotSchedule
//    constraint in use (the fold reads min_cnt for no other); a block
//    whose constraint is unused or soft returns at once.
//    min_cnt[c] = the least count over the domains
//    present among the hard-eligible nodes (0 when there is none), then 0
//    when minDomains is set and fewer domains are present. A min of
//    integers held in f32: exact in any order.
// 2. feasible_fold: one thread per node n:
//      ok = static_ok[n]
//        and (fit on) for every r: req[r] <= (free[n, r] - nom[n, r])
//                                   + (n == nominated_row ? req[r] : 0)
//        and (spread on) for every hard constraint c in use: the node
//            carries the key (dom_ok) and (match_static[n, c]
//            + self_match[c]) - min_cnt[c] <= maxSkew[c]
//        and (inter-pod affinity on) anti_ok[n] and, when the pod has a
//            required affinity term, either every term has a matching pod
//            in the node's domain (term_static) or the first-pod rule
//            holds: the pod matches its own terms, no table pod matched
//            any term, and the node carries every term's key.
//    Without topology (the twin's early return) only the first two lines
//    are evaluated.
//
// Built with -fmad=false; every f32 operation repeats the twin's operands
// in the twin's order and the output is a bool: card and twin agree
// exactly.
//
// What bounds it on an H100: launch latency. Over N = 8,192 nodes it reads
// at most two [N, R] matrices and a few bytes of statics per (node, term),
// under 1 MB, and writes N bytes; a node that fails an earlier check reads
// nothing of the later ones, and only the constraints and terms in use are
// read.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NONE (-1)
#define THREADS 256

// Mirrored by kernels/preempt.py:_FoldArgs (same members, same order).
struct FoldArgs {
    int N, R, C, A, D;
    int fit_on, topo, spread_on, ipa_on;
    const uint8_t* static_ok;    // [N]
    const float* free;           // [N, R]
    const float* nom;            // [N, R]
    const float* req;            // [R]
    const int* nominated_row;    // [1]
    const int* tsc_tk;           // [C]
    const uint8_t* tsc_hard;     // [C]
    const int* max_skew;         // [C]
    const int* min_domains;      // [C]
    const float* self_match;     // [C]
    const float* cnt;            // [C, D]
    const uint8_t* exists_hard;  // [C, D]
    const float* match_static;   // [N, C]
    const uint8_t* dom_ok;       // [N, C]
    const int* aff_tk;           // [A]
    const uint8_t* aff_self;     // [1]
    const uint8_t* any_match;    // [1]
    const uint8_t* anti_ok;      // [N]
    const uint8_t* term_static;  // [N, A]
    const uint8_t* has_lbl;      // [N, A]
    float* min_cnt;              // [C] (written by feasible_min)
    uint8_t* out;                // [N]
};

__global__ void feasible_min(FoldArgs S) {
    __shared__ float s_min[THREADS];
    __shared__ int s_num[THREADS];
    int c = blockIdx.x;
    if (S.tsc_tk[c] == NONE || !S.tsc_hard[c]) return;
    float m = INFINITY;
    int num = 0;
    for (int d = threadIdx.x; d < S.D; d += blockDim.x) {
        long i = (long)c * S.D + d;
        if (S.exists_hard[i]) {
            m = fminf(m, S.cnt[i]);
            num += 1;
        }
    }
    s_min[threadIdx.x] = m;
    s_num[threadIdx.x] = num;
    __syncthreads();
    for (int step = blockDim.x / 2; step > 0; step >>= 1) {
        if (threadIdx.x < step) {
            s_min[threadIdx.x] = fminf(s_min[threadIdx.x],
                                       s_min[threadIdx.x + step]);
            s_num[threadIdx.x] += s_num[threadIdx.x + step];
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        float mc = isinf(s_min[0]) ? 0.0f : s_min[0];
        int md = S.min_domains[c];
        if (md > 0 && s_num[0] < md) mc = 0.0f;
        S.min_cnt[c] = mc;
    }
}

__global__ void feasible_fold(FoldArgs S) {
    int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= S.N) return;
    bool ok = S.static_ok[n] != 0;
    if (ok && S.fit_on) {
        bool own = n == S.nominated_row[0];
        const float* fr = S.free + (long)n * S.R;
        const float* nm = S.nom + (long)n * S.R;
        for (int r = 0; r < S.R && ok; ++r) {
            float eff = fr[r] - nm[r];
            eff = eff + (own ? S.req[r] : 0.0f);
            ok = S.req[r] <= eff;
        }
    }
    if (ok && S.topo && S.spread_on) {
        for (int c = 0; c < S.C && ok; ++c) {
            if (S.tsc_tk[c] == NONE || !S.tsc_hard[c]) continue;
            long i = (long)n * S.C + c;
            float skew = S.match_static[i] + S.self_match[c];
            skew = skew - S.min_cnt[c];
            ok = S.dom_ok[i] && skew <= (float)S.max_skew[c];
        }
    }
    if (ok && S.topo && S.ipa_on) {
        bool any_used = false, exist = true, all_lbl = true;
        for (int a = 0; a < S.A; ++a) {
            if (S.aff_tk[a] == NONE) continue;
            any_used = true;
            long i = (long)n * S.A + a;
            exist = exist && S.term_static[i];
            all_lbl = all_lbl && S.has_lbl[i];
        }
        bool self_ok = S.aff_self[0] && !S.any_match[0] && all_lbl;
        bool aff_ok = any_used ? (exist || self_ok) : true;
        ok = S.anti_ok[n] && aff_ok;
    }
    S.out[n] = ok ? 1 : 0;
}

// stage 0: feasible_min, stage 1: feasible_fold (the launch counters
// kernels/preempt.py:FOLD_STAGES)
extern "C" int preempt_feasible_launch(const FoldArgs* args, int stage,
                                       void* stream) {
    FoldArgs S = *args;
    cudaStream_t s = (cudaStream_t)stream;
    if (S.N < 1 || S.R < 1) return (int)cudaErrorInvalidValue;
    if (stage == 0) {
        if (!S.topo || !S.spread_on || S.C < 1 || S.D < 1)
            return (int)cudaErrorInvalidValue;
        feasible_min<<<S.C, THREADS, 0, s>>>(S);
    } else if (stage == 1) {
        feasible_fold<<<(S.N + THREADS - 1) / THREADS, THREADS, 0, s>>>(S);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
