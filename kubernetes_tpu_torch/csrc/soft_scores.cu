// K4 soft_scores: one auction round's live soft topology scores.
//
// Replaces: kubernetes_tpu/models/pipeline.py `_soft_scores` (:439-532),
// which every round of the soft-score auction (`_rounds_commit` :535,
// round `body` :649) recomputes from the set of pods placed so far; its
// per-group static halves (`_soft_statics` :360) come from K5
// (topo_statics.cu) through the view in kernels/soft.py. The twin is
// kubernetes_tpu_torch/kernels/soft.py:soft_scores_ref.
//
// Two __global__ functions, launched in order on one stream after the
// host zeroed the domain maps:
//
// 1. soft_scatter: one thread per (pod b, group g, term t), t over the A
//    preferred affinity terms, the A preferred anti-affinity terms and the
//    C spread constraints of group g. A placed, valid pod y (group gy, on
//    node r) whose node carries a domain dy < D under the term's key adds
//    into the group's maps: for a preferred term, 1 into P_b[g, a, dy] when
//    gy's pods match g's term a (M[g, a, gy]) and 1 into P_j[g, a, dy] when
//    y is itself of group g (its own term); for a spread constraint, 1
//    into P_t[g, c, dy] when gy matches the constraint and node r is an
//    eligible commit target (el_node). atomicAdd of 1.0f: the counts are
//    integers below 2^24, exact in any order.
// 2. soft_gather: one thread per (group g, node n). It reads the node's
//    domain under each term's key from topo_dom (no [N, G, A] columns are
//    materialized) and gathers, masking a domain outside [0, D) to 0 as the
//    reference does:
//      ipa_live = ipa_raw + (pd(paff) - pd(panti)), where
//      pd = sum_a w[g, a] * P_b[g, a, nd] + sum_{g2, a} M[g2, a, g]
//           * w[g2, a] * P_j[g2, a, nd(g2, a)]
//    (integer weights times counts: exact in any order), and
//      sp_r = sum over c, left to right, of (match_static + P_t) * tpw
//             + (skew - 1) where the constraint is soft and the node has
//             its key; 0 on an ignored node.
//
// Both stages follow the auction's round flag: when *prog_in is 0 the
// round is a no-op, so the host can launch several rounds back to back.
//
// What bounds it on an H100: launch latency at the main path's sizes. The
// scatter reads a few words per (placed pod, group, term) and writes the
// maps (G x (4A + C) x D floats, L2 resident); the gather reads every
// node's topology row and the [G, N, C] statics once and writes two
// [G, N] floats: a few hundred KB to a few MB a round. The arithmetic is a
// few dozen operations per (group, node).
//
// Built with -fmad=false: sp_r's multiply and add round separately, as
// in the twin.

#include <cuda_runtime.h>
#include <stdint.h>

#define NONE (-1)
#define THREADS 256

// Mirrored by kernels/soft.py:_SoftArgs (same members, same order).
struct SoftArgs {
    int B, G, N, TK, A, C, D;
    const int* gid;              // [B]
    const uint8_t* valid;        // [B]
    const int* placed;           // [B] node row, -1 = unplaced
    const int* topo_dom;         // [N, TK]
    const int* paff_tk;          // [G, A]
    const int* panti_tk;         // [G, A]
    const int* tsc_tk;           // [G, C]
    const float* paff_w;         // [G, A]
    const float* panti_w;        // [G, A]
    const uint8_t* m_paff;       // [G, A, G]
    const uint8_t* m_panti;      // [G, A, G]
    const uint8_t* m_tsc;        // [G, C, G]
    const uint8_t* el_node;      // [G, N, C]
    const float* ipa_raw;        // [G, N]
    const float* match_static;   // [G, N, C]
    const float* tpw;            // [G, C]
    const float* skew;           // [G, C]
    const uint8_t* used_soft;    // [G, C]
    const uint8_t* dom_ok;       // [G, N, C]
    const uint8_t* ign;          // [G, N]
    const int* prog_in;
    float* maps;                 // [4, G, A, D]: paff P_b, P_j, panti P_b, P_j
    float* tmap;                 // [G, C, D]
    float* ipa_live;             // [G, N]
    float* sp_r;                 // [G, N]
};

// node n's domain under topology key column tk (NONE for an unused term)
__device__ __forceinline__ int dom_of(const SoftArgs& S, int n, int tk) {
    if (tk == NONE) return NONE;
    int c = tk < 0 ? 0 : (tk > S.TK - 1 ? S.TK - 1 : tk);
    return S.topo_dom[(size_t)n * S.TK + c];
}

__global__ void soft_scatter(SoftArgs S) {
    if (*S.prog_in == 0) return;
    int terms = 2 * S.A + S.C;
    long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long)S.B * S.G * terms) return;
    int t = (int)(idx % terms);
    long rest = idx / terms;
    int g = (int)(rest % S.G);
    int b = (int)(rest / S.G);
    int r = S.placed[b];
    if (r < 0 || !S.valid[b]) return;
    int gy = S.gid[b];
    if (t < 2 * S.A) {
        int kind = t / S.A;             // 0 paff, 1 panti
        int a = t % S.A;
        const int* tk = kind == 0 ? S.paff_tk : S.panti_tk;
        const uint8_t* m = kind == 0 ? S.m_paff : S.m_panti;
        int dy = dom_of(S, r, tk[g * S.A + a]);
        if (dy < 0 || dy >= S.D) return;
        size_t cell = ((size_t)g * S.A + a) * S.D + dy;
        size_t plane = (size_t)S.G * S.A * S.D;
        if (m[((size_t)g * S.A + a) * S.G + gy])
            atomicAdd(S.maps + (2 * kind) * plane + cell, 1.0f);
        if (gy == g)
            atomicAdd(S.maps + (2 * kind + 1) * plane + cell, 1.0f);
    } else {
        int c = t - 2 * S.A;
        int dy = dom_of(S, r, S.tsc_tk[g * S.C + c]);
        if (dy < 0 || dy >= S.D) return;
        if (S.m_tsc[((size_t)g * S.C + c) * S.G + gy]
                && S.el_node[((size_t)g * S.N + r) * S.C + c])
            atomicAdd(S.tmap + ((size_t)g * S.C + c) * S.D + dy, 1.0f);
    }
}

// pair_delta of one preferred-term kind at (group g, node n)
__device__ float pair_delta(const SoftArgs& S, int kind, int g, int n) {
    const int* tk = kind == 0 ? S.paff_tk : S.panti_tk;
    const float* w = kind == 0 ? S.paff_w : S.panti_w;
    const uint8_t* m = kind == 0 ? S.m_paff : S.m_panti;
    size_t plane = (size_t)S.G * S.A * S.D;
    const float* p_b = S.maps + (2 * kind) * plane;
    const float* p_j = S.maps + (2 * kind + 1) * plane;
    float db = 0.0f, dj = 0.0f;
    for (int a = 0; a < S.A; ++a) {
        int nd = dom_of(S, n, tk[g * S.A + a]);
        if (nd >= 0 && nd < S.D)
            db += p_b[((size_t)g * S.A + a) * S.D + nd] * w[g * S.A + a];
    }
    for (int g2 = 0; g2 < S.G; ++g2) {
        for (int a = 0; a < S.A; ++a) {
            if (!m[((size_t)g2 * S.A + a) * S.G + g]) continue;
            int nd = dom_of(S, n, tk[g2 * S.A + a]);
            if (nd >= 0 && nd < S.D)
                dj += w[g2 * S.A + a]
                      * p_j[((size_t)g2 * S.A + a) * S.D + nd];
        }
    }
    return db + dj;
}

__global__ void soft_gather(SoftArgs S) {
    if (*S.prog_in == 0) return;
    long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long)S.G * S.N) return;
    int g = (int)(idx / S.N);
    int n = (int)(idx % S.N);
    size_t gn = (size_t)g * S.N + n;
    S.ipa_live[gn] = S.ipa_raw[gn]
                     + (pair_delta(S, 0, g, n) - pair_delta(S, 1, g, n));
    float acc = 0.0f;
    for (int c = 0; c < S.C; ++c) {
        int gc = g * S.C + c;
        int nd = dom_of(S, n, S.tsc_tk[gc]);
        float gath = (nd >= 0 && nd < S.D)
                         ? S.tmap[(size_t)gc * S.D + nd] : 0.0f;
        float match = S.match_static[gn * S.C + c] + gath;
        float v = match * S.tpw[gc];
        v = v + (S.skew[gc] - 1.0f);
        if (!(S.used_soft[gc] && S.dom_ok[gn * S.C + c])) v = 0.0f;
        acc = c == 0 ? v : acc + v;
    }
    S.sp_r[gn] = S.ign[gn] ? 0.0f : acc;
}

extern "C" int soft_scores_launch(const SoftArgs* args, int stage,
                                  void* stream) {
    SoftArgs S = *args;
    if (S.C < 1 || S.D < 1 || S.G < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (stage == 0) {
        long total = (long)S.B * S.G * (2 * S.A + S.C);
        long blocks = (total + THREADS - 1) / THREADS;
        if (blocks > 0)
            soft_scatter<<<(unsigned)blocks, THREADS, 0, s>>>(S);
    } else {
        long blocks = ((long)S.G * S.N + THREADS - 1) / THREADS;
        soft_gather<<<(unsigned)blocks, THREADS, 0, s>>>(S);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
