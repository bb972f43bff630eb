// K3 serial_scan: the as-if-serial commit scan of one launch.
//
// Replaces: kubernetes_tpu/models/pipeline.py schedule_batch's serial
// path: `perturb_rows` (:1181), `port_conf` (:1186, ops/filters.py
// pod_pair_port_conflict :167), `queries` (:1193), `map_updates` (:1291),
// `body` (:1358, the hard-topology and no-topology branches) and the
// `lax.scan` over the batch (:1571). The twin is
// kubernetes_tpu_torch/kernels/scan.py:serial_scan_ref.
//
// Design: one cooperative launch per batch (cudaLaunchCooperativeKernel,
// grid.sync()), grid = min(SMs x occupancy, ceil(N / threads)) blocks;
// block k owns a contiguous slice of the nodes. Step b (pod b) runs three
// grid-wide phases:
//
//   A. For its nodes each block evaluates feasible = static_ok & ports_ok &
//      fit_ok & spread_ok & ipa_ok against the live state, as `queries` and
//      `body` do, and reduces its share of the normalizer statistics (max
//      taint and affinity raw scores, min/max live ipa score over feasible
//      nodes, min/max spread raw score over feasible non-ignored nodes),
//      of the feasible count and of the four first-fail reject counts
//      (NodePorts in batch, Fit, Spread, InterPod), and writes them per
//      block. The spread minimum over a constraint's domains (domain
//      space, [C, D]) is a block-wide reduction that every block repeats
//      on the same data.
//   B. After grid.sync(), every block folds the per-block partials in the
//      same fixed order, forms the total of each of its feasible nodes in
//      the reference's operation order, and writes its best (total, tie
//      perturbation, -node).
//   C. After grid.sync(), every block folds the block bests to the winner
//      with K2's tie rule (highest total, then highest tie_perturb, then
//      lowest node; a NaN total makes the reference pick node 0). Block 0
//      writes the pod's outputs; the block owning the winner commits
//      free/nzr; every block folds the commit into the node-space carry
//      maps of its own nodes (forbid1, map2, pres, wscore, cnt_match);
//      block 0 updates the domain-space ones (any3, cntmap). A final
//      grid.sync() precedes step b + 1.
//
// The percentageOfNodesToScore window (`body`'s pct_nodes branch,
// :1418-1450; ScanArgs.pct != 0): phase A first counts each block's
// feasible nodes at or after the start row and before it, and its reject
// counts (over the whole cluster, untruncated); after a grid.sync() every
// block folds those counts in rotated order from the start row to its
// offsets, ranks its feasible nodes with a block scan, keeps the first
// k_find of the rotation and reduces the normalizer statistics over the
// kept ones; the thread holding the k_find-th feasible node writes the
// next start row. In phase C block 0 snaps that row to the next valid
// one, in rotated order. k_find = max(100, valid * pct / 100), the
// percent adaptive (max(5, 50 - valid / 125)) when pct is -1.
//
// In-batch hostPort clashes: a pre-pass fills port_conf [B, B] (wildcard
// IP semantics of types.go:1291); at step b each block marks, in shared
// memory, the nodes of its slice that hold an earlier committed pod j
// with port_conf[b, j] — O(b) per step.
//
// The learned score term (K9, learned_mlp.cuh; `learned.n_layers` > 0):
// every block stages the scorer's parameters into the front of its
// dynamic shared memory once, at the start of the launch, and phase B
// adds w_learned * learned_term(...) to each total after w_ipa * ipa
// (:1458-1474), with that step's (windowed) normalizers; its spread and
// ipa features are the normalized spread and ipa scores (0 on a
// no-topology launch).
//
// Exactness: every max / min is exact in any order; counts are integers;
// the carry updates add integers (weights <= 100, hardPodAffinityWeight
// 1), far below 2^24; the score uses the twin's operations in the same
// order (built with -fmad=false; true divisions, never a reciprocal).
// Bool carries are kept as bytes.
//
// What bounds it on an H100: the latency of each step, not bytes or
// operations. The inputs are a few MB, read once into L2, and a step does
// ~40 operations a node; but step b + 1 waits on step b's commit. Of that
// latency the three grid barriers are the smaller part: grid_sync_probe
// below, timed by chip_smoke.py (phase 8c; H100 80GB HBM3, 700 W), runs
// 6,144 of them on this grid in ~6.8 ms, 11-14 % of a 2,048-pod launch.
// The rest is each step's serial work inside the phases (block
// reductions, thread 0 folding the per-block partials and bests, the
// domain-space spread minimum). Carries resident in shared memory of a
// thread-block cluster, synchronised by cluster barriers, are the later
// performance design.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "learned_mlp.cuh"

namespace cg = cooperative_groups;

#define THREADS 256
#define NONE (-1)
#define MAX_R 32
#define MAX_SHAPE 16
#define MAX_C 16
#define MAX_TK 32
#define NPT_MAX 8       // nodes per thread
#define RF 6            // float partials: max t, max a, min/max ipa,
                        // min/max sp
#define RI 7            // int partials: feasible, ports, fit, spread, ipa,
                        // pct window: feasible at/after start, before it
#define NWARPS (THREADS / 32)
#define ADAPTIVE_PCT (-1)
#define MIN_FEASIBLE_NODES_TO_FIND 100
#define FIT_LEAST 0
#define FIT_MOST 1
#define FIT_RTCR 2
#define NO_NODE 0x7fffffff

// Mirrored by kernels/scan.py:_ScanArgs (same members, same order).
struct ScanArgs {
    int N, B, R, G1, G, A, C, TK, D, HP;
    int topo, spread_on, ipa_on, fit_on, ports, wildcard_ip, fit_strategy,
        shape_n, pct;
    float weights[7];
    float shape_x[MAX_SHAPE], shape_y[MAX_SHAPE];
    unsigned int seed;
    float* free;               // [N, R] updated in place
    float* nzr;                // [N, 2] updated in place
    const float* nom;          // [N, R]
    const float* alloc2;       // [N, 2]
    const float* req;          // [B, R]
    const float* nzreq;        // [B, 2]
    const int* nominated_row;  // [B]
    const int* uid;            // [B]
    const int* g1;             // [B] phase-1 row
    const uint8_t* static_ok;  // [G1, N]
    const float* taint_raw;    // [G1, N]
    const float* aff_raw;      // [G1, N]
    const float* img;          // [G1, N]
    const int* hp_port;        // [B, HP]
    const int* hp_proto;       // [B, HP]
    const int* hp_ip;          // [B, HP]
    // topology launch only (K5's outputs and the groups' terms)
    const int* gid;            // [B]
    const int* topo_dom;       // [N, TK]
    const float* t_cnt;        // [G, C, D]
    const uint8_t* t_any_match;  // [G]
    const uint8_t* anti_ok;    // [G, N]
    const float* ipa_raw;      // [G, N]
    const uint8_t* term_static;  // [G, N, A]
    const uint8_t* has_lbl;    // [G, N, A]
    const uint8_t* ign;        // [G, N]
    const uint8_t* el_node;    // [G, N, C]
    const float* match_static;  // [G, N, C]
    const uint8_t* dom_ok;     // [G, N, C]
    const uint8_t* exists_hard;  // [G, C, D]
    const uint8_t* m_terms;    // [4, G, A, G]: anti, aff, paff, panti
    const uint8_t* m_tsc;      // [G, C, G]
    const float* tpw;          // [G, C]
    const float* self_match;   // [G, C]
    const int* num_domains;    // [G, C]
    const uint8_t* has_soft;   // [G]
    const int* anti_tk;        // [G, A]
    const int* aff_tk;         // [G, A]
    const int* paff_tk;        // [G, A]
    const int* panti_tk;       // [G, A]
    const float* paff_w;       // [G, A]
    const float* panti_w;      // [G, A]
    const int* tsc_tk;         // [G, C]
    const uint8_t* tsc_hard;   // [G, C]
    const int* tsc_skew;       // [G, C]
    const int* tsc_mind;       // [G, C]
    const uint8_t* aff_self;   // [G]
    // carries (zeroed by the wrapper)
    uint8_t* forbid1;          // [G, N]
    uint8_t* map2;             // [G, N]
    uint8_t* pres;             // [G, A, N]
    uint8_t* any3;             // [G]
    float* wscore;             // [G, N]
    float* cntmap;             // [G, C, D]
    float* cnt_match;          // [G, C, N]
    // scratch
    uint8_t* port_conf;        // [B, B]
    int* committed;            // [B]
    float* part_f;             // [blocks, 8]
    int* part_i;               // [blocks, 8]
    float* best_f;             // [blocks, 2]
    int* best_i;               // [blocks, 2]
    float* total0;             // [1] the total at node 0
    // outputs
    int* rows;                 // [B]
    float* win;                // [B]
    int* feas;                 // [B]
    int* rejects;              // [B, 4]
    // percentageOfNodesToScore window (pct != 0 only)
    const uint8_t* node_valid;  // [N]
    int* pct_start;            // [1] start row, updated in place
    int* pct_next;             // [1] scratch: the unsnapped next start
    // the learned score term (n_layers 0: none)
    LearnedNet learned;
    float w_learned;
};

// ---------------------------------------------------------------- scores

__device__ float interp(const ScanArgs& S, float x) {
    int k = S.shape_n;
    int i = 0;
    while (i < k && S.shape_x[i] <= x) ++i;  // searchsorted side='right'
    i = i < 1 ? 1 : (i > k - 1 ? k - 1 : i);
    float df = S.shape_y[i] - S.shape_y[i - 1];
    float dx = S.shape_x[i] - S.shape_x[i - 1];
    float delta = x - S.shape_x[i - 1];
    bool dx0 = fabsf(dx) <= 1.4210855e-14f;  // np.spacing(eps(float32))
    float f = dx0 ? S.shape_y[i - 1]
                  : S.shape_y[i - 1] + (delta / dx) * df;
    if (x < S.shape_x[0]) f = S.shape_y[0];
    if (x > S.shape_x[k - 1]) f = S.shape_y[k - 1];
    return f;
}

__device__ __forceinline__ float frac_of(float req, float a) {
    float f = a > 0.0f ? req / fmaxf(a, 1e-9f) : 1.0f;
    return fminf(fmaxf(f, 0.0f), 1.0f);
}

// pipeline.tie_perturb in native uint32
__device__ __forceinline__ float tie_perturb(unsigned int uid, int n,
                                             unsigned int seed) {
    unsigned int x = (unsigned int)n * 2654435761u;
    x = x ^ (uid * 40503u);
    x = x ^ (seed * 2654435761u);
    x = (x ^ (x >> 15)) * 2246822519u;
    x = x ^ (x >> 13);
    return (float)(x >> 8) / 16777216.0f;
}

__device__ __forceinline__ bool better(float s, float p, int i, float bs,
                                       float bp, int bi) {
    if (bi == NO_NODE) return true;
    if (s != bs) return s > bs;
    if (p != bp) return p > bp;
    return i < bi;
}

// the normalizers of one step, folded from the block partials
struct Norms {
    float top_t, scale_a, ipa_mn, ipa_diff, sp_mn, sp_mx;
    bool ipa_ok, sp_ok, soft;
};

// the weighted total of pod b on node n, in the reference's order; `lp`
// is the block's shared copy of the learned scorer's parameters
__device__ float total_at(const ScanArgs& S, const Norms& M, int b, int g1,
                          int n, float ipa_live, float sp_r, bool ign,
                          const float* lp) {
    float a0 = S.alloc2[2 * n], a1 = S.alloc2[2 * n + 1];
    float f0 = frac_of(S.nzr[2 * n] + S.nzreq[2 * b], a0);
    float f1 = frac_of(S.nzr[2 * n + 1] + S.nzreq[2 * b + 1], a1);
    float fit;
    if (S.fit_strategy == FIT_MOST) {
        fit = ((f0 + f1) / 2.0f) * 100.0f;
    } else if (S.fit_strategy == FIT_RTCR) {
        fit = (interp(S, f0) + interp(S, f1)) / 2.0f;
    } else {
        fit = (((1.0f - f0) + (1.0f - f1)) / 2.0f) * 100.0f;
    }
    float mean = (f0 + f1) / 2.0f;
    float d0 = f0 - mean, d1 = f1 - mean;
    float bal = (1.0f - sqrtf((d0 * d0 + d1 * d1) / 2.0f)) * 100.0f;
    size_t o = (size_t)g1 * S.N + n;
    float taint = (1.0f - S.taint_raw[o] / M.top_t) * 100.0f;
    float aff = S.aff_raw[o] * M.scale_a;
    float ipa = M.ipa_ok ? (100.0f * (ipa_live - M.ipa_mn)) / M.ipa_diff
                         : 0.0f;
    float spread = 0.0f;
    if (M.soft && !ign)
        spread = M.sp_ok ? (100.0f * ((M.sp_mx + M.sp_mn) - sp_r)) / M.sp_mx
                         : 100.0f;
    const float* w = S.weights;
    float t = w[0] * taint;
    t = t + w[1] * aff;
    t = t + w[2] * fit;
    t = t + w[3] * bal;
    t = t + w[4] * S.img[o];
    t = t + w[5] * spread;
    t = t + w[6] * ipa;
    if (S.learned.n_layers > 0)
        t = t + S.w_learned * learned_term(lp, S.learned, f0, f1, fit, bal,
                                           taint, aff, S.img[o], spread, ipa);
    return t;
}

// ---------------------------------------------------------------- topology

__device__ __forceinline__ int m_term(const ScanArgs& S, int k, int x, int a,
                                      int y) {
    return S.m_terms[(((size_t)k * S.G + x) * S.A + a) * S.G + y];
}

// per-step verdicts of a group-g pod on node n (pipeline.py queries)
__device__ void queries(const ScanArgs& S, int g, int n, const float* min_cnt,
                        bool* ipa_ok, bool* sp_ok, float* sp_r,
                        float* ipa_live) {
    size_t gn = (size_t)g * S.N + n;
    bool any_used = false, pods_exist = true, all_lbl = true;
    for (int a = 0; a < S.A; ++a) {
        if (S.aff_tk[g * S.A + a] == NONE) continue;
        any_used = true;
        bool term_ok = S.term_static[gn * S.A + a]
                       || S.pres[((size_t)g * S.A + a) * S.N + n];
        if (!term_ok) pods_exist = false;
        if (!S.has_lbl[gn * S.A + a]) all_lbl = false;
    }
    bool any_match = S.t_any_match[g] || S.any3[g];
    bool self_ok = S.aff_self[g] && !any_match && all_lbl;
    bool aff_ok = any_used ? (pods_exist || self_ok) : true;
    *ipa_ok = S.anti_ok[gn] && !S.forbid1[gn] && !S.map2[gn] && aff_ok;
    bool ok = true;
    float acc = 0.0f;
    for (int c = 0; c < S.C; ++c) {
        int gc = g * S.C + c;
        bool used = S.tsc_tk[gc] != NONE;
        bool hard = S.tsc_hard[gc] != 0;
        size_t o = gn * S.C + c;
        float match_num = S.match_static[o]
                          + S.cnt_match[(size_t)gc * S.N + n];
        float max_skew = (float)S.tsc_skew[gc];
        if (used && hard) {
            float skew = (match_num + S.self_match[gc]) - min_cnt[c];
            if (!(S.dom_ok[o] && skew <= max_skew)) ok = false;
        }
        float per_c = (used && !hard && S.dom_ok[o])
                          ? match_num * S.tpw[gc] + (max_skew - 1.0f)
                          : 0.0f;
        acc = c == 0 ? per_c : acc + per_c;
    }
    *sp_ok = ok;
    *sp_r = S.ign[gn] ? 0.0f : acc;
    *ipa_live = S.ipa_raw[gn] + S.wscore[gn];
}

// does node n share the committed node's domain under key tk?
__device__ __forceinline__ bool same_dom(const int* dn, const int* dom_row,
                                         int tk) {
    if (tk == NONE) return false;
    int d = dom_row[tk];
    return d != NONE && dn[tk] == d;
}

// fold the commit of a group-g pod on node r into node n's carries
// (pipeline.py map_updates, node-space part)
__device__ void map_updates_node(const ScanArgs& S, int g, int r, int n,
                                 const int* dom_row) {
    const int* dn = S.topo_dom + (size_t)n * S.TK;
    for (int gp = 0; gp < S.G; ++gp) {
        size_t gpn = (size_t)gp * S.N + n;
        bool f1 = false, f2 = false;
        float j = 0.0f, bs = 0.0f;
        for (int a = 0; a < S.A; ++a) {
            int ga = g * S.A + a, pa = gp * S.A + a;
            // the committed pod's own terms (j side)
            if (m_term(S, 0, g, a, gp) && same_dom(dn, dom_row, S.anti_tk[ga]))
                f1 = true;
            if (m_term(S, 1, g, a, gp) && same_dom(dn, dom_row, S.aff_tk[ga]))
                j = j + 1.0f;
            if (m_term(S, 2, g, a, gp)
                    && same_dom(dn, dom_row, S.paff_tk[ga]))
                j = j + S.paff_w[ga];
            if (m_term(S, 3, g, a, gp)
                    && same_dom(dn, dom_row, S.panti_tk[ga]))
                j = j - S.panti_w[ga];
            // each group's own terms vs the committed pod (b side)
            if (m_term(S, 0, gp, a, g)
                    && same_dom(dn, dom_row, S.anti_tk[pa]))
                f2 = true;
            if (m_term(S, 1, gp, a, g)
                    && same_dom(dn, dom_row, S.aff_tk[pa]))
                S.pres[((size_t)gp * S.A + a) * S.N + n] = 1;
            if (m_term(S, 2, gp, a, g)
                    && same_dom(dn, dom_row, S.paff_tk[pa]))
                bs = bs + S.paff_w[pa];
            if (m_term(S, 3, gp, a, g)
                    && same_dom(dn, dom_row, S.panti_tk[pa]))
                bs = bs - S.panti_w[pa];
        }
        if (f1) S.forbid1[gpn] = 1;
        if (f2) S.map2[gpn] = 1;
        // integer-valued: exact in any grouping
        S.wscore[gpn] = S.wscore[gpn] + (j + bs);
        for (int c = 0; c < S.C; ++c) {
            int gc = gp * S.C + c;
            bool hits = S.m_tsc[((size_t)gp * S.C + c) * S.G + g]
                        && S.el_node[((size_t)gp * S.N + r) * S.C + c];
            if (hits && same_dom(dn, dom_row, S.tsc_tk[gc]))
                S.cnt_match[(size_t)gc * S.N + n] += 1.0f;
        }
    }
}

// the domain-space part of map_updates for group gp
__device__ void map_updates_domains(const ScanArgs& S, int g, int r, int gp,
                                    const int* dom_row) {
    for (int a = 0; a < S.A; ++a) {
        int tk = S.aff_tk[gp * S.A + a];
        if (tk != NONE && dom_row[tk] != NONE && m_term(S, 1, gp, a, g))
            S.any3[gp] = 1;
    }
    for (int c = 0; c < S.C; ++c) {
        int gc = gp * S.C + c;
        int tk = S.tsc_tk[gc];
        if (tk == NONE) continue;
        bool hits = S.m_tsc[(size_t)gc * S.G + g]
                    && S.el_node[((size_t)gp * S.N + r) * S.C + c];
        int d = dom_row[tk];
        if (hits && d != NONE && d < S.D)
            S.cntmap[(size_t)gc * S.D + d] += 1.0f;
    }
}

// ---------------------------------------------------------------- ports

__device__ bool port_conflict(const ScanArgs& S, int i, int j) {
    for (int p = 0; p < S.HP; ++p) {
        int pp = S.hp_port[i * S.HP + p];
        if (pp == NONE) continue;
        int proto = S.hp_proto[i * S.HP + p];
        int ip = S.hp_ip[i * S.HP + p];
        for (int q = 0; q < S.HP; ++q) {
            if (S.hp_port[j * S.HP + q] != pp) continue;
            if (S.hp_proto[j * S.HP + q] != proto) continue;
            int jq = S.hp_ip[j * S.HP + q];
            if (ip == jq || ip == S.wildcard_ip || jq == S.wildcard_ip)
                return true;
        }
    }
    return false;
}

// ---------------------------------------------------------------- kernel

__device__ __forceinline__ bool is_min_slot(int k) { return k == 2 || k == 4; }

// the block's partials: slot q of vf / vi reduced into sf[q * THREADS] /
// si[q * THREADS] (min or max for floats, sums for ints)
__device__ void block_reduce(float* sf, int* si, const float* vf,
                             const int* vi) {
    const int tid = threadIdx.x;
    for (int q = 0; q < RF; ++q) sf[q * THREADS + tid] = vf[q];
    for (int q = 0; q < RI; ++q) si[q * THREADS + tid] = vi[q];
    __syncthreads();
    for (int w = THREADS / 2; w > 0; w >>= 1) {
        if (tid < w) {
            for (int q = 0; q < RF; ++q) {
                float x = sf[q * THREADS + tid];
                float y = sf[q * THREADS + tid + w];
                sf[q * THREADS + tid] = is_min_slot(q) ? fminf(x, y)
                                                       : fmaxf(x, y);
            }
            for (int q = 0; q < RI; ++q)
                si[q * THREADS + tid] += si[q * THREADS + tid + w];
        }
        __syncthreads();
    }
}

// exclusive block scan of v in thread order; *total = the block's sum
__device__ int block_excl_scan(int v, int* s_tmp, int* total) {
    const unsigned FULL = 0xffffffffu;
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
        int y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) s_tmp[wid] = x;
    __syncthreads();
    if (wid == 0) {
        int w = lane < NWARPS ? s_tmp[lane] : 0;
        for (int o = 1; o < 32; o <<= 1) {
            int y = __shfl_up_sync(FULL, w, o);
            if (lane >= o) w += y;
        }
        if (lane < NWARPS) s_tmp[lane] = w;
    }
    __syncthreads();
    int before = wid > 0 ? s_tmp[wid - 1] : 0;
    *total = s_tmp[NWARPS - 1];
    __syncthreads();
    return before + x - v;
}

__global__ void serial_scan_kernel(ScanArgs S) {
    cg::grid_group grid = cg::this_grid();
    extern __shared__ __align__(16) unsigned char smem_raw[];
    // the learned scorer's parameters first (a multiple of 16 bytes)
    float* s_learned = reinterpret_cast<float*>(smem_raw);
    float* sf = s_learned + learned_smem_floats(S.learned);  // [RF][THREADS]
    int* si = reinterpret_cast<int*>(sf + RF * THREADS);   // [RI][THREADS]
    int* s_dom = si + RI * THREADS;                        // [MAX_TK]
    float* s_min = reinterpret_cast<float*>(s_dom + MAX_TK);  // [MAX_C]
    float* s_norm = s_min + MAX_C;                         // [8]
    int* s_win = reinterpret_cast<int*>(s_norm + 8);       // [64]: winner,
                               // pct scalars at 4.., scan scratch at 32..
    uint8_t* s_forb = reinterpret_cast<uint8_t*>(s_win + 64);  // [per]

    const int tid = threadIdx.x, blk = blockIdx.x, nblk = gridDim.x;
    const int per = (S.N + nblk - 1) / nblk;
    const int lo = blk * per;
    const int hi = min(lo + per, S.N);

    learned_stage(S.learned, s_learned);
    __syncthreads();
    // phase 0: the in-batch hostPort conflict matrix and the commit log
    long gt = (long)blk * THREADS + tid, gstride = (long)nblk * THREADS;
    if (S.ports)
        for (long p = gt; p < (long)S.B * S.B; p += gstride)
            S.port_conf[p] = port_conflict(S, (int)(p / S.B),
                                           (int)(p % S.B)) ? 1 : 0;
    for (long i = gt; i < S.B; i += gstride) S.committed[i] = -1;
    // the window's k_find from the valid-node count (every block counts)
    int k_find = 0;
    if (S.pct) {
        int c = 0;
        for (int n = tid; n < S.N; n += THREADS) c += S.node_valid[n] != 0;
        int tot;
        block_excl_scan(c, s_win + 32, &tot);
        int eff = S.pct == ADAPTIVE_PCT ? max(5, 50 - tot / 125) : S.pct;
        k_find = max(MIN_FEASIBLE_NODES_TO_FIND, (tot * eff) / 100);
    }
    grid.sync();

    bool feas_k[NPT_MAX];
    float ipa_k[NPT_MAX], sp_k[NPT_MAX];

    for (int b = 0; b < S.B; ++b) {
        const int g1 = S.g1[b];
        const int g = S.topo ? S.gid[b] : 0;
        const int start = S.pct ? ((*S.pct_start % S.N) + S.N) % S.N : 0;
        // ---------------------------------------------------- phase A
        // the spread minimum per hard constraint (domain space)
        if (S.topo) {
            for (int c = 0; c < S.C; ++c) {
                int gc = g * S.C + c;
                if (S.tsc_tk[gc] == NONE || !S.tsc_hard[gc]) continue;
                float m = INFINITY;
                size_t base = (size_t)gc * S.D;
                for (int d = tid; d < S.D; d += THREADS)
                    if (S.exists_hard[base + d])
                        m = fminf(m, S.t_cnt[base + d] + S.cntmap[base + d]);
                sf[tid] = m;
                __syncthreads();
                for (int w = THREADS / 2; w > 0; w >>= 1) {
                    if (tid < w) sf[tid] = fminf(sf[tid], sf[tid + w]);
                    __syncthreads();
                }
                if (tid == 0) {
                    float mc = isfinite(sf[0]) ? sf[0] : 0.0f;
                    if (S.tsc_mind[gc] > 0
                            && S.num_domains[gc] < S.tsc_mind[gc])
                        mc = 0.0f;
                    s_min[c] = mc;
                }
                __syncthreads();
            }
        }
        // nodes of this slice holding an earlier clashing commit
        if (S.ports) {
            for (int i = tid; i < per; i += THREADS) s_forb[i] = 0;
            __syncthreads();
            for (int j = tid; j < b; j += THREADS) {
                int r = S.committed[j];
                if (r >= lo && r < hi && S.port_conf[(size_t)b * S.B + j])
                    s_forb[r - lo] = 1;
            }
            __syncthreads();
        }
        float mt = -INFINITY, ma = -INFINITY, imn = INFINITY,
              imx = -INFINITY, smn = INFINITY, smx = -INFINITY;
        int c_feas = 0, c_port = 0, c_fit = 0, c_sp = 0, c_ipa = 0;
        int c_hi = 0, c_lo = 0;
        const float* rq = S.req + (size_t)b * S.R;
        const int own_row = S.nominated_row[b];
        for (int k = 0; k < NPT_MAX; ++k) {
            int n = lo + tid + k * THREADS;
            feas_k[k] = false;
            if (n >= hi) continue;
            bool ok_s = S.static_ok[(size_t)g1 * S.N + n] != 0;
            bool fit_ok = true;
            if (S.fit_on) {
                const float* fr = S.free + (size_t)n * S.R;
                const float* nm = S.nom + (size_t)n * S.R;
                bool own = own_row == n;
                for (int r = 0; r < S.R; ++r) {
                    float eff = (fr[r] - nm[r]) + (own ? rq[r] : 0.0f);
                    if (!(rq[r] <= eff)) fit_ok = false;
                }
            }
            bool ports_ok = !(S.ports && s_forb[n - lo]);
            bool ipa_ok = true, sp_ok = true, ign = false;
            float sp_r = 0.0f, ipa_live = 0.0f;
            if (S.topo) {
                queries(S, g, n, s_min, &ipa_ok, &sp_ok, &sp_r, &ipa_live);
                if (!S.spread_on) sp_ok = true;
                if (!S.ipa_on) ipa_ok = true;
                ign = S.ign[(size_t)g * S.N + n] != 0;
            }
            bool f = ok_s && ports_ok && fit_ok && sp_ok && ipa_ok;
            feas_k[k] = f;
            ipa_k[k] = ipa_live;
            sp_k[k] = sp_r;
            if (f && S.pct) {
                // the window's statistics wait for the truncation
                if (n >= start) c_hi += 1;
                else c_lo += 1;
            } else if (f) {
                size_t o = (size_t)g1 * S.N + n;
                mt = fmaxf(mt, S.taint_raw[o]);
                ma = fmaxf(ma, S.aff_raw[o]);
                imn = fminf(imn, ipa_live);
                imx = fmaxf(imx, ipa_live);
                if (!ign) {
                    smn = fminf(smn, sp_r);
                    smx = fmaxf(smx, sp_r);
                }
                c_feas += 1;
            }
            if (ok_s && !ports_ok) c_port += 1;
            if (ok_s && ports_ok && !fit_ok) c_fit += 1;
            if (ok_s && ports_ok && fit_ok && !sp_ok) c_sp += 1;
            if (ok_s && ports_ok && fit_ok && sp_ok && !ipa_ok) c_ipa += 1;
        }
        {
            float vf[RF] = {mt, ma, imn, imx, smn, smx};
            int vi[RI] = {c_feas, c_port, c_fit, c_sp, c_ipa, c_hi, c_lo};
            block_reduce(sf, si, vf, vi);
        }
        if (tid == 0) {
            for (int q = 0; q < RF; ++q)
                S.part_f[blk * 8 + q] = sf[q * THREADS];
            for (int q = 0; q < RI; ++q)
                S.part_i[blk * 8 + q] = si[q * THREADS];
        }
        grid.sync();
        if (S.pct) {
            // -------------------------------- the window (pct_nodes)
            // rotated order from `start`: rows >= start ascending, then
            // rows < start ascending
            if (tid == 0) {
                int tot_hi = 0, tot_lo = 0, off_hi = 0, off_lo = 0;
                for (int k = 0; k < nblk; ++k) {
                    int h = S.part_i[k * 8 + 5], l = S.part_i[k * 8 + 6];
                    if (k < blk) {
                        off_hi += h;
                        off_lo += l;
                    }
                    tot_hi += h;
                    tot_lo += l;
                }
                s_win[4] = off_hi;
                s_win[5] = tot_hi + off_lo;
                s_win[6] = tot_hi + tot_lo >= k_find;
            }
            __syncthreads();
            int run_hi = s_win[4], run_lo = s_win[5];
            const int kmax = (per + THREADS - 1) / THREADS;
            for (int k = 0; k < kmax && k < NPT_MAX; ++k) {
                int n = lo + tid + k * THREADS;
                bool f = n < hi && feas_k[k];
                bool up = n >= start;
                int v = f ? (up ? 1 : 1 << 16) : 0;
                int tot;
                int ex = block_excl_scan(v, s_win + 32, &tot);
                if (f) {
                    int rank = up ? run_hi + (ex & 0xffff)
                                  : run_lo + (ex >> 16);
                    feas_k[k] = rank < k_find;
                    if (rank == k_find - 1) *S.pct_next = (n + 1) % S.N;
                }
                run_hi += tot & 0xffff;
                run_lo += tot >> 16;
            }
            if (!s_win[6] && blk == 0 && tid == 0) *S.pct_next = start;
            // the normalizer statistics over the kept nodes
            for (int k = 0; k < NPT_MAX; ++k) {
                int n = lo + tid + k * THREADS;
                if (n >= hi || !feas_k[k]) continue;
                size_t o = (size_t)g1 * S.N + n;
                mt = fmaxf(mt, S.taint_raw[o]);
                ma = fmaxf(ma, S.aff_raw[o]);
                imn = fminf(imn, ipa_k[k]);
                imx = fmaxf(imx, ipa_k[k]);
                if (!(S.topo && S.ign[(size_t)g * S.N + n])) {
                    smn = fminf(smn, sp_k[k]);
                    smx = fmaxf(smx, sp_k[k]);
                }
                c_feas += 1;
            }
            {
                float vf[RF] = {mt, ma, imn, imx, smn, smx};
                int vi[RI] = {c_feas, 0, 0, 0, 0, 0, 0};
                block_reduce(sf, si, vf, vi);
            }
            if (tid == 0) {
                for (int q = 0; q < RF; ++q)
                    S.part_f[blk * 8 + q] = sf[q * THREADS];
                S.part_i[blk * 8] = si[0];
            }
            grid.sync();
        }
        // ---------------------------------------------------- phase B
        if (tid == 0) {
            float v[RF] = {-INFINITY, -INFINITY, INFINITY, -INFINITY,
                           INFINITY, -INFINITY};
            for (int k = 0; k < nblk; ++k)
                for (int q = 0; q < RF; ++q) {
                    float x = S.part_f[k * 8 + q];
                    v[q] = is_min_slot(q) ? fminf(v[q], x) : fmaxf(v[q], x);
                }
            for (int q = 0; q < RF; ++q) s_norm[q] = v[q];
        }
        __syncthreads();
        Norms M;
        {
            float tt = s_norm[0], ta = s_norm[1];
            M.top_t = (isfinite(tt) && tt > 0.0f) ? tt : 1.0f;
            float top_a = (isfinite(ta) && ta > 0.0f) ? ta : 1.0f;
            M.scale_a = 100.0f / top_a;
            M.ipa_mn = s_norm[2];
            M.ipa_diff = s_norm[3] - s_norm[2];
            M.ipa_ok = isfinite(M.ipa_diff) && M.ipa_diff > 0.0f;
            M.sp_mn = s_norm[4];
            M.sp_mx = s_norm[5];
            M.sp_ok = isfinite(M.sp_mx) && M.sp_mx > 0.0f;
            M.soft = S.topo && S.has_soft[g];
        }
        const unsigned int u = (unsigned int)S.uid[b];
        float bs = -INFINITY, bp = -1.0f;
        int bi = NO_NODE, nan = 0;
        for (int k = 0; k < NPT_MAX; ++k) {
            int n = lo + tid + k * THREADS;
            if (n >= hi) continue;
            bool ign = S.topo && S.ign[(size_t)g * S.N + n];
            if (n == 0)
                *S.total0 = total_at(S, M, b, g1, 0, ipa_k[k], sp_k[k], ign,
                                     s_learned);
            if (!feas_k[k]) continue;
            float t = total_at(S, M, b, g1, n, ipa_k[k], sp_k[k], ign,
                               s_learned);
            if (isnan(t)) {
                nan = 1;
                continue;
            }
            float p = tie_perturb(u, n, S.seed);
            if (better(t, p, n, bs, bp, bi)) {
                bs = t;
                bp = p;
                bi = n;
            }
        }
        sf[tid] = bs;
        sf[THREADS + tid] = bp;
        si[tid] = bi;
        si[THREADS + tid] = nan;
        __syncthreads();
        for (int w = THREADS / 2; w > 0; w >>= 1) {
            if (tid < w) {
                int j = tid + w;
                if (si[j] != NO_NODE
                        && better(sf[j], sf[THREADS + j], si[j], sf[tid],
                                  sf[THREADS + tid], si[tid])) {
                    sf[tid] = sf[j];
                    sf[THREADS + tid] = sf[THREADS + j];
                    si[tid] = si[j];
                }
                si[THREADS + tid] |= si[THREADS + j];
            }
            __syncthreads();
        }
        if (tid == 0) {
            S.best_f[blk * 2] = sf[0];
            S.best_f[blk * 2 + 1] = sf[THREADS];
            S.best_i[blk * 2] = si[0];
            S.best_i[blk * 2 + 1] = si[THREADS];
        }
        grid.sync();
        // ---------------------------------------------------- phase C
        if (tid == 0) {
            float ws = -INFINITY, wp = -1.0f;
            int wi = NO_NODE, wnan = 0;
            for (int k = 0; k < nblk; ++k) {
                wnan |= S.best_i[k * 2 + 1];
                int i = S.best_i[k * 2];
                if (i == NO_NODE) continue;
                float s = S.best_f[k * 2], p = S.best_f[k * 2 + 1];
                if (better(s, p, i, ws, wp, wi)) {
                    ws = s;
                    wp = p;
                    wi = i;
                }
            }
            int row;
            float win;
            if (wnan) {
                // a NaN total makes the reference's top NaN: no node ties
                // it and its argmax falls to node 0
                row = 0;
                win = *S.total0;
            } else if (wi == NO_NODE) {
                row = -1;
                win = 0.0f;
            } else {
                row = wi;
                win = ws;
            }
            s_win[0] = row;
            if (blk == 0) {
                S.rows[b] = row;
                S.win[b] = win;
                S.committed[b] = row;
                int sums[RI] = {0, 0, 0, 0, 0};
                for (int k = 0; k < nblk; ++k)
                    for (int q = 0; q < RI; ++q)
                        sums[q] += S.part_i[k * 8 + q];
                S.feas[b] = sums[0];
                for (int q = 0; q < 4; ++q) S.rejects[b * 4 + q] = sums[q + 1];
            }
            if (row >= lo && row < hi) {
                for (int r = 0; r < S.R; ++r)
                    S.free[(size_t)row * S.R + r] =
                        S.free[(size_t)row * S.R + r] + (-rq[r]);
                S.nzr[2 * row] = S.nzr[2 * row] + S.nzreq[2 * b];
                S.nzr[2 * row + 1] = S.nzr[2 * row + 1] + S.nzreq[2 * b + 1];
            }
            if (S.topo && row >= 0)
                for (int t = 0; t < S.TK; ++t)
                    s_dom[t] = S.topo_dom[(size_t)row * S.TK + t];
        }
        __syncthreads();
        if (S.pct && blk == 0) {
            // snap the next start to the first valid row in rotated order
            // from it (unchanged when no row is valid)
            if (tid == 0) {
                int s0 = *S.pct_next;
                s_win[4] = s0;
                s_win[5] = S.node_valid[s0] != 0;
            }
            __syncthreads();
            const int s0 = s_win[4];
            int best = S.N;
            if (!s_win[5])
                for (int n = tid; n < S.N; n += THREADS)
                    if (S.node_valid[n]) best = min(best, (n - s0 + S.N) % S.N);
            si[tid] = best;
            __syncthreads();
            for (int w = THREADS / 2; w > 0; w >>= 1) {
                if (tid < w) si[tid] = min(si[tid], si[tid + w]);
                __syncthreads();
            }
            if (tid == 0)
                *S.pct_start = si[0] == S.N ? s0 : (s0 + si[0]) % S.N;
            __syncthreads();
        }
        const int row = s_win[0];
        if (S.topo && row >= 0) {
            for (int k = 0; k < NPT_MAX; ++k) {
                int n = lo + tid + k * THREADS;
                if (n < hi) map_updates_node(S, g, row, n, s_dom);
            }
            if (blk == 0)
                for (int gp = tid; gp < S.G; gp += THREADS)
                    map_updates_domains(S, g, row, gp, s_dom);
        }
        grid.sync();
    }
}

// dynamic shared memory of a block: the learned parameters (`lf` floats,
// a multiple of 4), the partials and scalars, the port-clash bytes
static size_t smem_bytes(int per, int lf) {
    return (size_t)lf * 4 + (size_t)(RF + RI) * THREADS * 4 + MAX_TK * 4
           + MAX_C * 4 + 8 * 4 + 64 * 4 + (size_t)per;
}

// blocks of the cooperative grid for N nodes with `lf` floats of staged
// learned parameters (a negated CUDA error code when the card cannot be
// queried)
extern "C" int serial_scan_blocks(int n, int lf) {
    int dev = 0, sms = 0, per_sm = 0;
    size_t smem = smem_bytes(NPT_MAX * THREADS, lf);
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && smem > 48 * 1024)
        e = cudaFuncSetAttribute(serial_scan_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, serial_scan_kernel, THREADS, smem);
    if (e != cudaSuccess) return -(int)e;
    if (per_sm < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
    int want = (n + THREADS - 1) / THREADS;
    int most = sms * per_sm;
    return want < most ? (want < 1 ? 1 : want) : most;
}

extern "C" int serial_scan_launch(const ScanArgs* args, int blocks,
                                  void* stream) {
    ScanArgs S = *args;
    if (S.R > MAX_R || S.C > MAX_C || S.TK > MAX_TK
            || S.shape_n > MAX_SHAPE || blocks < 1
            || !learned_net_ok(S.learned))
        return (int)cudaErrorInvalidValue;
    int per = (S.N + blocks - 1) / blocks;
    if (per > NPT_MAX * THREADS) return (int)cudaErrorInvalidValue;
    size_t smem = smem_bytes(per, learned_smem_floats(S.learned));
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024)
        e = cudaFuncSetAttribute(serial_scan_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (e != cudaSuccess) return (int)e;
    void* params[] = {&S};
    e = cudaLaunchCooperativeKernel(
        serial_scan_kernel, dim3(blocks), dim3(THREADS), params,
        smem, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// Measurement probe, not on the scheduling path: `steps` rounds of the
// scan's three grid barriers and nothing else, on the grid and with the
// shared memory a scan over n nodes uses. A timed launch with steps = B
// gives the barrier limit of a B-step scan on this card.
__global__ void grid_sync_probe(int steps) {
    cg::grid_group grid = cg::this_grid();
    for (int b = 0; b < steps; ++b) {
        grid.sync();
        grid.sync();
        grid.sync();
    }
}

extern "C" int serial_scan_sync_probe(int n, int steps, void* stream) {
    int blocks = serial_scan_blocks(n, 0);
    if (blocks <= 0) return -blocks;
    int per = (n + blocks - 1) / blocks;
    void* params[] = {&steps};
    cudaError_t e = cudaLaunchCooperativeKernel(
        grid_sync_probe, dim3(blocks), dim3(THREADS), params,
        smem_bytes(per, 0), (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
