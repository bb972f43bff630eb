// K2a auction_score_argmax: one auction round's bid for every unplaced pod.
//
// Replaces: the scoring half of kubernetes_tpu/models/pipeline.py
// `_rounds_commit` (:535) round `body` (:649): eff_all/fit_all, the
// per-pod totals (ops/scores.py utilization_fractions :34,
// fit_score_from_fractions :68, balanced_allocation_from_fractions :81,
// normalize_inverse :166, normalize_max :159), `tie_perturb` (:296) and
// ops/common.py masked_argmax_random; plus, in final mode, the end-state
// feasible and fit-reject counts (:725-740). The twins are
// kubernetes_tpu_torch/kernels/auction.py:auction_score_argmax_ref and
// auction_final_ref.
//
// Soft mode (a soft-only topology launch, `soft` set): the static
// InterPodAffinity mask joins the feasible set; pass 1 also takes the
// extremes of the live ipa score (K4's ipa_live, over the feasible nodes)
// and of the raw spread score (K4's sp_r, over the feasible, non-ignored
// nodes); the total adds w_pts * normalize_spread (only where the group
// has a soft constraint) and then w_ipa * normalize_maxmin (:573-581,
// :625-633, :654-661); final mode also counts the nodes the mask alone
// rejects (:728-736).
//
// Learned score term (K9, learned_mlp.cuh; `learned.n_layers` > 0; the
// bid kernel's K9 instantiation, the launches without a scorer run one
// with no K9 code): each block holds K9's shared region at the front of
// its shared memory (the staged stack on the narrow path, the warps'
// slabs on the wide one) and adds w_learned * learned_term(...) to every
// total after the hand terms, every lane of a warp calling it together,
// and
// in soft mode after the spread and ipa terms (:615-640). Its spread and
// ipa features are the normalized soft scores in soft mode and 0 in the
// plain mode. The final mode does not score.
//
// What bounds it on an H100: instruction issue, once the node state is
// shared. A (pod, node) pair costs ~40 float operations (true divisions
// for the fractions and the taint score, a square root, the
// normalizations; K9 adds ~180), each true division and square root tens
// of instructions, while the node state (free and nominated reservations,
// R floats each, nzr and allocatable 2 each) and a group's phase-1 rows
// are ~80 B a node that every pod reads: read by every pod from L2, as
// the previous design's one block a pod did, they are ~2.7 GB a first
// round at B = 4,096, N = 8,192.
//
// Design: a block takes a tile of P pods (16 where shared memory allows),
// one warp a pod, and walks the N nodes in tiles of TN (256 where shared
// memory allows). Each node tile's rows, and the phase-1 (and soft) rows of
// the group of the block's first pod, are copied once into shared memory
// with cp.async, STAGES tiles in flight, and all P pods read the copy: L2
// traffic falls by ~P. A pod of another group reads its group's rows from
// global memory. Pass 1 tests fit against the pod's effective free row
// (nominated reservations subtracted, its own nomination handed back),
// keeps the verdicts as one bit a (pod, node) in shared memory (a ballot
// a 32 nodes) and takes the masked maxima; pass 2 forms the weighted
// total of each feasible pair in the reference's order and keeps the best
// (total high, tie_perturb high, node low: jnp.argmax returns the first
// maximum). Every per-pod reduction is a warp shuffle.
//
// Pods alike: when the block's pods share their group, request row,
// non-zero request and nominated row (a batch of one pod spec, the
// headline's case), their feasible sets, normalizers and totals are one
// and the same; only the tie perturbation tells them apart. Then every
// warp tests fit on its share of each tile once for all of them (one bit
// row), each tile's totals are formed once (every thread on its nodes),
// and each pod's warp only adds its perturbation and keeps its best: the
// same operations on the same values, so the same bits, at a sixteenth of
// the float work.
//
// Bidders are compacted on the device: each block ranks the unplaced rows
// (a block scan over `placed`) and takes the P of rank [P * block,
// P * block + P), so rounds after the first pay only for the pods still
// bidding and blocks past the last bidder leave at once.
//
// Export pass (auction_export, below the kernels): the reference's
// end-state scoring of `_rounds_commit` (pipeline.py :740-844), launched
// once after the last round when a learned scorer or an export is on; a
// cluster launch of its own plan (ExportPlan: each pod group's node axis
// split over the CTAs of a thread-block cluster).
//
// No compiled caps: the resource columns walk A.R, the
// RequestedToCapacityRatio points are read from device arrays (shape_x,
// shape_y) of any length; a block's shared memory is the one limit
// (auction_tiling returns 0 past it and the launch is refused).
//
// Measurement builds: -DBID_PROFILE adds the SM clock cycles of the bid
// kernel's phases (kernels/auction.py bid_profile), -DEXPORT_PROFILE those
// of the export pass (export_profile).
//
// Built with -fmad=false: the totals round exactly as the twin's (and
// the reference's) separate multiplies and adds, so placements can be
// compared bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "learned_mlp.cuh"

#define MAX_P 16
#define STAGES 3        // node tiles in flight: two copies beside the one
                        // being scored
#define SMEM_MAX 232448
#define FIT_LEAST 0
#define FIT_MOST 1
#define FIT_RTCR 2
#define NO_NODE 0x7fffffff
#define FULL 0xffffffffu
#define BID_MIN_BLOCKS 2  // two blocks an SM: 64 registers a thread
#define K9_NARROW 16      // K9's largest narrow class at 64 registers

// Mirrored by kernels/auction.py:_AuctionArgs (same members, same order).
struct AuctionArgs {
    int N, B, R, G;
    const float* free;      // [N, R]  round-start chain state
    const float* nom;       // [N, R]  nominated reservations
    const float* alloc2;    // [N, 2]  cpu / memory allocatable
    const float* nzr;       // [N, 2]  non-zero requested
    const float* req;       // [B, R]
    const float* nzreq;     // [B, 2]
    const int* nominated_row;  // [B]
    const int* uid;         // [B]
    const int* gid;         // [B]
    const uint8_t* static_ok;  // [G, N]
    const float* taint_raw;    // [G, N]
    const float* aff_raw;      // [G, N]
    const float* img;          // [G, N]
    const int* placed;      // [B]
    float w_taint, w_aff, w_fit, w_bal, w_img;
    int fit_strategy;
    int shape_n;
    const float* shape_x;   // [shape_n] RequestedToCapacityRatio points
    const float* shape_y;   // [shape_n]
    unsigned int seed;
    const int* prog_in;
    int* prog_out;
    int* choice;            // [B]
    float* win_now;         // [B]
    int* feas_count;        // [B] final mode
    int* fit_rejects;       // [B] final mode
    // soft-topology mode (soft = 1): a soft-only topology launch
    int soft;
    float w_pts, w_ipa;
    const uint8_t* ipa_ok;     // [G, N] static InterPodAffinity mask
    const float* ipa_live;     // [G, N] live ipa score (K4, this round)
    const float* sp_r;         // [G, N] live raw spread score (K4)
    const uint8_t* ign;        // [G, N] ignored for spread scoring
    const uint8_t* has_soft;   // [G] any soft spread constraint
    int* ipa_rejects;          // [B] final mode
    // the learned score term (n_layers 0: none)
    LearnedNet learned;
    float w_learned;
    // the end-state export pass (auction_export): which tails are on
    // and their outputs; learned_mag needs `learned` (lmag_* null else)
    int ex_feats, ex_alts;
    float* chosen_feat;        // [B, 9] the chosen row's features
    int* alt_row;              // [B, ALT_K]
    float* alt_score;          // [B, ALT_K]
    float* lmag_part;          // [B] per pod: sum of |w_learned x term|
    int* lmag_cnt;             // [B] per pod: end-state feasible nodes
    unsigned int* done;        // [1] blocks finished, 0 between launches
    float* lmag_out;           // [1] the batch's learned_mag
};

// ---------------------------------------------------------------- layout

__host__ __device__ inline int a16(int x) { return (x + 15) & ~15; }

// one node tile's rows in shared memory (byte offsets within a buffer)
struct TileLayout {
    int free, nom, alloc2, nzr, taint, aff, img, ipa_live, sp_r, ok, ipa_ok,
        ign, tot, bytes;
};

__host__ __device__ inline TileLayout tile_layout(int tn, int R) {
    TileLayout t;
    int o = 0;
    t.free = o; o += a16(tn * R * 4);
    t.nom = o; o += a16(tn * R * 4);
    t.alloc2 = o; o += a16(tn * 8);
    t.nzr = o; o += a16(tn * 8);
    t.taint = o; o += a16(tn * 4);
    t.aff = o; o += a16(tn * 4);
    t.img = o; o += a16(tn * 4);
    t.ipa_live = o; o += a16(tn * 4);
    t.sp_r = o; o += a16(tn * 4);
    t.ok = o; o += a16(tn);
    t.ipa_ok = o; o += a16(tn);
    t.ign = o; o += a16(tn);
    t.tot = o; o += a16(tn * 4);  // the tile's totals, pods alike
    t.bytes = o;
    return t;
}

// a block's dynamic shared memory: learned parameters, the pods' request
// rows and indices, two node tiles, the pods' feasibility bits
struct BlockLayout {
    int req, pods, red, tiles, bits, bytes;
};

__host__ __device__ inline BlockLayout block_layout(int lf, int P, int tn,
                                                    int R, int N) {
    BlockLayout b;
    b.req = lf * 4;
    b.pods = b.req + a16(P * R * 4);
    b.red = b.pods + 64 * 4;
    b.tiles = b.red + MAX_P * 8 * 4;
    b.bits = b.tiles + STAGES * tile_layout(tn, R).bytes;
    b.bytes = b.bits + a16(P * ((N + 31) / 32) * 4);
    return b;
}

// ---------------------------------------------------------------- copies

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int K>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(K));
}

// block-cooperative asynchronous copy of `n` bytes (16- or 4-byte pieces
// where aligned, else plain loads and stores, complete at the next
// __syncthreads)
__device__ void copy_async(void* dst, const void* src, int n) {
    const int tid = threadIdx.x, T = blockDim.x;
    uintptr_t a = (uintptr_t)dst | (uintptr_t)src | (uintptr_t)n;
    unsigned char* d = reinterpret_cast<unsigned char*>(dst);
    const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
    if ((a & 15) == 0) {
        for (int i = tid; i < n / 16; i += T)
            cp_async16(d + 16 * i, s + 16 * i);
    } else if ((a & 3) == 0) {
        for (int i = tid; i < n / 4; i += T) cp_async4(d + 4 * i, s + 4 * i);
    } else {
        for (int i = tid; i < n; i += T) d[i] = s[i];
    }
}

// ---------------------------------------------------------------- scores

// jnp.interp with constant extrapolation, same operations
__device__ float interp(const AuctionArgs& A, float x) {
    int k = A.shape_n;
    int i = 0;
    while (i < k && A.shape_x[i] <= x) ++i;  // searchsorted side='right'
    i = i < 1 ? 1 : (i > k - 1 ? k - 1 : i);
    float df = A.shape_y[i] - A.shape_y[i - 1];
    float dx = A.shape_x[i] - A.shape_x[i - 1];
    float delta = x - A.shape_x[i - 1];
    bool dx0 = fabsf(dx) <= 1.4210855e-14f;  // np.spacing(eps(float32))
    float f = dx0 ? A.shape_y[i - 1]
                  : A.shape_y[i - 1] + (delta / dx) * df;
    if (x < A.shape_x[0]) f = A.shape_y[0];
    if (x > A.shape_x[k - 1]) f = A.shape_y[k - 1];
    return f;
}

__device__ __forceinline__ float frac_of(float req, float a) {
    float f = a > 0.0f ? req / fmaxf(a, 1e-9f) : 1.0f;
    return fminf(fmaxf(f, 0.0f), 1.0f);
}

// per-pod normalization of the round: the masked maxima / minima of pass 1
struct Norms {
    float top_t, scale_a;
    float ipa_mn, ipa_diff;    // ipa_diff <= 0: every ipa_n is 0
    float sp_mn, sp_mx;        // sp_mx <= 0: every live sp_n is 100
    bool has_soft;
};

// one (pod, node) pair's signals
struct Pair {
    float t_raw, a_raw, img, ipa_live, sp_r;
    bool ign;
};

__device__ __forceinline__ Pair no_pair() {
    Pair q;
    q.t_raw = q.a_raw = q.img = q.ipa_live = q.sp_r = 0.0f;
    q.ign = false;
    return q;
}

// what a pair's total needs of the node's usage and the pod's non-zero
// request alone: the utilization fractions, fit and balance (x f0, y f1,
// z fit, w bal)
__device__ __forceinline__ float4 pre_of(const AuctionArgs& A, float a0,
                                         float a1, float nz0, float nz1,
                                         float nzq0, float nzq1) {
    float f0 = frac_of(nz0 + nzq0, a0);
    float f1 = frac_of(nz1 + nzq1, a1);
    float fit;
    if (A.fit_strategy == FIT_MOST) {
        fit = ((f0 + f1) / 2.0f) * 100.0f;
    } else if (A.fit_strategy == FIT_RTCR) {
        fit = (interp(A, f0) + interp(A, f1)) / 2.0f;
    } else {
        fit = (((1.0f - f0) + (1.0f - f1)) / 2.0f) * 100.0f;
    }
    float mean = (f0 + f1) / 2.0f;
    float d0 = f0 - mean, d1 = f1 - mean;
    float bal = (1.0f - sqrtf((d0 * d0 + d1 * d1) / 2.0f)) * 100.0f;
    return make_float4(f0, f1, fit, bal);
}

// the normalized hand terms of one (pod, node) pair: taint, affinity
// and, in soft mode, spread and ipa (ops/scores.py normalize_inverse,
// normalize_max, normalize_spread gated by has_soft, normalize_maxmin;
// true divisions)
struct Terms {
    float taint, aff, sp, ipa;
};

__device__ __forceinline__ Terms terms_of(const AuctionArgs& A,
                                          const Pair& q, const Norms& M) {
    Terms r;
    r.taint = (1.0f - q.t_raw / M.top_t) * 100.0f;
    r.aff = q.a_raw * M.scale_a;
    r.sp = 0.0f;
    r.ipa = 0.0f;
    if (A.soft) {
        if (M.has_soft && !q.ign)
            r.sp = M.sp_mx > 0.0f
                       ? (100.0f * ((M.sp_mx + M.sp_mn) - q.sp_r)) / M.sp_mx
                       : 100.0f;
        r.ipa = M.ipa_diff > 0.0f
                    ? (100.0f * (q.ipa_live - M.ipa_mn)) / M.ipa_diff
                    : 0.0f;
    }
    return r;
}

// weighted total of one (pod, node) pair from its pre_of, in the
// reference's order; `lp` is the block's K9 region. With K9, every lane of
// the warp calls it together (K9's wide path shares the warp); `live`
// false: no pair, the total is not used. `lt` (if set) gets the weighted
// learned term w_learned x term that was added last
template <bool K9>
__device__ __forceinline__ float total_of(const AuctionArgs& A,
                                          const float4 pre, const Pair& q,
                                          const Norms& M, float* lp,
                                          bool live, float* lt = nullptr) {
    const float fit = pre.z, bal = pre.w;
    const Terms r = terms_of(A, q, M);
    float t = A.w_taint * r.taint;
    t = t + A.w_aff * r.aff;
    t = t + A.w_fit * fit;
    t = t + A.w_bal * bal;
    t = t + A.w_img * q.img;
    if (A.soft) {
        t = t + A.w_pts * r.sp;
        t = t + A.w_ipa * r.ipa;
    }
    if constexpr (K9) {
        const long slot = (long)blockIdx.x * (blockDim.x >> 5)
                          + (threadIdx.x >> 5);
        const float w = A.w_learned
                        * learned_term<K9_NARROW>(A.learned, lp, slot, live,
                                                  pre.x, pre.y, fit, bal,
                                                  r.taint, r.aff, q.img,
                                                  r.sp, r.ipa);
        t = t + w;
        if (lt) *lt = w;
    }
    return t;
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
    if (i == NO_NODE) return false;
    if (bi == NO_NODE) return true;
    if (s != bs) return s > bs;
    if (p != bp) return p > bp;
    return i < bi;
}

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

__device__ __forceinline__ float warp_min(float v) {
    for (int o = 16; o > 0; o >>= 1)
        v = fminf(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

__device__ __forceinline__ int warp_sum(int v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

// ---------------------------------------------------------------- tiles

// the block's pods and the group whose rows the tiles carry
struct Pods {
    int np;          // pods of this block (warps with a pod)
    int g_tile;      // group staged with the node tiles
    int tn, W;       // tile nodes, bit words a pod
};

// stage node tile t (nodes [t * tn, t * tn + cnt)) into buffer `buf`;
// pass 1 (and final mode) needs the fit rows and the masks, pass 2 the
// score rows
__device__ void stage_tile(const AuctionArgs& A, const Pods& K,
                           unsigned char* buf, const TileLayout& L, int t,
                           bool pass1) {
    const int n0 = t * K.tn, cnt = min(K.tn, A.N - n0);
    const size_t go = (size_t)K.g_tile * A.N + n0;
    if (pass1) {
        copy_async(buf + L.free, A.free + (size_t)n0 * A.R, cnt * A.R * 4);
        copy_async(buf + L.nom, A.nom + (size_t)n0 * A.R, cnt * A.R * 4);
        copy_async(buf + L.ok, A.static_ok + go, cnt);
        copy_async(buf + L.taint, A.taint_raw + go, cnt * 4);
        copy_async(buf + L.aff, A.aff_raw + go, cnt * 4);
        if (A.soft) {
            copy_async(buf + L.ipa_ok, A.ipa_ok + go, cnt);
            copy_async(buf + L.ipa_live, A.ipa_live + go, cnt * 4);
            copy_async(buf + L.sp_r, A.sp_r + go, cnt * 4);
            copy_async(buf + L.ign, A.ign + go, cnt);
        }
    } else {
        copy_async(buf + L.alloc2, A.alloc2 + (size_t)n0 * 2, cnt * 8);
        copy_async(buf + L.nzr, A.nzr + (size_t)n0 * 2, cnt * 8);
        copy_async(buf + L.taint, A.taint_raw + go, cnt * 4);
        copy_async(buf + L.aff, A.aff_raw + go, cnt * 4);
        copy_async(buf + L.img, A.img + go, cnt * 4);
        if (A.soft) {
            copy_async(buf + L.ipa_live, A.ipa_live + go, cnt * 4);
            copy_async(buf + L.sp_r, A.sp_r + go, cnt * 4);
            copy_async(buf + L.ign, A.ign + go, cnt);
        }
    }
    cp_commit();
}

// Phase profile (a measurement build only, -DBID_PROFILE): block 0's
// thread 0 adds the SM clock cycles of the bid kernel's phases (slots:
// 0 pod selection, 1 staging, 2 tile waits, 3 per-tile preparation, 4
// tile bodies, 5 end-of-tile barriers, 6 the rest) and
// auction_read_profile copies them out.
#define BID_PHASES 8
#ifdef BID_PROFILE
__device__ unsigned long long bid_prof[BID_PHASES];
__device__ unsigned long long bid_acc[BID_PHASES];
#define BPROF(k)                                                    \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                      \
        unsigned long long t_ = clock64();                          \
        bid_acc[k] += t_ - bid_prof[7];                             \
        bid_prof[7] = t_;                                           \
    }
#else
#define BPROF(k)
#endif

// walk every node tile, double-buffered; `body(buf, t)` runs for each
// tile once its copy has landed, after `prep(buf, t)` when `prepare`
template <typename P, typename F>
__device__ void sweep(const AuctionArgs& A, const Pods& K,
                      unsigned char* tiles, const TileLayout& L, bool pass1,
                      bool prepare, P prep, F body) {
    const int nt = (A.N + K.tn - 1) / K.tn;
    // tiles 0 .. STAGES - 2 in flight before the first is scored; every
    // iteration commits one group (empty past the last tile), so waiting
    // for all but STAGES - 1 groups leaves tile t landed
    for (int t = 0; t < STAGES - 1; ++t) {
        if (t < nt) stage_tile(A, K, tiles + t * L.bytes, L, t, pass1);
        else cp_commit();
    }
    for (int t = 0; t < nt; ++t) {
        unsigned char* buf = tiles + (t % STAGES) * L.bytes;
        const int ahead = t + STAGES - 1;
        if (ahead < nt)
            stage_tile(A, K, tiles + (ahead % STAGES) * L.bytes, L, ahead,
                       pass1);
        else
            cp_commit();
        cp_wait<STAGES - 1>();
        __syncthreads();
        BPROF(2);
        if (prepare) {
            prep(buf, t);
            __syncthreads();
        }
        BPROF(3);
        body(buf, t);
        BPROF(4);
        __syncthreads();
        BPROF(5);
    }
}

__device__ __forceinline__ void no_prep(unsigned char*, int) {}

// does pod (request row rq, nominated row own) fit node n of the tile
// (local index j)?
__device__ __forceinline__ bool fits(const AuctionArgs& A,
                                     const float* tfree, const float* tnom,
                                     int j, const float* rq, bool own) {
    if ((A.R & 3) == 0) {
        // 16-byte shared loads: a 4-way smaller bank conflict than words
        // at a stride of R
        const float4* f4 = reinterpret_cast<const float4*>(tfree + j * A.R);
        const float4* n4 = reinterpret_cast<const float4*>(tnom + j * A.R);
        bool ok = true;
        for (int r4 = 0; r4 < A.R / 4; ++r4) {
            float4 f = f4[r4], m = n4[r4];
            const float* q = rq + 4 * r4;
            float e0 = (f.x - m.x) + (own ? q[0] : 0.0f);
            float e1 = (f.y - m.y) + (own ? q[1] : 0.0f);
            float e2 = (f.z - m.z) + (own ? q[2] : 0.0f);
            float e3 = (f.w - m.w) + (own ? q[3] : 0.0f);
            ok = ok && q[0] <= e0 && q[1] <= e1 && q[2] <= e2 && q[3] <= e3;
        }
        return ok;
    }
    for (int r = 0; r < A.R; ++r) {
        float eff = (tfree[j * A.R + r] - tnom[j * A.R + r])
                    + (own ? rq[r] : 0.0f);
        if (!(rq[r] <= eff)) return false;
    }
    return true;
}

// the block's pods: in bid mode the unplaced rows of rank [P * blk,
// P * blk + P) (a block scan over `placed`), in final mode rows
// [P * blk, P * blk + P); s_pod[w] is warp w's row
__device__ int select_pods(const AuctionArgs& A, int P, bool final_mode,
                           int* s_pod, int* s_scan) {
    const int tid = threadIdx.x, T = blockDim.x;
    const int lane = tid & 31, wid = tid >> 5, nw = T >> 5;
    const int first = blockIdx.x * P;
    if (final_mode) {
        int np = max(0, min(P, A.B - first));
        if (tid < np) s_pod[tid] = first + tid;
        __syncthreads();
        return np;
    }
    int base = 0;
    for (int c0 = 0; c0 < A.B && base < first + P; c0 += T) {
        int b = c0 + tid;
        int v = (b < A.B && A.placed[b] < 0) ? 1 : 0;
        int x = v;
        for (int o = 1; o < 32; o <<= 1) {
            int y = __shfl_up_sync(FULL, x, o);
            if (lane >= o) x += y;
        }
        if (lane == 31) s_scan[wid] = x;
        __syncthreads();
        int w = lane < nw ? s_scan[lane] : 0;
        for (int o = 1; o < 32; o <<= 1) {
            int y = __shfl_up_sync(FULL, w, o);
            if (lane >= o) w += y;
        }
        int before = wid > 0 ? __shfl_sync(FULL, w, wid - 1) : 0;
        int total = __shfl_sync(FULL, w, nw - 1);
        int rank = base + before + x - v;
        if (v && rank >= first && rank < first + P) s_pod[rank - first] = b;
        base += total;
        __syncthreads();
    }
    __syncthreads();
    return max(0, min(P, base - first));
}

// ---------------------------------------------------------------- kernels

// K9 true: the instantiation for launches with a learned scorer; the
// launches without one run an instantiation with no K9 code at all
template <bool K9>
__global__ void __launch_bounds__(MAX_P * 32, BID_MIN_BLOCKS)
auction_bid(AuctionArgs A, int P, int tn) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    if (*A.prog_in == 0) {
        // the previous round converged: this round is a no-op
        if (blockIdx.x == 0 && tid == 0) *A.prog_out = 0;
        return;
    }
    if (blockIdx.x == 0 && tid == 0) *A.prog_out = 0;
#ifdef BID_PROFILE
    if (blockIdx.x == 0 && tid == 0) {
        for (int k = 0; k < BID_PHASES; ++k) bid_acc[k] = 0;
        bid_prof[7] = clock64();
    }
#endif
    // a compile-time 0 without K9: the layout's offsets fold
    const int lf = K9 ? learned_smem_floats(A.learned, MAX_P) : 0;
    const BlockLayout BL = block_layout(lf, P, tn, A.R, A.N);
    const TileLayout L = tile_layout(tn, A.R);
    float* s_req = reinterpret_cast<float*>(smem + BL.req);
    int* s_pod = reinterpret_cast<int*>(smem + BL.pods);
    int* s_scan = s_pod + 32;
    unsigned* s_bits = reinterpret_cast<unsigned*>(smem + BL.bits);
    // placed rows of this block's own range bid nothing
    for (int b = blockIdx.x * P + tid; b < min(A.B, blockIdx.x * P + P);
         b += blockDim.x)
        if (A.placed[b] >= 0) A.choice[b] = -1;
    Pods K;
    K.np = select_pods(A, P, false, s_pod, s_scan);
    BPROF(0);
    if (K.np == 0) return;
    K.tn = tn;
    K.W = (A.N + 31) / 32;
    K.g_tile = A.gid[s_pod[0]];
    // the learned scorer's parameters and the pods' request rows
    if constexpr (K9)
        learned_stage(A.learned, reinterpret_cast<float*>(smem));
    for (int i = tid; i < K.np * A.R; i += blockDim.x)
        s_req[i] = A.req[(size_t)s_pod[i / A.R] * A.R + i % A.R];
    if (tid == 0) {
        // are the block's pods alike: one group, request row, non-zero
        // request and nominated row (bitwise)? Then their feasible sets,
        // normalizers and totals are one, and only the tie perturbation
        // tells them apart
        const int b0 = s_pod[0];
        int same = 1;
        for (int i = 1; i < K.np && same; ++i) {
            const int bi_ = s_pod[i];
            same = A.gid[bi_] == A.gid[b0]
                   && A.nominated_row[bi_] == A.nominated_row[b0]
                   && __float_as_int(A.nzreq[2 * bi_])
                          == __float_as_int(A.nzreq[2 * b0])
                   && __float_as_int(A.nzreq[2 * bi_ + 1])
                          == __float_as_int(A.nzreq[2 * b0 + 1]);
            for (int r = 0; r < A.R && same; ++r)
                same = __float_as_int(s_req[i * A.R + r])
                       == __float_as_int(s_req[r]);
        }
        s_pod[32 + 31] = same;
    }
    __syncthreads();
    const bool uniform = s_pod[32 + 31] != 0;
    const bool active = w < K.np;
    const int b = active ? s_pod[w] : s_pod[0];
    const int g = A.gid[b];
    const bool tiled = g == K.g_tile;  // this pod's group rows are staged
    const int own = A.nominated_row[b];
    const float* rq = s_req + (active ? w : 0) * A.R;
    const size_t gN = (size_t)g * A.N;
    // per-pod feasibility bits; the block's one row when uniform
    unsigned* bits = s_bits + (uniform ? 0 : w * K.W);
    float* s_red = reinterpret_cast<float*>(smem + BL.red);
    BPROF(1);
    // pass 1: fit, the feasibility bits, masked maxima of the raw taint /
    // affinity scores; in soft mode also the extremes of the live ipa score
    // over the feasible nodes and of the raw spread score over the
    // feasible, non-ignored ones. One warp a pod, or, when the pods are
    // alike, every warp on its share of the tile for all of them
    float mt = -INFINITY, ma = -INFINITY;
    float imn = INFINITY, imx = -INFINITY, smn = INFINITY, smx = -INFINITY;
    sweep(A, K, smem + BL.tiles, L, true, false, no_prep,
          [&](unsigned char* buf, int t) {
        if (!active && !uniform) return;
        const float* tfree = reinterpret_cast<const float*>(buf + L.free);
        const float* tnom = reinterpret_cast<const float*>(buf + L.nom);
        const int n0 = t * tn;
        const int j_first = uniform ? w * 32 : 0;
        const int j_step = uniform ? (int)blockDim.x : 32;
        for (int j0 = j_first; j0 < tn && n0 + j0 < A.N; j0 += j_step) {
            const int j = j0 + lane, n = n0 + j;
            bool f = false;
            float tr = 0.0f, ar = 0.0f, il = 0.0f, sr = 0.0f;
            bool ig = false;
            if (n < A.N) {
                bool ok = tiled ? buf[L.ok + j] != 0 : A.static_ok[gN + n];
                if (ok && A.soft)
                    ok = tiled ? buf[L.ipa_ok + j] != 0 : A.ipa_ok[gN + n];
                f = ok && fits(A, tfree, tnom, j, rq, own == n);
                if (f) {
                    const float* tt = reinterpret_cast<const float*>(
                        buf + L.taint);
                    const float* ta = reinterpret_cast<const float*>(
                        buf + L.aff);
                    tr = tiled ? tt[j] : A.taint_raw[gN + n];
                    ar = tiled ? ta[j] : A.aff_raw[gN + n];
                    if (A.soft) {
                        il = tiled ? reinterpret_cast<const float*>(
                                         buf + L.ipa_live)[j]
                                   : A.ipa_live[gN + n];
                        sr = tiled ? reinterpret_cast<const float*>(
                                         buf + L.sp_r)[j]
                                   : A.sp_r[gN + n];
                        ig = tiled ? buf[L.ign + j] != 0 : A.ign[gN + n];
                    }
                }
            }
            unsigned m = __ballot_sync(FULL, f);
            if (lane == 0) bits[(n0 + j0) >> 5] = m;
            if (!f) continue;
            mt = fmaxf(mt, tr);
            ma = fmaxf(ma, ar);
            if (A.soft) {
                imn = fminf(imn, il);
                imx = fmaxf(imx, il);
                if (!ig) {
                    smn = fminf(smn, sr);
                    smx = fmaxf(smx, sr);
                }
            }
        }
    });
    float tt = warp_max(mt), ta = warp_max(ma);
    float i_mn = warp_min(imn), i_mx = warp_max(imx);
    float s_mn = warp_min(smn), s_mx = warp_max(smx);
    if (uniform) {
        // the block's extremes, from every warp's
        if (lane == 0) {
            float* r = s_red + w * 8;
            r[0] = tt; r[1] = ta; r[2] = i_mn; r[3] = i_mx; r[4] = s_mn;
            r[5] = s_mx;
        }
        __syncthreads();
        for (int k = 0; k < (int)(blockDim.x >> 5); ++k) {
            const float* r = s_red + k * 8;
            tt = fmaxf(tt, r[0]);
            ta = fmaxf(ta, r[1]);
            i_mn = fminf(i_mn, r[2]);
            i_mx = fmaxf(i_mx, r[3]);
            s_mn = fminf(s_mn, r[4]);
            s_mx = fmaxf(s_mx, r[5]);
        }
    }
    Norms M;
    M.top_t = (isfinite(tt) && tt > 0.0f) ? tt : 1.0f;
    float top_a = (isfinite(ta) && ta > 0.0f) ? ta : 1.0f;
    M.scale_a = 100.0f / top_a;
    M.ipa_mn = 0.0f;
    M.ipa_diff = 0.0f;
    M.sp_mn = 0.0f;
    M.sp_mx = 0.0f;
    M.has_soft = false;
    if (A.soft) {
        float diff = i_mx - i_mn;
        if (isfinite(diff) && diff > 0.0f) {
            M.ipa_mn = i_mn;
            M.ipa_diff = diff;
        }
        if (isfinite(s_mx) && s_mx > 0.0f) {
            M.sp_mn = s_mn;
            M.sp_mx = s_mx;
        }
        M.has_soft = A.has_soft[g] != 0;
    }
    // pass 2: weighted totals of the feasible pairs and the tie-broken
    // argmax; when the pods are alike, each tile's totals are formed once
    // (every thread on its nodes) and each pod only adds its perturbation
    const unsigned int u = (unsigned int)A.uid[b];
    const float nzq0 = A.nzreq[2 * b], nzq1 = A.nzreq[2 * b + 1];
    float* lp = reinterpret_cast<float*>(smem);
    float bs = -INFINITY, bp = -1.0f;
    int bi = NO_NODE, has_nan = 0;
    // the pair's signals other than the pod's request: tile rows or its
    // group's rows in global memory
    auto pair_of = [&](const unsigned char* buf, int j, int n) {
        Pair q;
        if (tiled) {
            q.t_raw = reinterpret_cast<const float*>(buf + L.taint)[j];
            q.a_raw = reinterpret_cast<const float*>(buf + L.aff)[j];
            q.img = reinterpret_cast<const float*>(buf + L.img)[j];
        } else {
            q.t_raw = A.taint_raw[gN + n];
            q.a_raw = A.aff_raw[gN + n];
            q.img = A.img[gN + n];
        }
        q.ipa_live = q.sp_r = 0.0f;
        q.ign = false;
        if (A.soft) {
            if (tiled) {
                q.ipa_live = reinterpret_cast<const float*>(
                    buf + L.ipa_live)[j];
                q.sp_r = reinterpret_cast<const float*>(buf + L.sp_r)[j];
                q.ign = buf[L.ign + j] != 0;
            } else {
                q.ipa_live = A.ipa_live[gN + n];
                q.sp_r = A.sp_r[gN + n];
                q.ign = A.ign[gN + n] != 0;
            }
        }
        return q;
    };
    auto prep = [&](unsigned char* buf, int t) {
        const int n0 = t * tn;
        const float* al = reinterpret_cast<const float*>(buf + L.alloc2);
        const float* nz = reinterpret_cast<const float*>(buf + L.nzr);
        float* tot = reinterpret_cast<float*>(buf + L.tot);
        // warp by warp, every lane together where K9 runs; a lane past
        // the last node or on an infeasible one carries no pair
        for (int j0 = threadIdx.x & ~31; j0 < tn && n0 + j0 < A.N;
             j0 += blockDim.x) {
            const int j = j0 + (threadIdx.x & 31), n = n0 + j;
            const bool live = n < A.N && ((bits[n >> 5] >> (n & 31)) & 1u);
            if (!live && !K9) continue;
            const float s = total_of<K9>(
                A, live ? pre_of(A, al[2 * j], al[2 * j + 1], nz[2 * j],
                                 nz[2 * j + 1], nzq0, nzq1)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f),
                live ? pair_of(buf, j, n) : no_pair(), M, lp, live);
            if (live) tot[j] = s;
        }
    };
    sweep(A, K, smem + BL.tiles, L, false, uniform, prep,
          [&](unsigned char* buf, int t) {
        if (!active) return;
        const int n0 = t * tn;
        const float* al = reinterpret_cast<const float*>(buf + L.alloc2);
        const float* nz = reinterpret_cast<const float*>(buf + L.nzr);
        const float* tot = reinterpret_cast<const float*>(buf + L.tot);
        auto keep = [&](float s, int n) {
            if (isnan(s)) {
                has_nan = 1;
                return;
            }
            float p = tie_perturb(u, n, A.seed);
            if (better(s, p, n, bs, bp, bi)) {
                bs = s;
                bp = p;
                bi = n;
            }
        };
        // alike pods read the tile's totals; a loop of its own, so no
        // K9 call weighs on its registers
        if (uniform) {
            for (int j0 = 0; j0 < tn && n0 + j0 < A.N; j0 += 32) {
                if ((bits[(n0 + j0) >> 5] >> lane) & 1u)
                    keep(tot[j0 + lane], n0 + j0 + lane);
            }
            return;
        }
        for (int j0 = 0; j0 < tn && n0 + j0 < A.N; j0 += 32) {
            const int j = j0 + lane, n = n0 + j;
            const bool live = (bits[(n0 + j0) >> 5] >> lane) & 1u;
            // every lane together where K9 runs
            if (!live && !K9) continue;
            const float s = total_of<K9>(
                A, live ? pre_of(A, al[2 * j], al[2 * j + 1], nz[2 * j],
                                 nz[2 * j + 1], nzq0, nzq1)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f),
                live ? pair_of(buf, j, n) : no_pair(), M, lp, live);
            if (live) keep(s, n);
        }
    });
    BPROF(6);
    if (!active) return;
    for (int o = 16; o > 0; o >>= 1) {
        float s2 = __shfl_xor_sync(FULL, bs, o);
        float p2 = __shfl_xor_sync(FULL, bp, o);
        int i2 = __shfl_xor_sync(FULL, bi, o);
        has_nan |= __shfl_xor_sync(FULL, has_nan, o);
        if (better(s2, p2, i2, bs, bp, bi)) {
            bs = s2;
            bp = p2;
            bi = i2;
        }
    }
    if (has_nan) {
        // a NaN total makes the reference's top NaN: no node ties it and
        // its argmax falls to index 0 (node 0's total, formed by lane 0
        // with the whole warp: K9)
        Pair q;
        q.t_raw = A.taint_raw[gN];
        q.a_raw = A.aff_raw[gN];
        q.img = A.img[gN];
        q.ipa_live = A.soft ? A.ipa_live[gN] : 0.0f;
        q.sp_r = A.soft ? A.sp_r[gN] : 0.0f;
        q.ign = A.soft && A.ign[gN];
        const float t0 = total_of<K9>(
            A, pre_of(A, A.alloc2[0], A.alloc2[1], A.nzr[0], A.nzr[1], nzq0,
                      nzq1), q, M, lp, lane == 0);
        if (lane == 0) {
            A.choice[b] = 0;
            A.win_now[b] = t0;
        }
    } else if (lane == 0) {
        if (bi == NO_NODE) {
            A.choice[b] = -1;
        } else {
            A.choice[b] = bi;
            A.win_now[b] = bs;
        }
    }
}

// end state: per pod, nodes passing statics + fit (+ the ipa mask in soft
// mode), statics but not fit, and statics + fit but not the ipa mask
__global__ void __launch_bounds__(MAX_P * 32)
auction_final(AuctionArgs A, int P, int tn) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const BlockLayout BL = block_layout(0, P, tn, A.R, A.N);
    const TileLayout L = tile_layout(tn, A.R);
    float* s_req = reinterpret_cast<float*>(smem + BL.req);
    int* s_pod = reinterpret_cast<int*>(smem + BL.pods);
    Pods K;
    K.np = select_pods(A, P, true, s_pod, s_pod + 32);
    if (K.np == 0) return;
    K.tn = tn;
    K.W = (A.N + 31) / 32;
    K.g_tile = A.gid[s_pod[0]];
    for (int i = tid; i < K.np * A.R; i += blockDim.x)
        s_req[i] = A.req[(size_t)s_pod[i / A.R] * A.R + i % A.R];
    __syncthreads();
    const bool active = w < K.np;
    const int b = active ? s_pod[w] : 0;
    const int g = A.gid[b];
    const bool tiled = g == K.g_tile;
    const int own = A.nominated_row[b];
    const float* rq = s_req + w * A.R;
    const size_t gN = (size_t)g * A.N;
    int feas = 0, rej = 0, ipa = 0;
    sweep(A, K, smem + BL.tiles, L, true, false, no_prep,
          [&](unsigned char* buf, int t) {
        if (!active) return;
        const float* tfree = reinterpret_cast<const float*>(buf + L.free);
        const float* tnom = reinterpret_cast<const float*>(buf + L.nom);
        const int n0 = t * tn;
        for (int j = lane; j < tn && n0 + j < A.N; j += 32) {
            const int n = n0 + j;
            bool ok = tiled ? buf[L.ok + j] != 0 : A.static_ok[gN + n];
            if (!ok) continue;
            if (!fits(A, tfree, tnom, j, rq, own == n)) {
                rej += 1;
            } else if (A.soft
                       && !(tiled ? buf[L.ipa_ok + j] != 0
                                  : A.ipa_ok[gN + n] != 0)) {
                ipa += 1;
            } else {
                feas += 1;
            }
        }
    });
    if (!active) return;
    // integer sums, exact
    feas = warp_sum(feas);
    rej = warp_sum(rej);
    ipa = warp_sum(ipa);
    if (lane == 0) {
        A.feas_count[b] = feas;
        A.fit_rejects[b] = rej;
        A.ipa_rejects[b] = ipa;
    }
}

// ---------------------------------------------------------------- export

#define ALT_K 4
#define ALT_NONE (-1e9f)
#define NF 9            // features a row (ops/learned.py LEARNED_FEATURES)

// order-preserving keys of floats (a -0 read as +0; a NaN above +inf):
// key order is float order, so a (key, node) pair ranks like jax.lax.top_k
__device__ __forceinline__ unsigned fkey(float f) {
    unsigned u = __float_as_uint(f == 0.0f ? 0.0f : f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float kfloat(unsigned k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

#include "export_tails.cuh"

// The end-state export pass (pipeline.py :740-844 of the reference,
// `pod_eval` against the end state), for every pod of the launch: its
// candidates (statics + fit against the end state (+ the ipa mask in soft
// mode), and the chosen node), their normalizers, each candidate's total
// with the pod's own committed non-zero request taken off its chosen node,
// the top ALT_K (node, total) pairs, the chosen row's (node 0's when
// unplaced) features and the batch's mean |w_learned x term| over the
// end-state feasible nodes.
//
// Design: one warp a pod, P pods a CTA; the node axis of a pod group is
// split over a thread-block cluster of CS CTAs (ExportPlan, below: up to 8,
// each a contiguous slice of `slice` nodes, a multiple of 32), so a warp
// walks N / CS nodes. Where the slice's rows (free, nom, alloc2, nzr and
// the group's statics and raws) fit, a CTA stages them once into shared
// memory and both passes read that copy (`resident`); else it streams
// them in tiles, STAGES in flight, once a pass, as the bid kernel does. A
// CTA whose pods have no statically feasible node and no chosen node in
// its slice (the batch's padding rows) stages and scans nothing. Pass 1
// marks the candidates (a ballot a 32 nodes) and takes the normalizers'
// partial maxima and minima; they merge over the cluster through
// distributed shared memory after a cluster barrier (a max or a min is
// exact in any order). Pass 2 forms the totals, keeps a running top ALT_K
// a lane (a candidate that does not rank before a lane's fourth is
// dropped at once), writes the chosen row's features from the CTA that
// owns that row and, with K9, sums |w_learned x term|: lane t adds its
// slice's entries t, t + 32, ... in order and the warp folds its lanes by
// the xor tree. After a second cluster barrier rank 0 merges the CTAs'
// top lists by (key, lower node), exact, and folds the CTAs' partial sums
// in rank order; the last rank-0 CTA to finish (an integer ticket) folds
// the pods' sums (lane t: pods t, t + 32, ... in order, then the xor tree)
// into learned_mag. The same operations in the same order as the twin
// (kernels/auction.py auction_export_ref, lane_sum), with no float
// atomics. With K9 a 32-node step whose ballot holds neither a candidate
// nor the feature row skips the MLP (a test every lane takes alike: K9's
// wide path needs the whole warp).
//
// Pods alike (one group, request row, non-zero request and nominated row,
// compared bit for bit: a batch of one pod spec) have one fit verdict on
// every node: all the CTA's warps take pass 1 once for all of them, and
// each pod adds its chosen node. When their normalizers then agree and
// the slice is resident, every total and K9 term but those of a pod's own
// chosen node are the same for all of them: the CTA forms each once, with
// one top ALT_K + 1 list and one set of lane sums, and a pod takes the
// list without its chosen node plus its own total there, and the lane
// sums but the one lane holding its chosen node, summed again in order
// with its own term. The same values in the same order, so the same bits
// as each pod's own pass.
//
// Measurement build: -DEXPORT_PROFILE adds the SM clock cycles of the
// pass's phases in CTA 0's thread 0 (kernels/auction.py export_profile).

#define EXP_P 16              // pods a CTA, the instantiation without K9
#define EXP_P_K9 8            // ... and with K9 (128 registers a thread)
#define EXP_MIN_CTAS 2        // CTAs an SM the launch bounds ask for
#ifndef EXP_K9_MIN_CTAS       // ... for the K9 instantiation (a measurement
#define EXP_K9_MIN_CTAS 2     // build sets 1: up to 255 registers)
#endif
#define EXP_CLUSTER_MAX 8     // a portable cluster
#define EXP_SLICE_MIN 128     // the cluster doubles while slices stay this
#define EXP_SMEM_PAIR 115712  // a CTA's bytes when two share an SM
#define EXP_XCH 20            // words a warp hands to the cluster

// >>> export plan (host and device; tests/test_torch_kernel_layout.py
// compiles this block on the host and holds kernels/auction.py's mirror
// against it)

// Mirrored by kernels/auction.py:ExportPlan (same members, same order).
struct ExportPlan {
    int pods;      // pods (warps) a CTA
    int cluster;   // CTAs a cluster: the node axis split
    int slice;     // nodes a CTA, a multiple of 32
    int tile;      // nodes a staged tile (== slice when resident)
    int resident;  // 1: the slice staged once for both passes
    int smem;      // dynamic shared bytes a CTA
    int ctas;      // CTAs of the grid
    int threads;   // threads a CTA
};

// one node buffer's rows in shared memory (byte offsets): n nodes of
// free and nominated rows, allocatable and non-zero requested, the
// group's raws and masks; the soft rows only in soft mode
struct SliceLayout {
    int free, nom, alloc2, nzr, taint, aff, img, ok, ipa_live, sp_r, ipa_ok,
        ign, bytes;
};

__host__ __device__ inline SliceLayout slice_layout(int n, int R, int soft) {
    SliceLayout s;
    int o = 0;
    s.free = o; o += a16(n * R * 4);
    s.nom = o; o += a16(n * R * 4);
    s.alloc2 = o; o += a16(n * 8);
    s.nzr = o; o += a16(n * 8);
    s.taint = o; o += a16(n * 4);
    s.aff = o; o += a16(n * 4);
    s.img = o; o += a16(n * 4);
    s.ok = o; o += a16(n);
    s.ipa_live = o; o += soft ? a16(n * 4) : 0;
    s.sp_r = o; o += soft ? a16(n * 4) : 0;
    s.ipa_ok = o; o += soft ? a16(n) : 0;
    s.ign = o; o += soft ? a16(n) : 0;
    s.bytes = o;
    return s;
}

// a CTA's dynamic shared memory: K9's region (lf floats), the pods'
// request rows, the words each warp hands to the cluster, the ticket and
// the shared normalizers, the node buffers (one slice-wide when resident,
// else STAGES tiles), the pods' candidate bits over the slice, and a node
// buffer's shared totals and K9 terms (pods alike)
struct ExportLayout {
    int req, xch, nodes, bits, tot, bytes;
};

__host__ __device__ inline ExportLayout export_layout(int lf, int P, int R,
                                                      int slice, int tile,
                                                      int resident,
                                                      int soft) {
    ExportLayout e;
    e.req = lf * 4;
    e.xch = e.req + a16(P * R * 4);
    e.nodes = e.xch + a16((P * EXP_XCH + 1 + 6) * 4);
    e.bits = e.nodes + (resident ? 1 : STAGES)
                           * slice_layout(tile, R, soft).bytes;
    e.tot = e.bits + a16(P * (slice / 32) * 4);
    // the shared totals and K9 terms of a node buffer, then the warps' and
    // the CTA's lists (33 x 2 x (ALT_K + 1) words) and the lane sums
    e.bytes = e.tot + a16(tile * 8) + a16(33 * 2 * (ALT_K + 1) * 4) + 64 * 4;
    return e;
}

// CTAs a cluster and nodes a CTA for N nodes: the cluster doubles (to 8)
// while each slice keeps EXP_SLICE_MIN nodes
__host__ __device__ inline int export_cluster(int N) {
    int cs = 1;
    while (cs < EXP_CLUSTER_MAX && 2 * cs * EXP_SLICE_MIN <= N) cs *= 2;
    return cs;
}

__host__ __device__ inline int export_slice(int N) {
    const int cs = export_cluster(N);
    return ((N + cs - 1) / cs + 31) / 32 * 32;
}

// fill *x with the launch of p pods a CTA and tiles of t nodes (t ==
// slice: resident) when its layout fits `budget` bytes
static inline int export_fill(int lf, int R, int N, int B, int soft, int p,
                              int t, int budget, ExportPlan* x) {
    const int slice = export_slice(N);
    const int res = t == slice ? 1 : 0;
    const int bytes = export_layout(lf, p, R, slice, t, res, soft).bytes;
    if (bytes > budget) return 0;
    x->pods = p;
    x->cluster = export_cluster(N);
    x->slice = slice;
    x->tile = t;
    x->resident = res;
    x->smem = bytes;
    x->ctas = (B + p - 1) / p * x->cluster;
    x->threads = p * 32;
    return 1;
}

// the launch for B pods over N nodes of R resource columns (lf floats of
// K9): the most pods a CTA, its slice resident, else in the largest
// tiles, first within two CTAs an SM, then within one; 0 (refused) when
// not one pod and one 32-node tile fit a CTA's shared memory
static inline int export_plan_of(int lf, int R, int N, int B, int soft,
                                 int k9, ExportPlan* x) {
    const int slice = export_slice(N);
    const int budgets[2] = {EXP_SMEM_PAIR, SMEM_MAX};
    for (int u = 0; u < 2; ++u)
        for (int p = k9 ? EXP_P_K9 : EXP_P; p >= 1; p >>= 1) {
            if (export_fill(lf, R, N, B, soft, p, slice, budgets[u], x))
                return 1;
            for (int t = 256; t >= 32; t >>= 1)
                if (t < slice
                        && export_fill(lf, R, N, B, soft, p, t, budgets[u],
                                       x))
                    return 1;
        }
    return 0;
}

extern "C" int auction_export_plan(int lf, int R, int N, int B, int soft,
                                   int k9, ExportPlan* x) {
    if (lf < 0 || R < 1 || N < 1 || B < 1) return 0;
    return export_plan_of(lf, R, N, B, soft, k9, x);
}

// <<< export plan

// Phase profile (a measurement build only, -DEXPORT_PROFILE): CTA 0's
// thread 0 adds the SM clock cycles of the export pass's phases (slots:
// 0 set-up and staging, 1 pass 1, 2 the normalizers' merge, 3 pass 2, 4
// the pods' merge, 5 the batch fold) and auction_read_export_profile
// copies them out.
#define EXP_PHASES 8
#ifdef EXPORT_PROFILE
__device__ unsigned long long exp_prof[EXP_PHASES];
__device__ unsigned long long exp_acc[EXP_PHASES];
#define EPROF(k)                                                    \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                      \
        unsigned long long t_ = clock64();                          \
        exp_acc[k] += t_ - exp_prof[7];                             \
        exp_prof[7] = t_;                                           \
    }
#else
#define EPROF(k)
#endif

// copy rows [n, n + cnt) of the node state and of group g's statics into
// node buffer `buf` (laid out for the buffer's node count by L): `which`
// 1 the rows pass 1 reads, 2 those pass 2 reads, 3 both
__device__ void stage_rows(const AuctionArgs& A, int g, unsigned char* buf,
                           const SliceLayout& L, int n, int cnt, int which) {
    const size_t go = (size_t)g * A.N + n;
    if (which & 1) {
        copy_async(buf + L.free, A.free + (size_t)n * A.R, cnt * A.R * 4);
        copy_async(buf + L.nom, A.nom + (size_t)n * A.R, cnt * A.R * 4);
        copy_async(buf + L.ok, A.static_ok + go, cnt);
        if (A.soft) copy_async(buf + L.ipa_ok, A.ipa_ok + go, cnt);
    }
    if (which & 2) {
        copy_async(buf + L.alloc2, A.alloc2 + (size_t)n * 2, cnt * 8);
        copy_async(buf + L.nzr, A.nzr + (size_t)n * 2, cnt * 8);
        copy_async(buf + L.img, A.img + go, cnt * 4);
    }
    copy_async(buf + L.taint, A.taint_raw + go, cnt * 4);
    copy_async(buf + L.aff, A.aff_raw + go, cnt * 4);
    if (A.soft) {
        copy_async(buf + L.ipa_live, A.ipa_live + go, cnt * 4);
        copy_async(buf + L.sp_r, A.sp_r + go, cnt * 4);
        copy_async(buf + L.ign, A.ign + go, cnt);
    }
}

// walk the CTA's slice [s0, s1): `body(buf, n, cnt)` for each node
// buffer holding rows [n, n + cnt). Resident: the one buffer, already
// staged; else tiles of X.tile nodes, STAGES in flight, staged for pass
// `which` (1 or 2)
template <typename F>
__device__ void slice_sweep(const AuctionArgs& A, const ExportPlan& X,
                            int g, unsigned char* nodes,
                            const SliceLayout& L, int s0, int s1,
                            int which, F body) {
    if (X.resident) {
        if (s1 > s0) body(nodes, s0, s1 - s0);
        return;
    }
    const int tn = X.tile;
    const int nt = s1 > s0 ? (s1 - s0 + tn - 1) / tn : 0;
    for (int t = 0; t < STAGES - 1; ++t) {
        if (t < nt)
            stage_rows(A, g, nodes + t * L.bytes, L, s0 + t * tn,
                       min(tn, s1 - s0 - t * tn), which);
        cp_commit();
    }
    for (int t = 0; t < nt; ++t) {
        const int ahead = t + STAGES - 1;
        if (ahead < nt)
            stage_rows(A, g, nodes + (ahead % STAGES) * L.bytes, L,
                       s0 + ahead * tn, min(tn, s1 - s0 - ahead * tn),
                       which);
        cp_commit();
        cp_wait<STAGES - 1>();
        __syncthreads();
        body(nodes + (t % STAGES) * L.bytes, s0 + t * tn,
             min(tn, s1 - s0 - t * tn));
        __syncthreads();
    }
}

template <bool K9>
__global__ void __launch_bounds__((K9 ? EXP_P_K9 : EXP_P) * 32,
                                  K9 ? EXP_K9_MIN_CTAS : EXP_MIN_CTAS)
auction_export(AuctionArgs A, ExportPlan X) {
    namespace cg = cooperative_groups;
    cg::cluster_group cl = cg::this_cluster();
    extern __shared__ __align__(16) unsigned char smem[];
    EPROF(7);
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int rank = (int)cl.block_rank();
    const int lf = K9 ? learned_smem_floats(A.learned, MAX_P) : 0;
    const ExportLayout E = export_layout(lf, X.pods, A.R, X.slice, X.tile,
                                         X.resident, A.soft);
    const SliceLayout L = slice_layout(X.tile, A.R, A.soft);
    float* s_req = reinterpret_cast<float*>(smem + E.req);
    float* s_x1 = reinterpret_cast<float*>(smem + E.xch);      // [P][8]
    unsigned* s_x2 = reinterpret_cast<unsigned*>(smem + E.xch)
                     + X.pods * 8;                             // [P][12]
    int* s_flag = reinterpret_cast<int*>(smem + E.xch) + X.pods * EXP_XCH;
    unsigned char* nodes = smem + E.nodes;
    unsigned* bits = reinterpret_cast<unsigned*>(smem + E.bits)
                     + w * (X.slice / 32);
    const int first = (blockIdx.x / X.cluster) * X.pods;
    const int np = min(X.pods, A.B - first);
    const int s0 = rank * X.slice, s1 = min(A.N, s0 + X.slice);
    const int g_tile = A.gid[first];
    for (int i = tid; i < np * A.R; i += blockDim.x)
        s_req[i] = A.req[(size_t)first * A.R + i];
    // can the slice hold a candidate of this CTA's pods (one placed in it,
    // or a statically feasible node of a pod's group)? A CTA of batch
    // padding, or of pods with nothing here, stages and scans nothing. The
    // group's verdict bytes are read at once (16-byte loads where aligned;
    // no load waits on another)
    bool need = false;
    if (w < np) {
        const int pw = A.placed[first + w];
        const uint8_t* row =
            A.static_ok + (size_t)A.gid[first + w] * A.N + s0;
        const int cnt = max(0, s1 - s0);
        unsigned any = (pw >= s0 && pw < s1) ? 1u : 0u;
        int tail = 0;
        if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
            const uint4* r4 = reinterpret_cast<const uint4*>(row);
            for (int i = lane; i < cnt / 16; i += 32) {
                const uint4 v = __ldg(r4 + i);
                any |= v.x | v.y | v.z | v.w;
            }
            tail = cnt & ~15;
        }
        for (int i = tail + lane; i < cnt; i += 32) any |= row[i];
        need = __any_sync(FULL, any != 0u);
    }
    const bool staged = __syncthreads_or(need) != 0;
    if constexpr (K9) {
        if (staged) learned_stage(A.learned, reinterpret_cast<float*>(smem));
    }
    if (X.resident && staged && s1 > s0) {
        stage_rows(A, g_tile, nodes, L, s0, s1 - s0, 3);
        cp_commit();
        cp_wait<0>();
    }
    __syncthreads();
    EPROF(0);
    const bool active = w < np;
    const int b = first + (active ? w : 0);
    const int g = A.gid[b];
    const bool tiled = g == g_tile;
    const int own = A.nominated_row[b];
    const int placed = A.placed[b];
    const int rc = placed < 0 ? 0 : (placed > A.N - 1 ? A.N - 1 : placed);
    const float* rq = s_req + (active ? w : 0) * A.R;
    const size_t gN = (size_t)g * A.N;

    // pods alike: one group, request row, non-zero request and nominated
    // row (a batch of one pod spec, 25a's case; the bits compared): their
    // fit verdicts on every node are one and the same
    bool same = true;
    if (active) {
        same = g == g_tile && own == A.nominated_row[first]
               && __float_as_uint(A.nzreq[2 * b])
                      == __float_as_uint(A.nzreq[2 * first])
               && __float_as_uint(A.nzreq[2 * b + 1])
                      == __float_as_uint(A.nzreq[2 * first + 1]);
        for (int r = lane; r < A.R; r += 32)
            same = same && __float_as_uint(rq[r]) == __float_as_uint(s_req[r]);
        same = __all_sync(FULL, same);
    }
    const bool alike = __syncthreads_and(same) != 0;
    unsigned* okbits = reinterpret_cast<unsigned*>(smem + E.bits);  // row 0
    // alike pods none of which is placed, whose group has no statically
    // feasible node (the batch's padding rows): no candidate anywhere. Every
    // CTA of the cluster sees the same, and none takes a cluster barrier
    // (the lists stay empty, the sums 0)
    bool inert = false;
    if (alike) {
        const uint8_t* row = A.static_ok + gN;
        unsigned any = (active && placed >= 0) ? 1u : 0u;
        int tail = 0;
        if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
            const uint4* r4 = reinterpret_cast<const uint4*>(row);
            for (int i = tid; i < A.N / 16; i += blockDim.x) {
                const uint4 v = __ldg(r4 + i);
                any |= v.x | v.y | v.z | v.w;
            }
            tail = A.N & ~15;
        }
        for (int i = tail + tid; i < A.N; i += blockDim.x) any |= row[i];
        inert = __syncthreads_or(any != 0u) == 0;
    }

    // ---- pass 1: candidates and the normalizers' partials. Alike: every
    // warp takes its share of the slice's nodes for all pods (the verdict
    // row of the CTA; each pod adds its chosen node); else each warp its
    // pod's whole slice
    float mt = -INFINITY, ma = -INFINITY;
    float imn = INFINITY, imx = -INFINITY, smn = INFINITY, smx = -INFINITY;
    bool chosen_ok = false;   // the chosen node (in this slice) is feasible
    auto pass1 = [&](unsigned char* buf, int nb, int cnt) {
        if (!alike && !active) return;
        const float* tfree = reinterpret_cast<const float*>(buf + L.free);
        const float* tnom = reinterpret_cast<const float*>(buf + L.nom);
        const int step = alike ? blockDim.x : 32;
        for (int j0 = alike ? w * 32 : 0; j0 < cnt; j0 += step) {
            const int j = j0 + lane, n = nb + j;
            bool c = false;
            float tr = 0.0f, ar = 0.0f, il = 0.0f, sr = 0.0f;
            bool ig = false;
            if (j < cnt) {
                bool ok = tiled ? buf[L.ok + j] != 0 : A.static_ok[gN + n];
                if (ok && A.soft)
                    ok = tiled ? buf[L.ipa_ok + j] != 0 : A.ipa_ok[gN + n];
                ok = ok && fits(A, tfree, tnom, j, rq, own == n);
                if (!alike && n == placed) chosen_ok = ok;
                c = ok || (!alike && n == placed);
                if (c) {
                    tr = tiled ? reinterpret_cast<const float*>(
                                     buf + L.taint)[j]
                               : A.taint_raw[gN + n];
                    ar = tiled ? reinterpret_cast<const float*>(
                                     buf + L.aff)[j]
                               : A.aff_raw[gN + n];
                    if (A.soft) {
                        il = tiled ? reinterpret_cast<const float*>(
                                         buf + L.ipa_live)[j]
                                   : A.ipa_live[gN + n];
                        sr = tiled ? reinterpret_cast<const float*>(
                                         buf + L.sp_r)[j]
                                   : A.sp_r[gN + n];
                        ig = tiled ? buf[L.ign + j] != 0 : A.ign[gN + n];
                    }
                }
            }
            const unsigned m = __ballot_sync(FULL, c);
            if (lane == 0) (alike ? okbits : bits)[(nb - s0 + j0) >> 5] = m;
            if (!c) continue;
            mt = fmaxf(mt, tr);
            ma = fmaxf(ma, ar);
            if (A.soft) {
                imn = fminf(imn, il);
                imx = fmaxf(imx, il);
                if (!ig) {
                    smn = fminf(smn, sr);
                    smx = fmaxf(smx, sr);
                }
            }
        }
    };
    if (staged) slice_sweep(A, X, g_tile, nodes, L, s0, s1, 1, pass1);
    EPROF(1);
    {
        float p[6] = {warp_max(mt), warp_max(ma), warp_min(imn),
                      warp_max(imx), warp_min(smn), warp_max(smx)};
        if (alike) {
            // the CTA's partials over its verdict row, then each pod's
            // chosen node (a candidate whether or not it fits; a max or a
            // min takes a value twice alike)
            if (lane == 0)
                for (int k = 0; k < 6; ++k) s_x1[w * 8 + k] = p[k];
            __syncthreads();
            const int P = blockDim.x >> 5;
            float v[6] = {-INFINITY, -INFINITY, INFINITY, -INFINITY,
                          INFINITY, -INFINITY};
            if (lane < P)
                for (int k = 0; k < 6; ++k) v[k] = s_x1[lane * 8 + k];
            p[0] = warp_max(v[0]);
            p[1] = warp_max(v[1]);
            p[2] = warp_min(v[2]);
            p[3] = warp_max(v[3]);
            p[4] = warp_min(v[4]);
            p[5] = warp_max(v[5]);
            if (active && placed >= s0 && placed < s1) {
                chosen_ok = staged
                            && ((okbits[(placed - s0) >> 5]
                                 >> ((placed - s0) & 31)) & 1u);
                p[0] = fmaxf(p[0], A.taint_raw[gN + placed]);
                p[1] = fmaxf(p[1], A.aff_raw[gN + placed]);
                if (A.soft) {
                    const float il = A.ipa_live[gN + placed];
                    p[2] = fminf(p[2], il);
                    p[3] = fmaxf(p[3], il);
                    if (!A.ign[gN + placed]) {
                        const float sr = A.sp_r[gN + placed];
                        p[4] = fminf(p[4], sr);
                        p[5] = fmaxf(p[5], sr);
                    }
                }
            }
            __syncthreads();
        } else {
            chosen_ok = __reduce_or_sync(FULL, chosen_ok ? 1u : 0u) != 0;
        }
        if (active && lane == 0)
            for (int k = 0; k < 6; ++k) s_x1[w * 8 + k] = p[k];
    }
    if (!inert) cl.sync();
    // the cluster's partials: lane r reads rank r's (none inert)
    float v[6] = {-INFINITY, -INFINITY, INFINITY, -INFINITY, INFINITY,
                  -INFINITY};
    if (active && !inert && lane < X.cluster) {
        const float* rx = cl.map_shared_rank(s_x1, lane) + w * 8;
        for (int k = 0; k < 6; ++k) v[k] = rx[k];
    }
    const float tt = warp_max(v[0]), ta = warp_max(v[1]);
    const float i_mn = warp_min(v[2]), i_mx = warp_max(v[3]);
    const float s_mn = warp_min(v[4]), s_mx = warp_max(v[5]);
    EPROF(2);
    Norms M;
    M.top_t = (isfinite(tt) && tt > 0.0f) ? tt : 1.0f;
    const float top_a = (isfinite(ta) && ta > 0.0f) ? ta : 1.0f;
    M.scale_a = 100.0f / top_a;
    M.ipa_mn = 0.0f;
    M.ipa_diff = 0.0f;
    M.sp_mn = 0.0f;
    M.sp_mx = 0.0f;
    M.has_soft = false;
    if (A.soft) {
        const float diff = i_mx - i_mn;
        if (isfinite(diff) && diff > 0.0f) {
            M.ipa_mn = i_mn;
            M.ipa_diff = diff;
        }
        if (isfinite(s_mx) && s_mx > 0.0f) {
            M.sp_mn = s_mn;
            M.sp_mx = s_mx;
        }
        M.has_soft = A.has_soft[g] != 0;
    }
    // alike pods whose normalizers came out the same (their chosen nodes
    // moved no extreme) share every total but their own chosen node's:
    // the CTA forms each node's total (and K9 term) once
    bool shared = false;
    if (alike) {
        float* s_m = reinterpret_cast<float*>(s_flag + 1);
        const float m6[6] = {M.top_t, M.scale_a, M.ipa_mn, M.ipa_diff,
                             M.sp_mn, M.sp_mx};
        if (w == 0 && lane == 0)
            for (int k = 0; k < 6; ++k) s_m[k] = m6[k];
        __syncthreads();
        bool eq = true;
        if (active)
            for (int k = 0; k < 6; ++k)
                eq = eq && __float_as_uint(m6[k]) == __float_as_uint(s_m[k]);
        shared = __syncthreads_and(eq) != 0;
        if (shared && !active) {
            // a warp without a pod forms shared totals with its CTA's
            M.top_t = s_m[0];
            M.scale_a = s_m[1];
            M.ipa_mn = s_m[2];
            M.ipa_diff = s_m[3];
            M.sp_mn = s_m[4];
            M.sp_mx = s_m[5];
        }
    }

    // ---- pass 2: totals, the lanes' top lists, features, |term| sums
    const float nzq0 = A.nzreq[2 * b], nzq1 = A.nzreq[2 * b + 1];
    float* lp = reinterpret_cast<float*>(smem);
    float* s_tot = reinterpret_cast<float*>(smem + E.tot);   // [tile]
    float* s_lt = s_tot + X.tile;                            // [tile]
    float lacc = 0.0f;
    int lcnt = 0;
    Top4 top;
    top4_init(top);
    // one pair's inputs at node n (local j of node buffer `buf`, or from
    // global memory when buf is null or the pod's group is not staged)
    auto inputs = [&](const unsigned char* buf, const float* al,
                      const float* nz, int j, int n, bool mine, float4& pre,
                      Pair& q) {
        // the pod's own committed usage off its chosen node: the
        // fractions add the request back (pipeline.py :776-784)
        const float z0 = mine ? nz[2 * j] - nzq0 : nz[2 * j];
        const float z1 = mine ? nz[2 * j + 1] - nzq1 : nz[2 * j + 1];
        pre = pre_of(A, al[2 * j], al[2 * j + 1], z0, z1, nzq0, nzq1);
        if (tiled && buf) {
            q.t_raw = reinterpret_cast<const float*>(buf + L.taint)[j];
            q.a_raw = reinterpret_cast<const float*>(buf + L.aff)[j];
            q.img = reinterpret_cast<const float*>(buf + L.img)[j];
            if (A.soft) {
                q.ipa_live = reinterpret_cast<const float*>(
                    buf + L.ipa_live)[j];
                q.sp_r = reinterpret_cast<const float*>(buf + L.sp_r)[j];
                q.ign = buf[L.ign + j] != 0;
            }
        } else {
            q.t_raw = A.taint_raw[gN + n];
            q.a_raw = A.aff_raw[gN + n];
            q.img = A.img[gN + n];
            if (A.soft) {
                q.ipa_live = A.ipa_live[gN + n];
                q.sp_r = A.sp_r[gN + n];
                q.ign = A.ign[gN + n] != 0;
            }
        }
    };
    auto feature_row = [&](const float4& pre, const Pair& q) {
        const Terms r = terms_of(A, q, M);
        float* f = A.chosen_feat + (size_t)b * NF;
        f[0] = pre.x;
        f[1] = pre.y;
        f[2] = pre.z / 100.0f;
        f[3] = pre.w / 100.0f;
        f[4] = r.taint / 100.0f;
        f[5] = r.aff / 100.0f;
        f[6] = q.img / 100.0f;
        f[7] = r.sp / 100.0f;
        f[8] = r.ipa / 100.0f;
    };
    auto keep = [&](int n, float s, float lt) {
        if (K9 && (n != placed || chosen_ok)) {
            lacc = lacc + fabsf(lt);
            lcnt += 1;
        }
        if (A.ex_alts) {
            const unsigned k = fkey(s);
            if (ranks_before(k, n, top.k[ALT_K - 1], top.i[ALT_K - 1]))
                top4_push(top, k, n);
        }
    };
    // each warp its pod over a node buffer's rows, or (buf null: nothing
    // staged, the feature row alone) the same rows from global memory
    auto pass2 = [&](unsigned char* buf, int nb, int cnt) {
        if (!active) return;
        const bool sm = buf != nullptr;
        const float* al = sm ? reinterpret_cast<const float*>(buf + L.alloc2)
                             : A.alloc2 + 2 * (size_t)nb;
        const float* nz = sm ? reinterpret_cast<const float*>(buf + L.nzr)
                             : A.nzr + 2 * (size_t)nb;
        const unsigned* bw = alike ? okbits : bits;
        for (int j0 = 0; j0 < cnt; j0 += 32) {
            const int j = j0 + lane, n = nb + j;
            const bool c = j < cnt
                           && ((sm && ((bw[(nb - s0 + j0) >> 5] >> lane) & 1u))
                               || n == placed);
            const bool fe = A.ex_feats && n == rc && j < cnt;
            if constexpr (K9) {
                if (__ballot_sync(FULL, c || fe) == 0u) continue;
            } else {
                if (!c && !fe) continue;
            }
            float4 pre = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            Pair q = no_pair();
            if (c || fe) inputs(buf, al, nz, j, n, n == placed, pre, q);
            float lt = 0.0f;
            const float s = total_of<K9>(A, pre, q, M, lp, c, &lt);
            if (fe) feature_row(pre, q);
            if (c) keep(n, s, lt);
        }
    };
    // the CTA's totals and K9 terms once over its resident slice (all
    // warps), and each lane's top ALT_K + 1 of them
    TopK<ALT_K + 1> t5;
    top4_init(t5);
    auto shared_totals = [&](unsigned char* buf, int nb, int cnt) {
        const float* al = reinterpret_cast<const float*>(buf + L.alloc2);
        const float* nz = reinterpret_cast<const float*>(buf + L.nzr);
        for (int j0 = w * 32; j0 < cnt; j0 += blockDim.x) {
            const int j = j0 + lane, n = nb + j;
            const bool live =
                j < cnt && ((okbits[(nb - s0 + j0) >> 5] >> lane) & 1u);
            if constexpr (K9) {
                if (__ballot_sync(FULL, live) == 0u) continue;
            } else {
                if (!live) continue;
            }
            float4 pre = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            Pair q = no_pair();
            if (live) inputs(buf, al, nz, j, n, false, pre, q);
            float lt = 0.0f;
            const float s = total_of<K9>(A, pre, q, M, lp, live, &lt);
            if (live) {
                s_tot[j] = s;
                s_lt[j] = lt;
                if (A.ex_alts) {
                    const unsigned k = fkey(s);
                    if (ranks_before(k, n, t5.k[ALT_K], t5.i[ALT_K]))
                        top4_push(t5, k, n);
                }
            }
        }
        __syncthreads();
    };
    // the slice resident: each pod takes the CTA's list without its
    // chosen node, and the CTA's lane sums but the one lane holding its
    // chosen node when that is feasible, summed again with its own term
    auto pods_shared = [&](unsigned char* buf) {
        shared_totals(buf, s0, s1 - s0);
        unsigned* s_t5 = reinterpret_cast<unsigned*>(s_tot + 2 * X.tile);
        float* s_lane = reinterpret_cast<float*>(s_t5 + 2 * (ALT_K + 1) * 33);
        int* s_lcnt = reinterpret_cast<int*>(s_lane + 32);
        if (A.ex_alts) {
            unsigned ok[ALT_K + 1];
            int oi[ALT_K + 1];
            top4_warp(t5, 32, ok, oi);
            if (lane == 0)
                for (int q = 0; q <= ALT_K; ++q) {
                    s_t5[w * 2 * (ALT_K + 1) + q] = ok[q];
                    s_t5[w * 2 * (ALT_K + 1) + ALT_K + 1 + q] = (unsigned)oi[q];
                }
        }
        if (K9 && w == 0) {
            float acc = 0.0f;
            int cn = 0;
            for (int j = lane; j < s1 - s0; j += 32)
                if ((okbits[j >> 5] >> lane) & 1u) {
                    acc = acc + fabsf(s_lt[j]);
                    cn += 1;
                }
            s_lane[lane] = acc;
            s_lcnt[lane] = cn;
        }
        __syncthreads();
        if (A.ex_alts && w == 0) {
            TopK<ALT_K + 1> t;
            top4_init(t);
            const int P = blockDim.x >> 5;
            if (lane < P)
                for (int q = 0; q <= ALT_K; ++q) {
                    t.k[q] = s_t5[lane * 2 * (ALT_K + 1) + q];
                    t.i[q] = (int)s_t5[lane * 2 * (ALT_K + 1) + ALT_K + 1 + q];
                }
            unsigned ok[ALT_K + 1];
            int oi[ALT_K + 1];
            top4_warp(t, P, ok, oi);
            if (lane == 0)
                for (int q = 0; q <= ALT_K; ++q) {
                    s_t5[32 * 2 * (ALT_K + 1) + q] = ok[q];
                    s_t5[32 * 2 * (ALT_K + 1) + ALT_K + 1 + q] =
                        (unsigned)oi[q];
                }
        }
        __syncthreads();
        if (!active) return;
        const float* al = reinterpret_cast<const float*>(buf + L.alloc2);
        const float* nz = reinterpret_cast<const float*>(buf + L.nzr);
        // lane 0 the chosen node (in this slice: a candidate), lane 1 the
        // feature row
        const bool here = placed >= s0 && placed < s1;
        int nn = -1;
        if (lane == 0 && here) nn = placed;
        if (lane == 1 && A.ex_feats && rc >= s0 && rc < s1) nn = rc;
        float4 pre = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        Pair q = no_pair();
        if (nn >= 0) inputs(buf, al, nz, nn - s0, nn, nn == placed, pre, q);
        float lt = 0.0f;
        const float sv = total_of<K9>(A, pre, q, M, lp, lane == 0 && here,
                                      &lt);
        if (lane == 1 && nn >= 0) feature_row(pre, q);
        const float own_s = __shfl_sync(FULL, sv, 0);
        const float own_lt = __shfl_sync(FULL, lt, 0);
        if (A.ex_alts && lane == 0) {
            const unsigned* c5 = s_t5 + 32 * 2 * (ALT_K + 1);
            for (int r = 0; r <= ALT_K; ++r) {
                const int i = (int)c5[ALT_K + 1 + r];
                if (i != placed && top.i[ALT_K - 1] == NO_NODE)
                    top4_push(top, c5[r], i);
            }
            if (here) top4_push(top, fkey(own_s), placed);
        }
        if (K9) {
            lacc = s_lane[lane];
            lcnt = s_lcnt[lane];
            const int tp = (placed - s0) & 31;
            if (here && chosen_ok && lane == tp) {
                float acc = 0.0f;
                for (int j = tp; j < s1 - s0; j += 32)
                    if ((okbits[j >> 5] >> lane) & 1u)
                        acc = acc + (s0 + j == placed ? fabsf(own_lt)
                                                      : fabsf(s_lt[j]));
                lacc = acc;
            }
        }
    };
    if (staged && shared && X.resident)
        pods_shared(nodes);
    else if (staged)
        slice_sweep(A, X, g_tile, nodes, L, s0, s1, 2, pass2);
    else if (s1 > s0)
        pass2(nullptr, s0, s1 - s0);
    EPROF(3);
    {
        // the warp's top list and |term| sum over its slice, to the cluster
        unsigned ok[ALT_K];
        int oi[ALT_K];
        top4_warp(top, 32, ok, oi);
        const float part = warp_fsum(lacc);
        const int cn = __reduce_add_sync(FULL, lcnt);
        if (active && lane == 0) {
            unsigned* x = s_x2 + w * 12;
            for (int q = 0; q < ALT_K; ++q) {
                x[q] = ok[q];
                x[ALT_K + q] = (unsigned)oi[q];
            }
            x[8] = __float_as_uint(part);
            x[9] = (unsigned)cn;
        }
    }
    if (!inert) cl.sync();
    if (rank == 0 && active) {
        // lane r holds rank r's list; the merge and the rank-order fold
        Top4 t;
        top4_init(t);
        float part = 0.0f;
        unsigned cn = 0u;
        if (!inert && lane < X.cluster) {
            const unsigned* x = cl.map_shared_rank(s_x2, lane) + w * 12;
            for (int q = 0; q < ALT_K; ++q) {
                t.k[q] = x[q];
                t.i[q] = (int)x[ALT_K + q];
            }
            part = __uint_as_float(x[8]);
            cn = x[9];
        }
        if (A.ex_alts) {
            unsigned ok[ALT_K];
            int oi[ALT_K];
            top4_warp(t, X.cluster, ok, oi);
            if (lane == 0)
                for (int q = 0; q < ALT_K; ++q) {
                    const bool has = oi[q] != NO_NODE;
                    const float sc = has ? kfloat(ok[q]) : ALT_NONE;
                    A.alt_score[(size_t)b * ALT_K + q] = sc;
                    A.alt_row[(size_t)b * ALT_K + q] =
                        (has && sc > ALT_NONE * 0.5f) ? oi[q] : -1;
                }
        }
        if (K9) {
            float acc = __shfl_sync(FULL, part, 0);
            for (int r = 1; r < X.cluster; ++r)
                acc = acc + __shfl_sync(FULL, part, r);
            const int total = __reduce_add_sync(FULL, (int)cn);
            if (lane == 0) {
                A.lmag_part[b] = acc;
                A.lmag_cnt[b] = total;
            }
        }
    }
    EPROF(4);
    if (!inert) cl.sync();  // no CTA leaves while rank 0 reads its words
    if (!K9 || rank != 0) return;
    // the last rank-0 CTA folds the pods' sums (integer ticket, no float
    // atomics)
    __threadfence();
    __syncthreads();
    if (tid == 0)
        *s_flag = atomicAdd(A.done, 1u) == gridDim.x / X.cluster - 1 ? 1 : 0;
    __syncthreads();
    if (*s_flag == 0 || w != 0) return;
    __threadfence();
    float acc = 0.0f;
    long long cnt = 0;
    for (int p = lane; p < A.B; p += 32) {
        acc = acc + __ldcg(A.lmag_part + p);
        cnt += __ldcg(A.lmag_cnt + p);
    }
    acc = warp_fsum(acc);
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(FULL, cnt, o);
    if (lane == 0) {
        A.lmag_out[0] = acc / (float)(cnt > 1 ? cnt : 1);
        *A.done = 0u;
    }
    EPROF(5);
}

// ---------------------------------------------------------------- host

// pods a block and nodes a tile: the largest (16 pods, 256 nodes first)
// whose layout fits a block's shared memory; 0 when none does
extern "C" int auction_tiling(int lf, int R, int N, int* P, int* tn) {
    for (int p = MAX_P; p >= 1; p >>= 1)
        for (int t = 256; t >= 32; t >>= 1)
            if (block_layout(lf, p, t, R, N).bytes <= SMEM_MAX) {
                *P = p;
                *tn = t;
                return block_layout(lf, p, t, R, N).bytes;
            }
    return 0;
}

extern "C" int auction_score_argmax_launch(const AuctionArgs* args,
                                           int final_mode, void* stream) {
    AuctionArgs A = *args;
    if (!learned_net_ok(A.learned, K9_NARROW))
        return (int)cudaErrorInvalidValue;
    if (A.B < 1) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    int lf = final_mode ? 0 : learned_smem_floats(A.learned, MAX_P);
    int P = 0, tn = 0;
    int smem = auction_tiling(lf, A.R, A.N, &P, &tn);
    if (smem == 0) return (int)cudaErrorInvalidValue;
    void (*kernel)(AuctionArgs, int, int) =
        final_mode ? auction_final
                   : (A.learned.n_layers > 0 ? auction_bid<true>
                                             : auction_bid<false>);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(A.B + P - 1) / P, P * 32, smem, s>>>(A, P, tn);
    return (int)cudaGetLastError();
}

// the export pass's kernel and cluster launch for these arguments
static cudaError_t export_config(const AuctionArgs& A, const ExportPlan& X,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr,
                                 cudaLaunchConfig_t* cfg,
                                 void (**kernel)(AuctionArgs, ExportPlan)) {
    *kernel = A.learned.n_layers > 0 ? auction_export<true>
                                     : auction_export<false>;
    cudaError_t e = cudaFuncSetAttribute(
        *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, X.smem);
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3(X.ctas);
    cfg->blockDim = dim3(X.threads);
    cfg->dynamicSmemBytes = X.smem;
    cfg->stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = X.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    return e;
}

static int export_args_ok(const AuctionArgs& A) {
    return learned_net_ok(A.learned, K9_NARROW)
           && !(A.learned.n_layers > 0
                && (!A.lmag_part || !A.lmag_cnt || !A.done || !A.lmag_out))
           && !(A.ex_feats && !A.chosen_feat)
           && !(A.ex_alts && (!A.alt_row || !A.alt_score));
}

// the end-state export pass (auction_export above) of one auction launch:
// one cluster launch of the plan's grid; a plan that does not fit or a
// cluster the card refuses is an error, with no other launch in its place
extern "C" int auction_export_launch(const AuctionArgs* args, void* stream) {
    AuctionArgs A = *args;
    if (!export_args_ok(A)) return (int)cudaErrorInvalidValue;
    if (A.B < 1) return 0;
    ExportPlan X;
    if (!export_plan_of(learned_smem_floats(A.learned, MAX_P), A.R, A.N, A.B,
                        A.soft, A.learned.n_layers > 0, &X))
        return (int)cudaErrorInvalidValue;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg;
    void (*kernel)(AuctionArgs, ExportPlan);
    cudaError_t e = export_config(A, X, (cudaStream_t)stream, attr, &cfg,
                                  &kernel);
    if (e != cudaSuccess) return (int)e;
    e = cudaLaunchKernelEx(&cfg, kernel, A, X);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// how many of the export pass's clusters the card holds at once for these
// arguments (0: none; a negated CUDA error code when the card refuses the
// query or the plan does not fit)
extern "C" int auction_export_clusters(const AuctionArgs* args) {
    AuctionArgs A = *args;
    ExportPlan X;
    if (!learned_net_ok(A.learned, K9_NARROW)
            || !export_plan_of(learned_smem_floats(A.learned, MAX_P), A.R,
                               A.N, A.B > 0 ? A.B : 1, A.soft,
                               A.learned.n_layers > 0, &X))
        return -(int)cudaErrorInvalidValue;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg;
    void (*kernel)(AuctionArgs, ExportPlan);
    cudaError_t e = export_config(A, X, 0, attr, &cfg, &kernel);
    if (e != cudaSuccess) return -(int)e;
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return -(int)e;
    }
    return n;
}

#ifdef EXPORT_PROFILE
extern "C" int auction_read_export_profile(unsigned long long* out) {
    return (int)cudaMemcpyFromSymbol(out, exp_acc, sizeof(exp_acc));
}
#endif

#ifdef BID_PROFILE
extern "C" int auction_read_profile(unsigned long long* out) {
    return (int)cudaMemcpyFromSymbol(out, bid_acc, sizeof(bid_acc));
}
#endif

extern "C" int auction_args_size() { return (int)sizeof(AuctionArgs); }

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
