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
// once after the last round when a learned scorer or an export is on.
//
// No compiled caps: the resource columns walk A.R, the
// RequestedToCapacityRatio points are read from device arrays (shape_x,
// shape_y) of any length; a block's shared memory is the one limit
// (auction_tiling returns 0 past it and the launch is refused).
//
// Measurement build: -DBID_PROFILE adds the SM clock cycles of the bid
// kernel's phases (kernels/auction.py bid_profile).
//
// Built with -fmad=false: the totals round exactly as the twin's (and
// the reference's) separate multiplies and adds, so placements can be
// compared bit for bit.

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
// `pod_eval` against the end state): one warp a pod, the node tiles
// staged as in the bid kernel. Pass 1 marks the candidates (statics + fit
// against the end state (+ the ipa mask in soft mode), and the chosen
// node) and takes their normalizers; pass 2 forms each candidate's total
// with the pod's own committed non-zero request taken off its chosen
// node, keeps a running top ALT_K a lane (lane = node mod 32, ascending),
// the chosen row's (node 0's when unplaced) features, and a lane sum of
// |w_learned x term| over the end-state feasible nodes. Each pod's sum is
// the xor tree of its lanes; the last block to finish folds the pods'
// sums (lane t: pods t, t + 32, ... in order, then the xor tree) into
// learned_mag: the same operations in the same order as the twin
// (kernels/auction.py auction_export_ref), with no float atomics.
template <bool K9>
__global__ void __launch_bounds__(MAX_P * 32, BID_MIN_BLOCKS)
auction_export(AuctionArgs A, int P, int tn) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int lf = K9 ? learned_smem_floats(A.learned, MAX_P) : 0;
    const BlockLayout BL = block_layout(lf, P, tn, A.R, A.N);
    const TileLayout L = tile_layout(tn, A.R);
    float* s_req = reinterpret_cast<float*>(smem + BL.req);
    int* s_pod = reinterpret_cast<int*>(smem + BL.pods);
    unsigned* s_bits = reinterpret_cast<unsigned*>(smem + BL.bits);
    Pods K;
    K.np = select_pods(A, P, true, s_pod, s_pod + 32);
    const bool any = K.np > 0;
    K.tn = tn;
    K.W = (A.N + 31) / 32;
    K.g_tile = any ? A.gid[s_pod[0]] : 0;
    if constexpr (K9)
        learned_stage(A.learned, reinterpret_cast<float*>(smem));
    for (int i = tid; i < K.np * A.R; i += blockDim.x)
        s_req[i] = A.req[(size_t)s_pod[i / A.R] * A.R + i % A.R];
    __syncthreads();
    const bool active = w < K.np;
    const int b = active ? s_pod[w] : (any ? s_pod[0] : 0);
    const int g = any ? A.gid[b] : 0;
    const bool tiled = g == K.g_tile;
    const int own = A.nominated_row[b];
    const int placed = A.placed[b];
    const int rc = placed < 0 ? 0 : (placed > A.N - 1 ? A.N - 1 : placed);
    const float* rq = s_req + (active ? w : 0) * A.R;
    const size_t gN = (size_t)g * A.N;
    unsigned* bits = s_bits + w * K.W;
    float mt = -INFINITY, ma = -INFINITY;
    float imn = INFINITY, imx = -INFINITY, smn = INFINITY, smx = -INFINITY;
    bool chosen_ok = false;   // the chosen node is end-state feasible
    if (any)
    sweep(A, K, smem + BL.tiles, L, true, false, no_prep,
          [&](unsigned char* buf, int t) {
        if (!active) return;
        const float* tfree = reinterpret_cast<const float*>(buf + L.free);
        const float* tnom = reinterpret_cast<const float*>(buf + L.nom);
        const int n0 = t * tn;
        for (int j0 = 0; j0 < tn && n0 + j0 < A.N; j0 += 32) {
            const int j = j0 + lane, n = n0 + j;
            bool c = false;
            float tr = 0.0f, ar = 0.0f, il = 0.0f, sr = 0.0f;
            bool ig = false;
            if (n < A.N) {
                bool ok = tiled ? buf[L.ok + j] != 0 : A.static_ok[gN + n];
                if (ok && A.soft)
                    ok = tiled ? buf[L.ipa_ok + j] != 0 : A.ipa_ok[gN + n];
                ok = ok && fits(A, tfree, tnom, j, rq, own == n);
                if (n == placed) chosen_ok = ok;
                c = ok || n == placed;
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
            unsigned m = __ballot_sync(FULL, c);
            if (lane == 0) bits[(n0 + j0) >> 5] = m;
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
    });
    chosen_ok = __reduce_or_sync(FULL, chosen_ok ? 1u : 0u) != 0;
    const float tt = warp_max(mt), ta = warp_max(ma);
    const float i_mn = warp_min(imn), i_mx = warp_max(imx);
    const float s_mn = warp_min(smn), s_mx = warp_max(smx);
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
    const float nzq0 = A.nzreq[2 * b], nzq1 = A.nzreq[2 * b + 1];
    float* lp = reinterpret_cast<float*>(smem);
    float lacc = 0.0f;
    int lcnt = 0;
    Top4 top;
    top4_init(top);
    if (any)
    sweep(A, K, smem + BL.tiles, L, false, false, no_prep,
          [&](unsigned char* buf, int t) {
        if (!active) return;
        const int n0 = t * tn;
        const float* al = reinterpret_cast<const float*>(buf + L.alloc2);
        const float* nz = reinterpret_cast<const float*>(buf + L.nzr);
        for (int j0 = 0; j0 < tn && n0 + j0 < A.N; j0 += 32) {
            const int j = j0 + lane, n = n0 + j;
            const bool c = (bits[(n0 + j0) >> 5] >> lane) & 1u;
            const bool fe = A.ex_feats && n == rc && n < A.N;
            if (!c && !fe && !K9) continue;
            float4 pre = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            Pair q = no_pair();
            if (c || fe) {
                // the pod's own committed usage off its chosen node: the
                // fractions add the request back (pipeline.py :776-784)
                const bool mine = n == placed;
                const float z0 = mine ? nz[2 * j] - nzq0 : nz[2 * j];
                const float z1 = mine ? nz[2 * j + 1] - nzq1 : nz[2 * j + 1];
                pre = pre_of(A, al[2 * j], al[2 * j + 1], z0, z1, nzq0,
                             nzq1);
                if (tiled) {
                    q.t_raw = reinterpret_cast<const float*>(
                        buf + L.taint)[j];
                    q.a_raw = reinterpret_cast<const float*>(buf + L.aff)[j];
                    q.img = reinterpret_cast<const float*>(buf + L.img)[j];
                    if (A.soft) {
                        q.ipa_live = reinterpret_cast<const float*>(
                            buf + L.ipa_live)[j];
                        q.sp_r = reinterpret_cast<const float*>(
                            buf + L.sp_r)[j];
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
            }
            float lt = 0.0f;
            const float s = total_of<K9>(A, pre, q, M, lp, c, &lt);
            if (fe) {
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
            }
            if (!c) continue;
            if (K9 && (n != placed || chosen_ok)) {
                lacc = lacc + fabsf(lt);
                lcnt += 1;
            }
            if (A.ex_alts) top4_push(top, fkey(s), n);
        }
    });
    if (active) {
        if (A.ex_alts) {
            unsigned ok[ALT_K];
            int oi[ALT_K];
            top4_warp(top, 32, ok, oi);
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
            const float v = warp_fsum(lacc);
            const int cn = __reduce_add_sync(FULL, lcnt);
            if (lane == 0) {
                A.lmag_part[b] = v;
                A.lmag_cnt[b] = cn;
            }
        }
    }
    if (!K9) return;
    // the last block folds the pods' sums (integer ticket, no float
    // atomics)
    __threadfence();
    __syncthreads();
    if (tid == 0)
        s_pod[32 + 30] = atomicAdd(A.done, 1u) == gridDim.x - 1 ? 1 : 0;
    __syncthreads();
    if (s_pod[32 + 30] == 0 || w != 0) return;
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

// the end-state export pass (auction_export above) of one auction launch
extern "C" int auction_export_launch(const AuctionArgs* args, void* stream) {
    AuctionArgs A = *args;
    if (!learned_net_ok(A.learned, K9_NARROW)
            || (A.learned.n_layers > 0
                && (!A.lmag_part || !A.lmag_cnt || !A.done || !A.lmag_out))
            || (A.ex_feats && !A.chosen_feat)
            || (A.ex_alts && (!A.alt_row || !A.alt_score)))
        return (int)cudaErrorInvalidValue;
    if (A.B < 1) return 0;
    int lf = learned_smem_floats(A.learned, MAX_P);
    int P = 0, tn = 0;
    int smem = auction_tiling(lf, A.R, A.N, &P, &tn);
    if (smem == 0) return (int)cudaErrorInvalidValue;
    void (*kernel)(AuctionArgs, int, int) =
        A.learned.n_layers > 0 ? auction_export<true> : auction_export<false>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(A.B + P - 1) / P, P * 32, smem, (cudaStream_t)stream>>>(A, P,
                                                                      tn);
    return (int)cudaGetLastError();
}

#ifdef BID_PROFILE
extern "C" int auction_read_profile(unsigned long long* out) {
    return (int)cudaMemcpyFromSymbol(out, bid_acc, sizeof(bid_acc));
}
#endif

extern "C" int auction_args_size() { return (int)sizeof(AuctionArgs); }

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
