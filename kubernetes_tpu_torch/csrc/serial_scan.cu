// K3 serial_scan: the as-if-serial commit scan of one launch.
//
// Replaces: kubernetes_tpu/models/pipeline.py schedule_batch's serial
// path: `perturb_rows` (:1181), `port_conf` (:1186, ops/filters.py
// pod_pair_port_conflict :167), `queries` (:1193), `map_updates` (:1291),
// `body` (:1358, the hard-topology and no-topology branches, and the
// pct_nodes window :1418-1450) and the `lax.scan` over the batch (:1571).
// The twin is kubernetes_tpu_torch/kernels/scan.py:serial_scan_ref.
//
// What bounds it on an H100: the latency of one step, not bytes or
// operations. Step b + 1 reads the state step b's commit left, so the B
// steps run one after another; a step does ~40 operations a node over a
// few MB that stay on chip. A step costs its chain of dependent phases:
// the per-node filter, a reduction over the whole cluster, the per-node
// total, an argmax over the whole cluster, the commit; two of those
// cross SMs. The previous design (one cooperative grid over the card,
// carries in global memory, three grid barriers a step, thread 0 of
// every block folding all blocks' partials) took ~30 us a step.
//
// Design: ONE thread-block cluster (cudaLaunchKernelEx with a cluster
// dimension; 16 blocks where cudaOccupancyMaxActiveClusters allows the
// non-portable size, else 8), one block per SM, up to 512 threads a
// block. Block `rank` owns the contiguous node slice [rank * per,
// rank * per + per). kernels/scan.py:plan_scan lays out each block's
// dynamic shared memory (ScanArgs.off, one byte offset per PA_* array,
// -1: the array stays in global memory, read and written there by the
// same code):
//
//   - the slice's node-space carries (forbid1, map2, pres, wscore,
//     cnt_match) and its free / nzr rows, for the whole launch; only the
//     owning block ever writes a node's carries, so they need no
//     cross-block traffic; written back once at the end;
//   - the step scratch (feasible, live ipa and raw spread score a node);
//   - the group tables every step reads (m_terms, m_tsc, the *_tk
//     arrays, tpw, self_match, ...), staged once;
//   - the domain-space spread counts `live` [G, C, D] = t_cnt + cntmap
//     where exists_hard, +inf elsewhere, REPLICATED: every block applies
//     each commit's integer adds to its own copy (a per-block global copy
//     when it does not fit), so no barrier guards them;
//   - the slice's read-only rows (phase-1 mask and raw scores, topo_dom,
//     ign, el_node, match_static, dom_ok, anti_ok, ipa_raw, term_static,
//     has_lbl, nom, alloc2), staged once.
//
// When every array but `live` is in shared memory (ScanArgs.all_shared),
// the launch takes serial_scan_kernel<true, .>: every view derives from the
// shared base, so loads and stores compile to shared-memory instructions
// (the generic instantiation's views may point either way and cost
// generic loads), and the rows of [K, N, J] arrays with J > 1 (free, nom,
// topo_dom, match_static, ...) are stored [K, J, per], so a warp's
// neighbouring nodes fall in neighbouring banks.
//
// A step (pod b; its row was copied to shared memory with cp.async during
// step b - 1):
//   A. every block filters its nodes against its carries (feasible =
//      static_ok & ports_ok & fit_ok & spread_ok & ipa_ok), keeps the
//      per-node verdict and live scores in its scratch, and reduces the
//      normalizer statistics and the five counts (redux.sync on
//      order-preserving float keys, one shared slot a warp); warp 0
//      writes the block's slot into every rank's inbox (DSMEM stores);
//   cluster barrier 1, split: between its arrive and its wait, each thread
//   forms the part of its nodes' totals that no normalizer changes
//   (fractions, fit, balance, tie perturbation);
//   every warp folds the ranks' slots from its own inbox: every thread
//   holds the step's normalizers;
//   (window only: the ranks' feasible counts at / after the start row and
//   before it give each block its offsets in the rotated order, a block
//   scan ranks its feasible nodes, the first k_find are kept and the
//   statistics are reduced again over them and exchanged; barrier 2;)
//   B. every block forms each feasible node's total in the reference's
//      order and pushes its best (total, tie perturbation, node, NaN
//      flag; rank 0 also the total at node 0; the best node's topo_dom
//      and el_node rows) into every rank's inbox;
//   last cluster barrier of the step;
//   every warp folds the ranks' bests to the winner (highest total, then
//   highest perturbation, then lowest node; a NaN total picks node 0);
//   C. every block folds the commit into its slice's carries, through the
//      step's lists of the (group, term) pairs the commit matches and the
//      (group, constraint) rows it counts, and into its copy of the domain
//      counts (and, up to SMALL_D domains, the spread minima of the rows
//      it changed); the owner commits free / nzr, rank 0 writes the
//      pod's outputs.
// Step b + 1's phase A reads only the block's own carries, copies and
// inbox, so no barrier closes a step: two cluster barriers a step, three
// with the window. The inboxes are double-buffered by step parity.
//
// The in-batch hostPort clashes: port_conf [B, B] (wildcard IP semantics
// of types.go:1291) is filled by a separate ordinary launch over the whole
// card (port_conf_kernel) on the same stream before the scan; each block
// logs the commits that land in its slice and, at step b, stamps those
// with port_conf[b, j].
//
// The percentageOfNodesToScore window (ScanArgs.pct != 0): k_find =
// max(100, valid * pct / 100), the percent adaptive (max(5, 50 - valid /
// 125)) when pct is -1; the snap of the next start row to the first
// valid row in rotated order is a table `snap` [N] that the blocks fill
// for their slices once per launch.
//
// The learned score term (K9, learned_mlp.cuh; `learned.n_layers` > 0;
// the kernel's K9 instantiations, the launches without a scorer run ones
// with no K9 code): the front of every block's dynamic shared memory is
// K9's region (the narrow path's staged stack, or the wide path's warp
// slabs; none when those are in global scratch); phase B adds w_learned *
// learned_term(...) after w_ipa * ipa (:1458-1474), with that step's
// normalizers, every lane of a warp calling it together.
//
// Export outputs (the reference's body :1466-1474, :1511-1534,
// :1576-1589): with K9 each step also sums |w_learned x term| over its
// feasible nodes (a thread's nodes in order, the warps' xor trees, the
// ranks' in the best slot, folded by rank 0 over the valid pods in batch
// order); the EXP instantiation (the feature or the alternative export
// on) writes the chosen row's features from the thread that owns the row,
// before its commit, and the top ALT_K of the live totals: a running list
// a thread, merged a warp, a block and, through the best slot's DSMEM
// exchange, the cluster. The instantiations without EXP carry none of its
// code or shared bytes.
//
// No compiled caps: R, C and TK size the fixed front at launch
// (fixed_layout; at the reference's sizes, up to 32 requests, 16
// constraints and 32 keys, the front keeps one layout); the bit masks of
// a step's terms and constraints cover 0-30 and the rest are read from
// the tables; a front past a block's shared memory is refused by the
// wrapper (kernels/scan.py plan_fits).
//
// Exactness: every max / min is exact in any order (the float keys read
// a -0 as +0); counts are integers; the carry updates add integers
// (weights <= 100, hardPodAffinityWeight 1), far below 2^24; the score
// uses the twin's operations in the same order (built with -fmad=false;
// true divisions, never a reciprocal); the window's rank is a prefix
// across ranks in rotated order. Bool carries are kept as bytes.
//
// Measurement builds: -DSCAN_PROFILE adds the SM clock cycles of each
// phase (kernels/scan.py phase_profile); cluster_sync_probe and
// grid_sync_probe below time the two designs' barriers alone.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "learned_mlp.cuh"

namespace cg = cooperative_groups;

#define MAX_THREADS 512
#define MAX_WARPS 32
#define MAX_CLUSTER 16
#define FULL 0xffffffffu
#define NONE (-1)
#define RF 6            // float partials: max t, max a, min/max ipa,
                        // min/max sp
#define RI 7            // int partials: feasible, ports, fit, spread, ipa,
                        // pct window: feasible at/after start, before it
#define SLOT_WORDS 16   // one exchange slot of partials
#define BEST_HEAD 8     // a best slot's words before the node's rows
#define ALT_K 4         // the alternatives a pod exports
#define ALT_NONE (-1e9f)
#define NF 9            // features a row (ops/learned.py LEARNED_FEATURES)
#define NPT_REG 2       // nodes a thread keeps a Pre for in registers
#define SMALL_D 32      // up to this many domains, the spread minima are
                        // kept up to date at each commit
#define ADAPTIVE_PCT (-1)
#define MIN_FEASIBLE_NODES_TO_FIND 100
#define FIT_LEAST 0
#define FIT_MOST 1
#define FIT_RTCR 2
#define NO_NODE 0x7fffffff

// The arrays kernels/scan.py:plan_scan places (ScanArgs.off), in its
// priority order: node-space carries and the chain rows, step scratch,
// group tables, the replicated domain counts, read-only node rows.
// Mirrored by kernels/scan.py:PLACED (same names, same order).
enum {
    PA_FORBID1, PA_MAP2, PA_PRES, PA_WSCORE, PA_CNT_MATCH, PA_FREE, PA_NZR,
    PA_FEAS, PA_IPA, PA_SP, PA_FORB,
    PA_M_TERMS, PA_M_TSC, PA_ANTI_TK, PA_AFF_TK, PA_PAFF_TK, PA_PANTI_TK,
    PA_PAFF_W, PA_PANTI_W, PA_TSC_TK, PA_TSC_HARD, PA_TSC_SKEW, PA_TSC_MIND,
    PA_TPW, PA_SELF_MATCH, PA_NUM_DOMAINS, PA_HAS_SOFT, PA_AFF_SELF,
    PA_T_ANY_MATCH,
    PA_LIVE,
    PA_STATIC_OK, PA_TAINT_RAW, PA_AFF_RAW, PA_IMG, PA_TOPO_DOM, PA_IGN,
    PA_EL_NODE, PA_MATCH_STATIC, PA_DOM_OK, PA_ANTI_OK, PA_IPA_RAW,
    PA_TERM_STATIC, PA_HAS_LBL, PA_NOM, PA_ALLOC2,
    PA_COUNT
};

// Mirrored by kernels/scan.py:_ScanArgs (same members, same order).
struct ScanArgs {
    int N, B, R, G1, G, A, C, TK, D, HP;
    int topo, spread_on, ipa_on, fit_on, ports, wildcard_ip, fit_strategy,
        shape_n, pct;
    float weights[7];
    const float* shape_x;      // [shape_n] RequestedToCapacityRatio points
    const float* shape_y;      // [shape_n]
    unsigned int seed;
    // the cluster layout (kernels/scan.py:plan_scan)
    int cluster, threads, per, smem_bytes, fixed_bytes, all_shared;
    int off[PA_COUNT];
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
    // carries: zeroed by the wrapper; where placed in shared memory, the
    // final values are written back here at the end
    uint8_t* forbid1;          // [G, N]
    uint8_t* map2;             // [G, N]
    uint8_t* pres;             // [G, A, N]
    uint8_t* any3;             // [G]
    float* wscore;             // [G, N]
    float* cnt_match;          // [G, C, N]
    // global homes of what plan_scan left out of shared memory
    float* live_g;             // [cluster, G, C, D] replicated domain counts
    uint8_t* feas_g;           // [N] step scratch
    float* ipa_g;              // [N]
    float* sp_g;               // [N]
    int* forb_g;               // [N] port-clash stamps (ports only)
    // scratch
    const uint8_t* port_conf;  // [B, B] (port_conf_kernel)
    int* plog;                 // [cluster, B, 2] commits in each slice
    int* snap;                 // [N] first valid row in rotated order
    // outputs
    int* rows;                 // [B]
    float* win;                // [B]
    int* feas;                 // [B]
    int* rejects;              // [B, 4]
    // percentageOfNodesToScore window (pct != 0 only)
    const uint8_t* node_valid;  // [N]
    int* pct_start;            // [1] start row, updated in place
    // the learned score term (n_layers 0: none)
    LearnedNet learned;
    float w_learned;
    // the export outputs: each step's learned magnitude (with `learned`)
    // folded over the valid pods, and (the export instantiation) the
    // chosen row's features and the top ALT_K of the live totals
    int exp_feats, exp_alts;
    const uint8_t* pod_valid;  // [B]
    float* lmag_step;          // [B]
    float* lmag_sum;           // [1]
    float* chosen_feat;        // [B, NF]
    int* alt_row;              // [B, ALT_K]
    float* alt_score;          // [B, ALT_K]
};

// ---------------------------------------------------------------- layout

__host__ __device__ inline int a16(int x) { return (x + 15) & ~15; }

// The fixed front of a block's dynamic shared memory, in bytes; mirrored
// by kernels/scan.py:fixed_layout. Every size follows the launch's R, C
// and TK (no compiled cap); X is 1 for the export instantiation. in1 / in2
// / in3 are the inboxes of the three exchanges of a step (partials, the
// window's partials, bests), each [2 (step parity)][MAX_CLUSTER (sender
// rank)][slot words]; a best slot carries, after its BEST_HEAD words, the
// sender's top ALT_K (keys, then nodes; X only), its best node's topo_dom
// row (TK ints) and el_node row (G x C bytes). The per-warp reduction
// slots hold RF + RI + 4 + C rows; misc the commit's domain row, a scan
// scratch and two counts; a pod row 8 words and R requests; alts (X only)
// each warp's top ALT_K.
struct Fixed {
    int learned, in1, in2, in3, s3, wslot, wmin, misc, pod, el, tsc, mt,
        any3, mins, tl, hl, sg, alts, end;
};

__host__ __device__ inline int best_words(int G, int C, int TK, int X) {
    return (BEST_HEAD + X * 2 * ALT_K + TK + (G * C + 3) / 4 + 3) & ~3;
}

// misc: the scan scratch [MAX_WARPS], two counts (at fixed offsets),
// then the commit's domain row (TK words, room for 64 at least)
#define MISC_DOM (MAX_WARPS + 32)

__host__ __device__ inline int dom_words(int TK) {
    return TK > 64 ? (TK + 3) & ~3 : 64;
}

__host__ __device__ inline int misc_words(int TK) {
    return MISC_DOM + dom_words(TK);
}

// a step's pod row: 8 words, then the R requests (room for 32 at least)
__host__ __device__ inline int pod_words(int R) {
    const int r = R > 32 ? R : 32;
    return (8 + r + 3) & ~3;
}

// the per-warp rows of spread minima (room for 16 constraints at least):
// launches of the reference's sizes keep the layout of a 16-row front
__host__ __device__ inline int slot_c(int C) { return C > 16 ? C : 16; }

// the reference's sizes: a launch without K9 or the exports within them
// takes the narrow instantiation (no loops past bit 30 of a step's masks;
// a warp's minima rows and a step's pod row at their compile-time sizes,
// slot_c(NARROW_C) and pod_words(NARROW_R), which the layout gives such a
// launch)
#define NARROW_A 31
#define NARROW_C 16
#define NARROW_TK 64
#define NARROW_R 32

__host__ __device__ inline Fixed fixed_layout(int lf, int G, int A, int C,
                                              int TK, int R, int X) {
    Fixed f;
    f.learned = 0;
    f.in1 = lf * 4;
    f.in2 = f.in1 + 2 * MAX_CLUSTER * SLOT_WORDS * 4;
    f.in3 = f.in2 + 2 * MAX_CLUSTER * SLOT_WORDS * 4;
    f.s3 = best_words(G, C, TK, X);
    f.wslot = f.in3 + 2 * MAX_CLUSTER * f.s3 * 4;
    f.wmin = f.wslot + (RF + RI + 4 + slot_c(C)) * MAX_WARPS * 4;
    f.misc = f.wmin + MAX_WARPS * slot_c(C) * 4;
    f.pod = f.misc + misc_words(TK) * 4;
    f.el = f.pod + 2 * pod_words(R) * 4;
    f.tsc = f.el + a16(G * C);
    f.mt = f.tsc + a16(G * C);
    f.any3 = f.mt + a16(G * A);
    f.mins = f.any3 + a16(G);
    f.tl = f.mins + a16(G * C * 4);
    f.hl = f.tl + a16(G * A * 4);
    f.sg = f.hl + a16(G * C * 4);
    f.alts = f.sg + a16(G * 16);
    f.end = f.alts + X * 2 * ALT_K * MAX_WARPS * 4;
    return f;
}

// a block's dynamic shared memory (the layout above, then the planned
// arrays)
extern __shared__ __align__(16) unsigned char smem_raw[];

struct Blk {
    unsigned char* sm;
    int rank, lo, cnt, per;
};

// a block's view of a node-space array [K, N, J]: element (k, local node
// l, j) at p[((size_t)k * ld + l) * J + j], in shared memory (ld = per)
// or in global memory (ld = N, p offset to the slice)
template <typename T, bool TR = false>
struct NV {
    T* p;
    int ld;
    __device__ __forceinline__ T& at(int k, int l, int J, int j) const {
        // TR: the shared copy of a [K, N, J] array is stored [K, J, per]:
        // a warp's neighbouring nodes sit in neighbouring banks
        if (TR) return p[(k * J + j) * ld + l];
        return p[((size_t)k * ld + l) * J + j];
    }
    __device__ __forceinline__ T& at(int k, int l) const {
        return p[(size_t)k * ld + l];
    }
};

// SM: the launch placed every array but the domain counts in shared
// memory (ScanArgs.all_shared), so every view derives from smem_raw and
// compiles to shared-memory loads and stores
template <bool SM, typename T>
__device__ __forceinline__ NV<T, SM> nview(const ScanArgs& S, const Blk& X,
                                           int pa, const T* g, int J) {
    NV<T, SM> v;
    int off = S.off[pa];
    if (SM || off >= 0) {
        v.p = reinterpret_cast<T*>(smem_raw + off);
        v.ld = X.per;
    } else {
        v.p = const_cast<T*>(g) + (size_t)X.lo * J;
        v.ld = S.N;
    }
    return v;
}

template <bool SM, typename T>
__device__ __forceinline__ const T* tview(const ScanArgs& S, const Blk& X,
                                          int pa, const T* g) {
    int off = S.off[pa];
    if (SM) return reinterpret_cast<const T*>(smem_raw + off);
    return off >= 0 ? reinterpret_cast<const T*>(smem_raw + off) : g;
}

__device__ __forceinline__ float* live_view(const ScanArgs& S,
                                            const Blk& X) {
    int off = S.off[PA_LIVE];
    return off >= 0 ? reinterpret_cast<float*>(X.sm + off)
                    : S.live_g + (size_t)X.rank * S.G * S.C * S.D;
}

// block-cooperative byte copy (16- or 4-byte words where aligned)
__device__ void copy_bytes(void* dst, const void* src, size_t n) {
    const int tid = threadIdx.x, T = blockDim.x;
    uintptr_t a = (uintptr_t)dst | (uintptr_t)src | (uintptr_t)n;
    if ((a & 15) == 0) {
        int4* d = reinterpret_cast<int4*>(dst);
        const int4* s = reinterpret_cast<const int4*>(src);
        for (size_t i = tid; i < n / 16; i += T) d[i] = s[i];
    } else if ((a & 3) == 0) {
        int* d = reinterpret_cast<int*>(dst);
        const int* s = reinterpret_cast<const int*>(src);
        for (size_t i = tid; i < n / 4; i += T) d[i] = s[i];
    } else {
        unsigned char* d = reinterpret_cast<unsigned char*>(dst);
        const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
        for (size_t i = tid; i < n; i += T) d[i] = s[i];
    }
}

// stage (or, with `back`, write back) the block's slice of a placed
// node-space array [K, N, J] of `es`-byte elements
__device__ void stage_node(const ScanArgs& S, const Blk& X, int pa,
                           const void* g, int K, int J, int es, bool back) {
    int off = S.off[pa];
    if (off < 0 || K == 0) return;
    if (S.all_shared && J > 1) {
        // the shared copy is stored [K, J, per] (NV<T, true>)
        const size_t n = (size_t)K * X.cnt * J;
        for (size_t i = threadIdx.x; i < n; i += blockDim.x) {
            const int k = (int)(i / ((size_t)X.cnt * J));
            const int r = (int)(i - (size_t)k * X.cnt * J);
            const int l = r / J, j = r - l * J;
            const size_t gi = ((size_t)k * S.N + X.lo + l) * J + j;
            const size_t si = ((size_t)k * J + j) * X.per + l;
            if (es == 4) {
                int* sm = reinterpret_cast<int*>(X.sm + off);
                int* gm = reinterpret_cast<int*>(const_cast<void*>(g));
                if (back) gm[gi] = sm[si];
                else sm[si] = gm[gi];
            } else {
                uint8_t* sm = X.sm + off;
                uint8_t* gm = reinterpret_cast<uint8_t*>(const_cast<void*>(g));
                if (back) gm[gi] = sm[si];
                else sm[si] = gm[gi];
            }
        }
        return;
    }
    const size_t row = (size_t)X.cnt * J * es;
    for (int k = 0; k < K; ++k) {
        unsigned char* s = X.sm + off + (size_t)k * X.per * J * es;
        unsigned char* gp = (unsigned char*)g
                            + ((size_t)k * S.N + X.lo) * J * es;
        if (back) copy_bytes(gp, s, row);
        else copy_bytes(s, gp, row);
    }
}

__device__ void stage_table(const ScanArgs& S, const Blk& X, int pa,
                            const void* g, size_t bytes) {
    int off = S.off[pa];
    if (off >= 0 && bytes > 0) copy_bytes(X.sm + off, g, bytes);
}

__device__ void zero_node(const ScanArgs& S, const Blk& X, int pa, int K,
                          int es) {
    int off = S.off[pa];
    if (off < 0) return;
    size_t n = (size_t)K * X.per * es;
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) X.sm[off + i] = 0;
}

// ---------------------------------------------------------------- scores

// jnp.interp with constant extrapolation, same operations; not inlined:
// only RequestedToCapacityRatio launches call it, and its loads of the
// shape's device arrays would otherwise sit in every pre_of
__device__ __noinline__ float interp(const ScanArgs& S, float x) {
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

// does candidate (s, p, i) beat the best so far (bs, bp, bi)?
__device__ __forceinline__ bool better(float s, float p, int i, float bs,
                                       float bp, int bi) {
    if (i == NO_NODE) return false;
    if (bi == NO_NODE) return true;
    if (s != bs) return s > bs;
    if (p != bp) return p > bp;
    return i < bi;
}

// the normalizers of one step
struct Norms {
    float top_t, scale_a, ipa_mn, ipa_diff, sp_mn, sp_mx;
    bool ipa_ok, sp_ok, soft;
};

__device__ __forceinline__ Norms norms_of(const float* v, bool soft) {
    Norms M;
    float tt = v[0], ta = v[1];
    M.top_t = (isfinite(tt) && tt > 0.0f) ? tt : 1.0f;
    float top_a = (isfinite(ta) && ta > 0.0f) ? ta : 1.0f;
    M.scale_a = 100.0f / top_a;
    M.ipa_mn = v[2];
    M.ipa_diff = v[3] - v[2];
    M.ipa_ok = isfinite(M.ipa_diff) && M.ipa_diff > 0.0f;
    M.sp_mn = v[4];
    M.sp_mx = v[5];
    M.sp_ok = isfinite(M.sp_mx) && M.sp_mx > 0.0f;
    M.soft = soft;
    return M;
}

// what a node's total needs that no normalizer changes: the utilization
// fractions, fit and balance scores and the tie perturbation
struct Pre {
    float f0, f1, fit, bal, p;
};

__device__ __forceinline__ Pre pre_of(const ScanArgs& S, float a0, float a1,
                                      float nz0, float nz1, float nzq0,
                                      float nzq1) {
    Pre q;
    float f0 = frac_of(nz0 + nzq0, a0);
    float f1 = frac_of(nz1 + nzq1, a1);
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
    q.f0 = f0;
    q.f1 = f1;
    q.fit = fit;
    q.bal = (1.0f - sqrtf((d0 * d0 + d1 * d1) / 2.0f)) * 100.0f;
    return q;
}

// the weighted total of a node from its Pre, in the reference's order;
// `lp` is the block's K9 region. With K9, every lane of the warp calls it
// together (K9's wide path shares the warp); `live` false: no node, the
// total is not used
// the normalized taint, affinity, ipa and spread scores of a node
// (ops/scores.py normalize_inverse, normalize_max, normalize_maxmin,
// normalize_spread; true divisions)
struct Terms {
    float taint, aff, ipa, spread;
};

__device__ __forceinline__ Terms terms_from(const Norms& M, float t_raw,
                                            float a_raw, float ipa_live,
                                            float sp_r, bool ign) {
    Terms r;
    r.taint = (1.0f - t_raw / M.top_t) * 100.0f;
    r.aff = a_raw * M.scale_a;
    r.ipa = M.ipa_ok ? (100.0f * (ipa_live - M.ipa_mn)) / M.ipa_diff : 0.0f;
    r.spread = 0.0f;
    if (M.soft && !ign)
        r.spread = M.sp_ok
                       ? (100.0f * ((M.sp_mx + M.sp_mn) - sp_r)) / M.sp_mx
                       : 100.0f;
    return r;
}

// `lt` (if set) gets the weighted learned term w_learned x term, the
// total's last addend
template <bool K9>
__device__ __forceinline__ float total_from(const ScanArgs& S,
                                            const Norms& M, const Pre& q,
                                            float t_raw, float a_raw,
                                            float img, float ipa_live,
                                            float sp_r, bool ign, float* lp,
                                            bool live, float* lt = nullptr) {
    const float fit = q.fit, bal = q.bal;
    const Terms r = terms_from(M, t_raw, a_raw, ipa_live, sp_r, ign);
    const float taint = r.taint, aff = r.aff, ipa = r.ipa,
                spread = r.spread;
    const float* w = S.weights;
    float t = w[0] * taint;
    t = t + w[1] * aff;
    t = t + w[2] * fit;
    t = t + w[3] * bal;
    t = t + w[4] * img;
    t = t + w[5] * spread;
    t = t + w[6] * ipa;
    if constexpr (K9) {
        const long slot = (long)cg::this_cluster().block_rank()
                              * (blockDim.x >> 5) + (threadIdx.x >> 5);
        const float wl = S.w_learned
                         * learned_term<LEARNED_NARROW_MAX>(
                             S.learned, lp, slot, live, q.f0, q.f1, fit,
                             bal, taint, aff, img, spread, ipa);
        t = t + wl;
        if (lt) *lt = wl;
    }
    return t;
}

// ---------------------------------------------------------------- topology

// the block's views of the group tables
struct Tabs {
    const uint8_t *m_terms, *m_tsc, *tsc_hard, *has_soft, *aff_self,
        *t_any_match;
    const int *anti_tk, *aff_tk, *paff_tk, *panti_tk, *tsc_tk, *tsc_skew,
        *tsc_mind, *num_domains;
    const float *paff_w, *panti_w, *tpw, *self_match;
};

template <bool SM>
__device__ __forceinline__ Tabs tabs_of(const ScanArgs& S, const Blk& X) {
    Tabs t;
    t.m_terms = tview<SM>(S, X, PA_M_TERMS, S.m_terms);
    t.m_tsc = tview<SM>(S, X, PA_M_TSC, S.m_tsc);
    t.anti_tk = tview<SM>(S, X, PA_ANTI_TK, S.anti_tk);
    t.aff_tk = tview<SM>(S, X, PA_AFF_TK, S.aff_tk);
    t.paff_tk = tview<SM>(S, X, PA_PAFF_TK, S.paff_tk);
    t.panti_tk = tview<SM>(S, X, PA_PANTI_TK, S.panti_tk);
    t.paff_w = tview<SM>(S, X, PA_PAFF_W, S.paff_w);
    t.panti_w = tview<SM>(S, X, PA_PANTI_W, S.panti_w);
    t.tsc_tk = tview<SM>(S, X, PA_TSC_TK, S.tsc_tk);
    t.tsc_hard = tview<SM>(S, X, PA_TSC_HARD, S.tsc_hard);
    t.tsc_skew = tview<SM>(S, X, PA_TSC_SKEW, S.tsc_skew);
    t.tsc_mind = tview<SM>(S, X, PA_TSC_MIND, S.tsc_mind);
    t.tpw = tview<SM>(S, X, PA_TPW, S.tpw);
    t.self_match = tview<SM>(S, X, PA_SELF_MATCH, S.self_match);
    t.num_domains = tview<SM>(S, X, PA_NUM_DOMAINS, S.num_domains);
    t.has_soft = tview<SM>(S, X, PA_HAS_SOFT, S.has_soft);
    t.aff_self = tview<SM>(S, X, PA_AFF_SELF, S.aff_self);
    t.t_any_match = tview<SM>(S, X, PA_T_ANY_MATCH, S.t_any_match);
    return t;
}

__device__ __forceinline__ int m_term(const ScanArgs& S, const Tabs& T,
                                      int k, int x, int a, int y) {
    return T.m_terms[(((size_t)k * S.G + x) * S.A + a) * S.G + y];
}

// the block's views of the node-space topology arrays
template <bool SM>
struct TopoV {
    NV<uint8_t, SM> forbid1, map2, pres, ign, el_node, dom_ok, anti_ok,
        term_static, has_lbl;
    NV<float, SM> wscore, cnt_match, match_static, ipa_raw;
    NV<int, SM> topo_dom;
};

template <bool SM>
__device__ __forceinline__ TopoV<SM> topo_views(const ScanArgs& S,
                                                const Blk& X) {
    TopoV<SM> v;
    v.forbid1 = nview<SM>(S, X, PA_FORBID1, (const uint8_t*)S.forbid1, 1);
    v.map2 = nview<SM>(S, X, PA_MAP2, (const uint8_t*)S.map2, 1);
    v.pres = nview<SM>(S, X, PA_PRES, (const uint8_t*)S.pres, 1);
    v.wscore = nview<SM>(S, X, PA_WSCORE, (const float*)S.wscore, 1);
    v.cnt_match = nview<SM>(S, X, PA_CNT_MATCH, (const float*)S.cnt_match, 1);
    v.ign = nview<SM>(S, X, PA_IGN, S.ign, 1);
    v.el_node = nview<SM>(S, X, PA_EL_NODE, S.el_node, S.C);
    v.match_static = nview<SM>(S, X, PA_MATCH_STATIC, S.match_static, S.C);
    v.dom_ok = nview<SM>(S, X, PA_DOM_OK, S.dom_ok, S.C);
    v.anti_ok = nview<SM>(S, X, PA_ANTI_OK, S.anti_ok, 1);
    v.ipa_raw = nview<SM>(S, X, PA_IPA_RAW, S.ipa_raw, 1);
    v.term_static = nview<SM>(S, X, PA_TERM_STATIC, S.term_static, S.A);
    v.has_lbl = nview<SM>(S, X, PA_HAS_LBL, S.has_lbl, S.A);
    v.topo_dom = nview<SM>(S, X, PA_TOPO_DOM, S.topo_dom, S.TK);
    return v;
}

// what a step's pod group g selects of the group tables, as bits: the
// used required-affinity terms, the used hard and soft spread constraints.
// Bits 0-30 are terms or constraints 0-30; bit 31 says that one at index
// 31 or past is used, which the loops then read from the tables
// (aff_used_at, hard_at, soft_at), so a mask is non-zero exactly when
// something is used
#define HI_BIT 31

struct StepG {
    unsigned aff_used, hard, soft_c;
    bool any_match, aff_self;
};

__device__ __forceinline__ StepG step_of(const ScanArgs& S, const Tabs& T,
                                         const uint8_t* any3, int g) {
    StepG q;
    q.aff_used = q.hard = q.soft_c = 0;
    for (int a = 0; a < S.A; ++a)
        if (T.aff_tk[g * S.A + a] != NONE)
            q.aff_used |= 1u << (a < HI_BIT ? a : HI_BIT);
    for (int c = 0; c < S.C; ++c) {
        int gc = g * S.C + c;
        if (T.tsc_tk[gc] == NONE) continue;
        const unsigned bit = 1u << (c < HI_BIT ? c : HI_BIT);
        if (T.tsc_hard[gc]) q.hard |= bit;
        else q.soft_c |= bit;
    }
    q.any_match = T.t_any_match[g] || any3[g];
    q.aff_self = T.aff_self[g] != 0;
    return q;
}

__device__ __forceinline__ bool aff_used_at(const ScanArgs& S,
                                            const Tabs& T, const StepG& Q,
                                            int g, int a) {
    return a < HI_BIT ? ((Q.aff_used >> a) & 1u) != 0
                      : T.aff_tk[g * S.A + a] != NONE;
}

__device__ __forceinline__ bool hard_at(const Tabs& T, const StepG& Q,
                                        int gc, int c) {
    return c < HI_BIT ? ((Q.hard >> c) & 1u) != 0
                      : (T.tsc_tk[gc] != NONE && T.tsc_hard[gc] != 0);
}

__device__ __forceinline__ bool soft_at(const Tabs& T, const StepG& Q,
                                        int gc, int c) {
    return c < HI_BIT ? ((Q.soft_c >> c) & 1u) != 0
                      : (T.tsc_tk[gc] != NONE && T.tsc_hard[gc] == 0);
}

// is hard constraint c of the step's group used? (the narrow
// instantiation: always bit c)
template <bool NW>
__device__ __forceinline__ bool hard_of(const Tabs& T, const StepG& Q,
                                        int gc, int c) {
    return NW ? ((Q.hard >> c) & 1u) != 0 : hard_at(T, Q, gc, c);
}

// per-step verdicts of a group-g pod on local node l (pipeline.py queries)
template <bool SM, bool NW>
__device__ __forceinline__ void queries(const ScanArgs& S, const Tabs& T,
                                        const TopoV<SM>& V, const StepG& Q,
                                        int g, int l, const float* min_cnt,
                                        bool* ipa_ok, bool* sp_ok,
                                        float* sp_r, float* ipa_live) {
    bool pods_exist = true, all_lbl = true;
    auto term = [&](int a) {
        bool term_ok = V.term_static.at(g, l, S.A, a)
                       || V.pres.at(g * S.A + a, l);
        if (!term_ok) pods_exist = false;
        if (!V.has_lbl.at(g, l, S.A, a)) all_lbl = false;
    };
    // the step's bit masks cover terms and constraints 0-30 (the loops
    // every launch of the reference's sizes runs); the rest are read from
    // the tables
    const int a_lo = NW || S.A < HI_BIT ? S.A : HI_BIT;
    const int c_lo = NW || S.C < HI_BIT ? S.C : HI_BIT;
    for (int a = 0; a < a_lo; ++a)
        if ((Q.aff_used >> a) & 1u) term(a);
    if (!NW)
        for (int a = HI_BIT; a < S.A; ++a)
            if (aff_used_at(S, T, Q, g, a)) term(a);
    bool self_ok = Q.aff_self && !Q.any_match && all_lbl;
    bool aff_ok = Q.aff_used ? (pods_exist || self_ok) : true;
    *ipa_ok = V.anti_ok.at(g, l) && !V.forbid1.at(g, l) && !V.map2.at(g, l)
              && aff_ok;
    bool ok = true;
    float acc = 0.0f;
    auto spread = [&](int c, bool hard, bool soft) {
        int gc = g * S.C + c;
        float per_c = 0.0f;
        if (hard || soft) {
            float match_num = V.match_static.at(g, l, S.C, c)
                              + V.cnt_match.at(gc, l);
            float max_skew = (float)T.tsc_skew[gc];
            bool dok = V.dom_ok.at(g, l, S.C, c) != 0;
            if (hard) {
                float skew = (match_num + T.self_match[gc]) - min_cnt[c];
                if (!(dok && skew <= max_skew)) ok = false;
            } else if (dok) {
                per_c = match_num * T.tpw[gc] + (max_skew - 1.0f);
            }
        }
        acc = c == 0 ? per_c : acc + per_c;
    };
    for (int c = 0; c < c_lo; ++c)
        spread(c, (Q.hard >> c) & 1u, (Q.soft_c >> c) & 1u);
    if (!NW)
        for (int c = HI_BIT; c < S.C; ++c) {
            const int gc = g * S.C + c;
            spread(c, hard_at(T, Q, gc, c), soft_at(T, Q, gc, c));
        }
    *sp_ok = ok;
    *sp_r = V.ign.at(g, l) ? 0.0f : acc;
    *ipa_live = V.ipa_raw.at(g, l) + V.wscore.at(g, l);
}

// does local node l share the committed node's domain under key tk?
template <bool SM>
__device__ __forceinline__ bool same_dom(const NV<int, SM>& td, int l,
                                         int TK, const int* dom_row,
                                         int tk) {
    if (tk == NONE) return false;
    int d = dom_row[tk];
    return d != NONE && td.at(0, l, TK, tk) == d;
}

// fold the commit of a group-g pod (domain row dom_row) into local node
// l's carries (pipeline.py map_updates, node-space part). The step's term
// list tl[0..tln) holds, in ascending order, the (gp, a) = gp * A + a
// whose eight term matches against the commit (bits of mt) are not all
// false; the hit list hl[0..hln) the (gp, c) = gp * C + c whose spread
// constraint counts the commit. Every other (gp, a) and (gp, c) leaves the
// node's carries as they are (wscore gains j + bs = +0, and never holds a
// -0).
template <bool SM>
__device__ __forceinline__ void map_updates_node(
        const ScanArgs& S, const Tabs& T, const TopoV<SM>& V, int g, int l,
        const int* dom_row, const int* tl, int tln, const int* hl, int hln,
        const uint8_t* mt) {
    const int TK = S.TK, A = S.A;
    int e = 0;
    while (e < tln) {
        const int gp = tl[e] / A;
        bool f1 = false, f2 = false;
        float j = 0.0f, bs = 0.0f;
        for (; e < tln && tl[e] / A == gp; ++e) {
            const int pa = tl[e], a = pa - gp * A, ga = g * A + a;
            const int m = mt[pa];
            // the committed pod's own terms (j side)
            if ((m & 1)
                    && same_dom(V.topo_dom, l, TK, dom_row, T.anti_tk[ga]))
                f1 = true;
            if ((m & 2)
                    && same_dom(V.topo_dom, l, TK, dom_row, T.aff_tk[ga]))
                j = j + 1.0f;
            if ((m & 4)
                    && same_dom(V.topo_dom, l, TK, dom_row, T.paff_tk[ga]))
                j = j + T.paff_w[ga];
            if ((m & 8)
                    && same_dom(V.topo_dom, l, TK, dom_row, T.panti_tk[ga]))
                j = j - T.panti_w[ga];
            // each group's own terms vs the committed pod (b side)
            if ((m & 16)
                    && same_dom(V.topo_dom, l, TK, dom_row, T.anti_tk[pa]))
                f2 = true;
            if ((m & 32)
                    && same_dom(V.topo_dom, l, TK, dom_row, T.aff_tk[pa]))
                V.pres.at(pa, l) = 1;
            if ((m & 64)
                    && same_dom(V.topo_dom, l, TK, dom_row, T.paff_tk[pa]))
                bs = bs + T.paff_w[pa];
            if ((m & 128)
                    && same_dom(V.topo_dom, l, TK, dom_row, T.panti_tk[pa]))
                bs = bs - T.panti_w[pa];
        }
        if (f1) V.forbid1.at(gp, l) = 1;
        if (f2) V.map2.at(gp, l) = 1;
        // integer-valued: exact in any grouping
        const float add = j + bs;
        if (add != 0.0f) V.wscore.at(gp, l) = V.wscore.at(gp, l) + add;
    }
    for (int h = 0; h < hln; ++h) {
        const int gc = hl[h];
        if (same_dom(V.topo_dom, l, TK, dom_row, T.tsc_tk[gc]))
            V.cnt_match.at(gc, l) += 1.0f;
    }
}

// the spread minimum of hard constraint row gc = gp * C + c over a block's
// copy of the live counts (0 when no domain exists, or when minDomains
// exceeds the constraint's domain count)
__device__ __forceinline__ float row_min(const ScanArgs& S, const Tabs& T,
                                         const float* live, int gc) {
    float m = INFINITY;
    for (int d = 0; d < S.D; ++d) m = fminf(m, live[(size_t)gc * S.D + d]);
    float mc = isfinite(m) ? m : 0.0f;
    if (T.tsc_mind[gc] > 0 && T.num_domains[gc] < T.tsc_mind[gc]) mc = 0.0f;
    return mc;
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

// the in-batch hostPort conflict matrix, an ordinary launch over the card
__global__ void port_conf_kernel(ScanArgs S, uint8_t* port_conf) {
    long total = (long)S.B * S.B;
    for (long p = (long)blockIdx.x * blockDim.x + threadIdx.x; p < total;
         p += (long)gridDim.x * blockDim.x)
        port_conf[p] = port_conflict(S, (int)(p / S.B), (int)(p % S.B)) ? 1
                                                                        : 0;
}

// ---------------------------------------------------------------- warps

__device__ __forceinline__ bool is_min_slot(int k) { return k == 2 || k == 4; }

// order-preserving keys of floats (a -0 read as +0): the max / min of keys
// is the key of the max / min of the floats (NaN aside), so one redux.sync
// folds a warp
__device__ __forceinline__ unsigned fkey(float f) {
    unsigned u = __float_as_uint(f == 0.0f ? 0.0f : f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float kfloat(unsigned k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

#include "export_tails.cuh"

#define KEY_NEG_INF 0x007fffffu  // fkey(-INFINITY)
#define KEY_POS_INF 0xff800000u  // fkey(INFINITY)

__device__ __forceinline__ unsigned key_ident(int q) {
    return is_min_slot(q) ? KEY_POS_INF : KEY_NEG_INF;
}

// every lane gets the warp's fold: RF statistics as keys (slots 2 and 4
// minima, the rest maxima), NI integer sums
template <int NI>
__device__ __forceinline__ void warp_partials(unsigned* k, int* v) {
#pragma unroll
    for (int q = 0; q < RF; ++q)
        k[q] = is_min_slot(q) ? __reduce_min_sync(FULL, k[q])
                              : __reduce_max_sync(FULL, k[q]);
#pragma unroll
    for (int q = 0; q < NI; ++q) v[q] = __reduce_add_sync(FULL, v[q]);
}

// a (total, tie perturbation, node) best and a NaN flag, folded over the
// warp with K2's rule: highest total, then highest perturbation, then
// lowest node; tk is the total's key, 0 for no candidate
__device__ __forceinline__ void warp_best(unsigned* tk, unsigned* pk,
                                          int* i, int* nan) {
    unsigned m1 = __reduce_max_sync(FULL, *tk);
    unsigned p = *tk == m1 ? *pk : 0u;
    unsigned m2 = __reduce_max_sync(FULL, p);
    unsigned n = (*tk == m1 && p == m2 && *i != NO_NODE) ? (unsigned)*i
                                                        : (unsigned)NO_NODE;
    *i = (int)__reduce_min_sync(FULL, n);
    *tk = m1;
    *pk = m2;
    *nan = (int)__reduce_or_sync(FULL, (unsigned)*nan);
}

// block partials of every thread's vf[RF] and vi[NI], into `slot` (RF
// keys, then NI sums); the calling block's warp 0 holds them after
__device__ __forceinline__ void keys_of(const float* vf, unsigned* k) {
#pragma unroll
    for (int q = 0; q < RF; ++q) k[q] = fkey(vf[q]);
}

template <int NI>
__device__ __forceinline__ void block_partials(const float* vf, int* vi,
                                               int* wslot, int* slot) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    unsigned k[RF];
    keys_of(vf, k);
    warp_partials<NI>(k, vi);
    if (lane == 0) {
#pragma unroll
        for (int q = 0; q < RF; ++q) wslot[q * MAX_WARPS + w] = (int)k[q];
#pragma unroll
        for (int q = 0; q < NI; ++q) wslot[(RF + q) * MAX_WARPS + w] = vi[q];
    }
    __syncthreads();
    if (w == 0) {
        int iv[NI];
#pragma unroll
        for (int q = 0; q < RF; ++q)
            k[q] = lane < nw ? (unsigned)wslot[q * MAX_WARPS + lane]
                             : key_ident(q);
#pragma unroll
        for (int q = 0; q < NI; ++q)
            iv[q] = lane < nw ? wslot[(RF + q) * MAX_WARPS + lane] : 0;
        warp_partials<NI>(k, iv);
        if (lane == 0) {
#pragma unroll
            for (int q = 0; q < RF; ++q) slot[q] = (int)k[q];
#pragma unroll
            for (int q = 0; q < NI; ++q) slot[RF + q] = iv[q];
        }
    }
}

// warp 0 of the sender: its slot (`words` words at own, the block's own
// entry of this step's inbox) into every other rank's inbox at the same
// offset (DSMEM stores; the cluster barrier that follows makes them
// visible)
__device__ __forceinline__ void push_slot(cg::cluster_group& cl,
                                          const int* own, int words,
                                          int rank, int CB) {
    const int lane = threadIdx.x & 31;
    __syncwarp();
    if (lane < CB && lane != rank) {
        int4* dst = reinterpret_cast<int4*>(
            cl.map_shared_rank(const_cast<int*>(own), lane));
        const int4* src = reinterpret_cast<const int4*>(own);
        for (int q = 0; q < words / 4; ++q) dst[q] = src[q];
    }
}

// every warp folds the ranks' partial slots of its own inbox (`box`,
// [MAX_CLUSTER][SLOT_WORDS]): nv[RF] the statistics, iv[NI] the sums;
// with `ranks`, pre5 / pre6 get the sums of int slots 5 and 6 over the
// ranks before `rank`
template <int NI>
__device__ __forceinline__ void fold_partials(const int* box, int CB,
                                              int rank, float* nv, int* iv,
                                              int* pre5, int* pre6,
                                              bool ranks) {
    const int lane = threadIdx.x & 31;
    unsigned k[RF];
    if (lane < CB) {
        const int* w = box + lane * SLOT_WORDS;
#pragma unroll
        for (int q = 0; q < RF; ++q) k[q] = (unsigned)w[q];
#pragma unroll
        for (int q = 0; q < NI; ++q) iv[q] = w[RF + q];
    } else {
#pragma unroll
        for (int q = 0; q < RF; ++q) k[q] = key_ident(q);
#pragma unroll
        for (int q = 0; q < NI; ++q) iv[q] = 0;
    }
    if (NI > 6 && ranks) {
        int h = iv[NI > 6 ? 5 : 0], l = iv[NI > 6 ? 6 : 0], ih = h, il = l;
        for (int o = 1; o < 32; o <<= 1) {
            int y = __shfl_up_sync(FULL, ih, o);
            int z = __shfl_up_sync(FULL, il, o);
            if (lane >= o) {
                ih += y;
                il += z;
            }
        }
        *pre5 = __shfl_sync(FULL, ih - h, rank);
        *pre6 = __shfl_sync(FULL, il - l, rank);
    }
    warp_partials<NI>(k, iv);
#pragma unroll
    for (int q = 0; q < RF; ++q) nv[q] = kfloat(k[q]);
}

// the two halves of a cluster barrier, for work between them that reads
// and writes only the block's own data
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

// word i of pod b's row in the pod buffer (pod_words): 0 g1, 1 gid, 2 the
// nominated row, 3 uid, 4-5 nzreq, 8.. req; nullptr for a pad word
__device__ __forceinline__ const int* pod_word(const ScanArgs& S, int b,
                                               int i) {
    switch (i) {
        case 0: return S.g1 + b;
        case 1: return S.topo ? S.gid + b : S.g1 + b;
        case 2: return S.nominated_row + b;
        case 3: return S.uid + b;
        case 4: return reinterpret_cast<const int*>(S.nzreq + 2 * b);
        case 5: return reinterpret_cast<const int*>(S.nzreq + 2 * b + 1);
        case 6:
        case 7: return nullptr;
        default:
            return reinterpret_cast<const int*>(S.req + (size_t)b * S.R
                                                + (i - 8));
    }
}

// exclusive block scan of v in thread order; *total = the block's sum
__device__ int block_excl_scan(int v, int* s_tmp, int* total) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
        int y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) s_tmp[wid] = x;
    __syncthreads();
    int w = lane < nw ? s_tmp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
        int y = __shfl_up_sync(FULL, w, o);
        if (lane >= o) w += y;
    }
    int before = wid > 0 ? __shfl_sync(FULL, w, wid - 1) : 0;
    *total = __shfl_sync(FULL, w, nw - 1);
    __syncthreads();
    return before + x - v;
}

// ---------------------------------------------------------------- kernel

// Phase profile (a measurement build only, -DSCAN_PROFILE): rank 0's
// thread 0 adds the SM clock cycles of each phase of every step (the PROF
// marks below; slot 0 the staging) and serial_scan_read_profile copies
// them out; the scan computes the same.
#define PROF_PHASES 16
#ifdef SCAN_PROFILE
__device__ unsigned long long scan_prof[PROF_PHASES];
#define PROF(k)                                                  \
    if (prof_on) {                                               \
        unsigned long long t_ = clock64();                       \
        prof[k] += t_ - prof_t;                                  \
        prof_t = t_;                                             \
    }
#else
#define PROF(k)
#endif

// SM: every array but `live` in shared memory (above); K9: the launch
// carries a learned scorer (the launches without one run an instantiation
// with no K9 code at all), and then each step also sums its learned
// magnitude; EXP: the feature or the alternative export is on (the
// instantiations without it keep no export code and no export bytes);
// NW: the narrow instantiation of a launch of the reference's sizes
// (NARROW_*), without K9 or the exports
template <bool SM, bool K9, bool EXP, bool NW = false>
__global__ void __launch_bounds__(MAX_THREADS, 1)
serial_scan_kernel(ScanArgs S) {
    cg::cluster_group cl = cg::this_cluster();
    const int tid = threadIdx.x, T = blockDim.x;
    const int lane = tid & 31, wid = tid >> 5;
    Blk X;
    X.sm = smem_raw;
    X.rank = (int)cl.block_rank();
    X.per = S.per;
    X.lo = X.rank * S.per;
    X.cnt = max(0, min(S.N - X.lo, S.per));
    const int CB = (int)cl.num_blocks();
#ifdef SCAN_PROFILE
    const bool prof_on = tid == 0 && X.rank == 0;
    unsigned long long prof[PROF_PHASES] = {0}, prof_t = clock64();
#endif
    // a compile-time 0 without K9: the fixed front's offsets fold
    const int lf =
        K9 ? learned_smem_floats(S.learned, MAX_THREADS / 32) : 0;
    const Fixed F = fixed_layout(lf, S.G, S.A, S.C, S.TK, S.R, EXP ? 1 : 0);
    const int SC = NW ? NARROW_C : slot_c(S.C);
    // a best slot: its head, the sender's top ALT_K (EXP), then its rows
    const int BH = BEST_HEAD + (EXP ? 2 * ALT_K : 0);
    const int PW = NW ? pod_words(NARROW_R) : pod_words(S.R);
    float* s_learned = reinterpret_cast<float*>(smem_raw);
    int* in1 = reinterpret_cast<int*>(smem_raw + F.in1);
    int* in2 = reinterpret_cast<int*>(smem_raw + F.in2);
    int* in3 = reinterpret_cast<int*>(smem_raw + F.in3);
    int* s_wslot = reinterpret_cast<int*>(smem_raw + F.wslot);
    float* s_wmin = reinterpret_cast<float*>(smem_raw + F.wmin);
    int* s_misc = reinterpret_cast<int*>(smem_raw + F.misc);
    int* s_scan = s_misc;                // [MAX_WARPS] scan scratch
    int* s_dom = s_misc + MISC_DOM;      // [TK] the commit's domain row
    uint8_t* s_el = smem_raw + F.el;     // [G, C] the commit's spread hits
    uint8_t* s_tsc = smem_raw + F.tsc;   // [G, C] m_tsc[., ., g] this step
    uint8_t* s_mt = smem_raw + F.mt;     // [G, A] the step's term masks
    uint8_t* any3 = smem_raw + F.any3;   // [G]
    int* s_pod = reinterpret_cast<int*>(smem_raw + F.pod);  // [2][pod_words]
    int* s_pod1 = s_pod + PW;                // the odd steps' row
    float* s_mins = reinterpret_cast<float*>(smem_raw + F.mins);  // [G, C]
    int* s_tl = reinterpret_cast<int*>(smem_raw + F.tl);  // the term list
    int* s_hl = reinterpret_cast<int*>(smem_raw + F.hl);  // the hit list
    int* s_cnt = s_misc + MAX_WARPS;     // [0] term, [1] hit list length
    int4* s_sg = reinterpret_cast<int4*>(smem_raw + F.sg);  // [G] StepG

    // ------------------------------------------------ phase 0: staging
    if constexpr (K9)
        learned_stage(S.learned, reinterpret_cast<float*>(smem_raw));
    const int G = S.G, A = S.A, C = S.C;
    stage_node(S, X, PA_FREE, S.free, 1, S.R, 4, false);
    stage_node(S, X, PA_NZR, S.nzr, 1, 2, 4, false);
    stage_node(S, X, PA_STATIC_OK, S.static_ok, S.G1, 1, 1, false);
    stage_node(S, X, PA_TAINT_RAW, S.taint_raw, S.G1, 1, 4, false);
    stage_node(S, X, PA_AFF_RAW, S.aff_raw, S.G1, 1, 4, false);
    stage_node(S, X, PA_IMG, S.img, S.G1, 1, 4, false);
    stage_node(S, X, PA_NOM, S.nom, 1, S.R, 4, false);
    stage_node(S, X, PA_ALLOC2, S.alloc2, 1, 2, 4, false);
    if (S.topo) {
        zero_node(S, X, PA_FORBID1, G, 1);
        zero_node(S, X, PA_MAP2, G, 1);
        zero_node(S, X, PA_PRES, G * A, 1);
        zero_node(S, X, PA_WSCORE, G, 4);
        zero_node(S, X, PA_CNT_MATCH, G * C, 4);
        stage_node(S, X, PA_TOPO_DOM, S.topo_dom, 1, S.TK, 4, false);
        stage_node(S, X, PA_IGN, S.ign, G, 1, 1, false);
        stage_node(S, X, PA_EL_NODE, S.el_node, G, C, 1, false);
        stage_node(S, X, PA_MATCH_STATIC, S.match_static, G, C, 4, false);
        stage_node(S, X, PA_DOM_OK, S.dom_ok, G, C, 1, false);
        stage_node(S, X, PA_ANTI_OK, S.anti_ok, G, 1, 1, false);
        stage_node(S, X, PA_IPA_RAW, S.ipa_raw, G, 1, 4, false);
        stage_node(S, X, PA_TERM_STATIC, S.term_static, G, A, 1, false);
        stage_node(S, X, PA_HAS_LBL, S.has_lbl, G, A, 1, false);
        const size_t ga = (size_t)G * A, gc = (size_t)G * C;
        stage_table(S, X, PA_M_TERMS, S.m_terms, 4 * ga * G);
        stage_table(S, X, PA_M_TSC, S.m_tsc, gc * G);
        stage_table(S, X, PA_ANTI_TK, S.anti_tk, ga * 4);
        stage_table(S, X, PA_AFF_TK, S.aff_tk, ga * 4);
        stage_table(S, X, PA_PAFF_TK, S.paff_tk, ga * 4);
        stage_table(S, X, PA_PANTI_TK, S.panti_tk, ga * 4);
        stage_table(S, X, PA_PAFF_W, S.paff_w, ga * 4);
        stage_table(S, X, PA_PANTI_W, S.panti_w, ga * 4);
        stage_table(S, X, PA_TSC_TK, S.tsc_tk, gc * 4);
        stage_table(S, X, PA_TSC_HARD, S.tsc_hard, gc);
        stage_table(S, X, PA_TSC_SKEW, S.tsc_skew, gc * 4);
        stage_table(S, X, PA_TSC_MIND, S.tsc_mind, gc * 4);
        stage_table(S, X, PA_TPW, S.tpw, gc * 4);
        stage_table(S, X, PA_SELF_MATCH, S.self_match, gc * 4);
        stage_table(S, X, PA_NUM_DOMAINS, S.num_domains, gc * 4);
        stage_table(S, X, PA_HAS_SOFT, S.has_soft, G);
        stage_table(S, X, PA_AFF_SELF, S.aff_self, G);
        stage_table(S, X, PA_T_ANY_MATCH, S.t_any_match, G);
        for (int i = tid; i < G; i += T) any3[i] = 0;
        float* live = live_view(S, X);
        const size_t gcd = gc * S.D;
        for (size_t i = tid; i < gcd; i += T)
            live[i] = S.exists_hard[i] ? S.t_cnt[i] : INFINITY;
    }
    // port-clash stamps: node l holds an earlier commit clashing with pod
    // b when v_forb[l] == b
    auto v_forb = nview<SM>(S, X, PA_FORB, (const int*)S.forb_g, 1);
    if (S.ports)
        for (int l = tid; l < X.cnt; l += T) v_forb.at(0, l) = -1;
    // the window: valid nodes and the first valid row of each slice, in
    // the odd inbox slot of partials (step 1 writes it after two barriers)
    int k_find = 0, start = 0;
    if (S.pct) {
        int c = 0, fv = NO_NODE;
        for (int l = tid; l < X.cnt; l += T)
            if (S.node_valid[X.lo + l]) {
                c += 1;
                fv = min(fv, X.lo + l);
            }
        c = __reduce_add_sync(FULL, c);
        fv = __reduce_min_sync(FULL, fv);
        if (lane == 0) {
            s_wslot[wid] = c;
            s_wslot[MAX_WARPS + wid] = fv;
        }
        __syncthreads();
        if (wid == 0) {
            int nw = T >> 5;
            int tc = __reduce_add_sync(FULL, lane < nw ? s_wslot[lane] : 0);
            int tf = __reduce_min_sync(
                FULL, lane < nw ? s_wslot[MAX_WARPS + lane] : NO_NODE);
            int* own = in1 + (MAX_CLUSTER + X.rank) * SLOT_WORDS;
            if (lane == 0) {
                own[0] = tc;
                own[1] = tf;
            }
            push_slot(cl, own, SLOT_WORDS, X.rank, CB);
        }
    }
    cl.sync();
    if (S.topo) {
        // each group's step descriptor (its any_match is the live part)
        const Tabs TB = tabs_of<SM>(S, X);
        for (int i = tid; i < G; i += T) {
            StepG q = step_of(S, TB, any3, i);
            s_sg[i] = make_int4((int)q.aff_used, (int)q.hard, (int)q.soft_c,
                                q.aff_self ? 1 : 0);
        }
    }
    if (S.topo && S.D <= SMALL_D) {
        // the spread minima of every hard constraint row, kept up to date
        // at each commit from here on
        const Tabs TB = tabs_of<SM>(S, X);
        const float* live = live_view(S, X);
        for (int i = tid; i < G * C; i += T)
            if (TB.tsc_tk[i] != NONE && TB.tsc_hard[i])
                s_mins[i] = row_min(S, TB, live, i);
    }
    if (S.pct) {
        const int* box = in1 + MAX_CLUSTER * SLOT_WORDS;
        int tc = lane < CB ? box[lane * SLOT_WORDS] : 0;
        int tf = lane < CB ? box[lane * SLOT_WORDS + 1] : NO_NODE;
        int tot = __reduce_add_sync(FULL, tc);
        // first valid rows after this slice, and up to and including it
        int after = __reduce_min_sync(FULL, lane > X.rank ? tf : NO_NODE);
        int upto = __reduce_min_sync(FULL, lane <= X.rank ? tf : NO_NODE);
        int eff = S.pct == ADAPTIVE_PCT ? max(5, 50 - tot / 125) : S.pct;
        k_find = max(MIN_FEASIBLE_NODES_TO_FIND, (tot * eff) / 100);
        // snap[n]: the first valid row in rotated order from n (n itself
        // when no row is valid)
        for (int l = tid; l < X.cnt; l += T) {
            int m = NO_NODE;
            for (int q = l; q < X.cnt; ++q)
                if (S.node_valid[X.lo + q]) {
                    m = X.lo + q;
                    break;
                }
            if (m == NO_NODE) m = after;
            if (m == NO_NODE) m = upto;
            if (m == NO_NODE) m = X.lo + l;
            S.snap[X.lo + l] = m;
        }
        __threadfence();
        start = ((*S.pct_start % S.N) + S.N) % S.N;
    }
    // the slice's commits (ports only): plog[rank][i] = (pod, local node)
    int n_log = 0;
    int* plog = S.plog + (size_t)X.rank * S.B * 2;

    auto v_ok = nview<SM>(S, X, PA_STATIC_OK, S.static_ok, 1);
    auto v_taint = nview<SM>(S, X, PA_TAINT_RAW, S.taint_raw, 1);
    auto v_aff = nview<SM>(S, X, PA_AFF_RAW, S.aff_raw, 1);
    auto v_img = nview<SM>(S, X, PA_IMG, S.img, 1);
    auto v_free = nview<SM>(S, X, PA_FREE, (const float*)S.free, S.R);
    auto v_nzr = nview<SM>(S, X, PA_NZR, (const float*)S.nzr, 2);
    auto v_nom = nview<SM>(S, X, PA_NOM, S.nom, S.R);
    auto v_alloc = nview<SM>(S, X, PA_ALLOC2, S.alloc2, 2);
    auto v_feas = nview<SM>(S, X, PA_FEAS, (const uint8_t*)S.feas_g, 1);
    auto v_ipa = nview<SM>(S, X, PA_IPA, (const float*)S.ipa_g, 1);
    auto v_sp = nview<SM>(S, X, PA_SP, (const float*)S.sp_g, 1);
    const int s3 = F.s3;
    // pod 0's row; pod b + 1's is copied (cp.async) during step b
    for (int i = tid; i < 8 + S.R; i += T) {
        const int* src = pod_word(S, 0, i);
        if (src) s_pod[i] = *src;
    }
    cl.sync();  // the snap table and every block's staging are complete
    PROF(0);
    float lsum = 0.0f;  // rank 0, thread 0: the steps' learned magnitudes

    for (int b = 0; b < S.B; ++b) {
        const int par = b & 1;
        int* box1 = in1 + par * MAX_CLUSTER * SLOT_WORDS;
        int* box2 = in2 + par * MAX_CLUSTER * SLOT_WORDS;
        int* box3 = in3 + par * MAX_CLUSTER * s3;
        int* own3 = box3 + X.rank * s3;
        const int* pod = par ? s_pod1 : s_pod;
        const int g1 = pod[0];
        const int g = S.topo ? pod[1] : 0;
        const int own_row = pod[2];
        const unsigned int u = (unsigned int)pod[3];
        const float nzq0 = __int_as_float(pod[4]);
        const float nzq1 = __int_as_float(pod[5]);
        const float* rq = reinterpret_cast<const float*>(pod + 8);
        // ---------------------------------------------------- phase A
        const float* my_min = s_wmin + wid * SC;
        StepG Q;
        Q.aff_used = Q.hard = Q.soft_c = 0;
        Q.any_match = Q.aff_self = false;
        if (S.topo) {
            const Tabs TB = tabs_of<SM>(S, X);
            const int4 q4 = s_sg[g];
            Q.aff_used = (unsigned)q4.x;
            Q.hard = (unsigned)q4.y;
            Q.soft_c = (unsigned)q4.z;
            Q.aff_self = q4.w != 0;
            Q.any_match = TB.t_any_match[g] || any3[g];
            if (wid == 0) {
                // this step's term masks, the term list of the (gp, a)
                // with any, and m_tsc[., ., g], for phase C
                int base = 0;
                for (int i0 = 0; i0 < G * A; i0 += 32) {
                    const int i = i0 + lane;
                    int m = 0;
                    if (i < G * A) {
                        const int gp = i / A, a = i - gp * A;
                        m = (m_term(S, TB, 0, g, a, gp) ? 1 : 0)
                            | (m_term(S, TB, 1, g, a, gp) ? 2 : 0)
                            | (m_term(S, TB, 2, g, a, gp) ? 4 : 0)
                            | (m_term(S, TB, 3, g, a, gp) ? 8 : 0)
                            | (m_term(S, TB, 0, gp, a, g) ? 16 : 0)
                            | (m_term(S, TB, 1, gp, a, g) ? 32 : 0)
                            | (m_term(S, TB, 2, gp, a, g) ? 64 : 0)
                            | (m_term(S, TB, 3, gp, a, g) ? 128 : 0);
                        s_mt[i] = m;
                    }
                    const unsigned bal = __ballot_sync(FULL, m != 0);
                    if (m) s_tl[base + __popc(bal & ((1u << lane) - 1u))] = i;
                    base += __popc(bal);
                }
                if (lane == 0) s_cnt[0] = base;
                for (int i = lane; i < G * C; i += 32)
                    s_tsc[i] = TB.m_tsc[(size_t)i * G + g];
            }
            if (Q.hard && S.D <= SMALL_D) {
                my_min = s_mins + g * C;
            } else if (Q.hard) {
                // the spread minimum per hard constraint over the domains
                // of this block's copy of the live counts, block-wide
                const float* live = live_view(S, X);
                float* wmin = s_wmin + wid * SC;
                int* wm = s_wslot + (RF + RI + 4) * MAX_WARPS;
                for (int c = 0; c < C; ++c) {
                    int gc = g * C + c;
                    if (!hard_of<NW>(TB, Q, gc, c)) continue;
                    unsigned m = KEY_POS_INF;
                    for (int d = tid; d < S.D; d += T)
                        m = min(m, fkey(live[(size_t)gc * S.D + d]));
                    m = __reduce_min_sync(FULL, m);
                    if (lane == 0) wm[c * MAX_WARPS + wid] = (int)m;
                }
                __syncthreads();
                for (int c = 0; c < C; ++c) {
                    int gc = g * C + c;
                    if (!hard_of<NW>(TB, Q, gc, c)) continue;
                    unsigned m = lane < (T >> 5)
                        ? (unsigned)wm[c * MAX_WARPS + lane] : KEY_POS_INF;
                    float mn = kfloat(__reduce_min_sync(FULL, m));
                    float mc = isfinite(mn) ? mn : 0.0f;
                    if (TB.tsc_mind[gc] > 0
                            && TB.num_domains[gc] < TB.tsc_mind[gc])
                        mc = 0.0f;
                    if (lane == 0) wmin[c] = mc;
                }
                __syncwarp();
            }
        }
        PROF(1);
        // the slice's nodes holding an earlier clashing commit
        if (S.ports) {
            __syncthreads();  // the owner thread's log entry of step b - 1
            for (int i = tid; i < n_log; i += T) {
                int j = plog[2 * i], l = plog[2 * i + 1];
                if (S.port_conf[(size_t)b * S.B + j]) v_forb.at(0, l) = b;
            }
            __syncthreads();
        }
        if (tid == 0) own3[5] = -1;  // the window's next start, if found here
        float mt = -INFINITY, ma = -INFINITY, imn = INFINITY,
              imx = -INFINITY, smn = INFINITY, smx = -INFINITY;
        int c_feas = 0, c_port = 0, c_fit = 0, c_sp = 0, c_ipa = 0;
        int c_hi = 0, c_lo = 0;
        {
            const Tabs TB = S.topo ? tabs_of<SM>(S, X) : Tabs();
            const TopoV<SM> TV = S.topo ? topo_views<SM>(S, X)
                                        : TopoV<SM>();
            for (int l = tid; l < X.cnt; l += T) {
                const int n = X.lo + l;
                bool ok_s = v_ok.at(g1, l) != 0;
                bool fit_ok = true;
                if (S.fit_on) {
                    bool own = own_row == n;
                    for (int r = 0; r < S.R; ++r) {
                        float eff = (v_free.at(0, l, S.R, r)
                                     - v_nom.at(0, l, S.R, r))
                                    + (own ? rq[r] : 0.0f);
                        if (!(rq[r] <= eff)) fit_ok = false;
                    }
                }
                bool ports_ok = !(S.ports && v_forb.at(0, l) == b);
                bool ipa_ok = true, sp_ok = true, ign = false;
                float sp_r = 0.0f, ipa_live = 0.0f;
                if (S.topo) {
                    queries<SM, NW>(S, TB, TV, Q, g, l, my_min, &ipa_ok,
                                    &sp_ok, &sp_r, &ipa_live);
                    if (!S.spread_on) sp_ok = true;
                    if (!S.ipa_on) ipa_ok = true;
                    ign = TV.ign.at(g, l) != 0;
                }
                bool f = ok_s && ports_ok && fit_ok && sp_ok && ipa_ok;
                v_feas.at(0, l) = f;
                v_ipa.at(0, l) = ipa_live;
                v_sp.at(0, l) = sp_r;
                if (f && S.pct) {
                    // the window's statistics wait for the truncation
                    if (n >= start) c_hi += 1;
                    else c_lo += 1;
                } else if (f) {
                    mt = fmaxf(mt, v_taint.at(g1, l));
                    ma = fmaxf(ma, v_aff.at(g1, l));
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
                if (ok_s && ports_ok && fit_ok && sp_ok && !ipa_ok)
                    c_ipa += 1;
            }
        }
        PROF(2);
        {
            float vf[RF] = {mt, ma, imn, imx, smn, smx};
            int vi[RI] = {c_feas, c_port, c_fit, c_sp, c_ipa, c_hi, c_lo};
            int* own1 = box1 + X.rank * SLOT_WORDS;
            block_partials<RI>(vf, vi, s_wslot, own1);
            if (wid == 0) push_slot(cl, own1, SLOT_WORDS, X.rank, CB);
        }
        PROF(3);
        cluster_arrive();  // -------------------------------- barrier 1
        // meanwhile: what each total needs that no normalizer changes
        Pre pre[NPT_REG] = {};
#pragma unroll
        for (int k = 0; k < NPT_REG; ++k) {
            const int l = tid + k * T;
            if (l < X.cnt && (v_feas.at(0, l) || X.lo + l == 0)) {
                pre[k] = pre_of(S, v_alloc.at(0, l, 2, 0),
                                v_alloc.at(0, l, 2, 1), v_nzr.at(0, l, 2, 0),
                                v_nzr.at(0, l, 2, 1), nzq0, nzq1);
                pre[k].p = tie_perturb(u, X.lo + l, S.seed);
            }
        }
        cluster_wait();
        PROF(4);
        // pod b + 1's row, copied while this step runs; complete before
        // the step's last barrier
        if (wid == 1 && b + 1 < S.B)
            for (int i = lane; i < 8 + S.R; i += 32) {
                const int* src = pod_word(S, b + 1, i);
                if (src) cp_async4((par ? s_pod : s_pod1) + i, src);
            }
        float nv[RF];
        int sums[RI];
        int pre_hi = 0, pre_lo = 0;
        fold_partials<RI>(box1, CB, X.rank, nv, sums, &pre_hi, &pre_lo,
                          S.pct != 0);
        PROF(5);
        int n_feas = sums[0];
        if (S.pct) {
            // -------------------------------- the window (pct_nodes)
            // rotated order from `start`: rows >= start ascending, then
            // rows < start ascending
            const int tot_hi = sums[5], tot_lo = sums[6];
            int run_hi = pre_hi, run_lo = tot_hi + pre_lo;
            const bool reach = tot_hi + tot_lo >= k_find;
            const int rounds = (X.cnt + T - 1) / T;
            mt = -INFINITY; ma = -INFINITY; imn = INFINITY;
            imx = -INFINITY; smn = INFINITY; smx = -INFINITY;
            int kept = 0;
            const NV<uint8_t, SM> v_ign =
                S.topo ? nview<SM>(S, X, PA_IGN, S.ign, 1) : NV<uint8_t, SM>();
            for (int k = 0; k < rounds; ++k) {
                int l = tid + k * T;
                bool f = l < X.cnt && v_feas.at(0, l);
                int n = X.lo + l;
                bool up = n >= start;
                int v = f ? (up ? 1 : 1 << 16) : 0;
                int tot;
                int ex = block_excl_scan(v, s_scan, &tot);
                if (f) {
                    int rank = up ? run_hi + (ex & 0xffff)
                                  : run_lo + (ex >> 16);
                    bool keep = rank < k_find;
                    if (!keep) v_feas.at(0, l) = 0;
                    if (rank == k_find - 1)
                        own3[5] = __ldcg(S.snap + (n + 1) % S.N);
                    if (keep) {
                        mt = fmaxf(mt, v_taint.at(g1, l));
                        ma = fmaxf(ma, v_aff.at(g1, l));
                        float il = v_ipa.at(0, l), sr = v_sp.at(0, l);
                        imn = fminf(imn, il);
                        imx = fmaxf(imx, il);
                        if (!(S.topo && v_ign.at(g, l))) {
                            smn = fminf(smn, sr);
                            smx = fmaxf(smx, sr);
                        }
                        kept += 1;
                    }
                }
                run_hi += tot & 0xffff;
                run_lo += tot >> 16;
            }
            if (!reach && X.rank == 0 && tid == 0)
                own3[5] = __ldcg(S.snap + start);
            {
                float vf[RF] = {mt, ma, imn, imx, smn, smx};
                int vi[1] = {kept};
                int* own2 = box2 + X.rank * SLOT_WORDS;
                block_partials<1>(vf, vi, s_wslot, own2);
                if (wid == 0) push_slot(cl, own2, SLOT_WORDS, X.rank, CB);
            }
            PROF(6);
            cl.sync();  // ------------------------- barrier 2 (window)
            PROF(4);
            int ks[1];
            fold_partials<1>(box2, CB, X.rank, nv, ks, nullptr, nullptr,
                             false);
            n_feas = ks[0];
            PROF(5);
        }
        // ---------------------------------------------------- phase B
        const Norms M = norms_of(
            nv, S.topo && tview<SM>(S, X, PA_HAS_SOFT, S.has_soft)[g]);
        unsigned btk = 0u, bpk = 0u;
        float t0 = 0.0f;
        int bi = NO_NODE, nan = 0;
        // the step's learned magnitude: a thread's sum of |w x term| over
        // its feasible nodes, in node order; its top ALT_K feasible totals
        float lacc = 0.0f;
        Top4 top;
        if constexpr (EXP) top4_init(top);
        {
            const NV<uint8_t, SM> v_ign =
                S.topo ? nview<SM>(S, X, PA_IGN, S.ign, 1) : NV<uint8_t, SM>();
            float bs = -INFINITY, bp = -1.0f;
            // every lane of a warp calls it together where K9 runs; `in`
            // false past the slice
            auto score = [&](int l, const Pre& q, bool in) {
                const int n = X.lo + l;
                const bool f = in && v_feas.at(0, l) != 0;
                const bool live = f || (in && n == 0);
                if (!live && !K9) return;
                const bool ign = live && S.topo && v_ign.at(g, l);
                float lt = 0.0f;
                float t = total_from<K9>(
                    S, M, q, live ? v_taint.at(g1, l) : 0.0f,
                    live ? v_aff.at(g1, l) : 0.0f,
                    live ? v_img.at(g1, l) : 0.0f,
                    live ? v_ipa.at(0, l) : 0.0f,
                    live ? v_sp.at(0, l) : 0.0f, ign, s_learned, live, &lt);
                if (!live) return;
                if (n == 0) {
                    t0 = t;
                    if (!f) return;
                }
                if constexpr (K9) lacc = lacc + fabsf(lt);
                if constexpr (EXP)
                    if (S.exp_alts) top4_push(top, fkey(t), n);
                if (isnan(t)) {
                    nan = 1;
                    return;
                }
                if (better(t, q.p, n, bs, bp, bi)) {
                    bs = t;
                    bp = q.p;
                    bi = n;
                }
            };
#pragma unroll
            for (int k = 0; k < NPT_REG; ++k)
                score(tid + k * T, pre[k], tid + k * T < X.cnt);
            for (int l0 = tid - lane + NPT_REG * T; l0 < X.cnt; l0 += T) {
                const int l = l0 + lane;
                const bool in = l < X.cnt;
                Pre q = {};
                if (in) {
                    q = pre_of(S, v_alloc.at(0, l, 2, 0),
                               v_alloc.at(0, l, 2, 1), v_nzr.at(0, l, 2, 0),
                               v_nzr.at(0, l, 2, 1), nzq0, nzq1);
                    q.p = tie_perturb(u, X.lo + l, S.seed);
                }
                score(l, q, in);
            }
            if (bi != NO_NODE) {
                btk = fkey(bs);
                bpk = __float_as_uint(bp);
            }
        }
        PROF(7);
        warp_best(&btk, &bpk, &bi, &nan);
        {
            int* ws = s_wslot + (RF + RI) * MAX_WARPS;
            if (lane == 0) {
                ws[wid] = (int)btk;
                ws[MAX_WARPS + wid] = (int)bpk;
                ws[2 * MAX_WARPS + wid] = bi;
                ws[3 * MAX_WARPS + wid] = nan;
            }
            // the warps' magnitude sums and top ALT_K lists (the partials'
            // rows, free since the step's folds)
            if constexpr (K9) {
                const float v = warp_fsum(lacc);
                if (lane == 0) s_wslot[wid] = __float_as_int(v);
            }
            unsigned* s_alt = reinterpret_cast<unsigned*>(smem_raw + F.alts);
            if constexpr (EXP) {
                if (S.exp_alts) {
                    unsigned ak[ALT_K];
                    int ai[ALT_K];
                    top4_warp(top, 32, ak, ai);
                    if (lane == 0)
                        for (int q = 0; q < ALT_K; ++q) {
                            s_alt[wid * 2 * ALT_K + q] = ak[q];
                            s_alt[wid * 2 * ALT_K + ALT_K + q] =
                                (unsigned)ai[q];
                        }
                }
            }
            if (X.rank == 0 && X.cnt > 0 && tid == 0)
                own3[4] = __float_as_int(t0);
            __syncthreads();
            if (wid == 0) {
                const int nw = T >> 5;
                unsigned tk = 0u, pk = 0u;
                int i = NO_NODE, nn = 0;
                if (lane < nw) {
                    tk = (unsigned)ws[lane];
                    pk = (unsigned)ws[MAX_WARPS + lane];
                    i = ws[2 * MAX_WARPS + lane];
                    nn = ws[3 * MAX_WARPS + lane];
                }
                warp_best(&tk, &pk, &i, &nn);
                if (lane == 0) {
                    own3[0] = (int)tk;
                    own3[1] = (int)pk;
                    own3[2] = i;
                    own3[3] = nn;
                }
                if constexpr (K9) {
                    const float v = warp_fsum(
                        lane < nw ? __int_as_float(s_wslot[lane]) : 0.0f);
                    if (lane == 0) own3[6] = __float_as_int(v);
                }
                if constexpr (EXP) {
                    if (S.exp_alts) {
                        Top4 wt;
                        top4_init(wt);
                        if (lane < nw)
                            for (int q = 0; q < ALT_K; ++q) {
                                wt.k[q] = s_alt[lane * 2 * ALT_K + q];
                                wt.i[q] =
                                    (int)s_alt[lane * 2 * ALT_K + ALT_K + q];
                            }
                        unsigned ak[ALT_K];
                        int ai[ALT_K];
                        top4_warp(wt, nw, ak, ai);
                        if (lane == 0)
                            for (int q = 0; q < ALT_K; ++q) {
                                own3[BEST_HEAD + q] = (int)ak[q];
                                own3[BEST_HEAD + ALT_K + q] = ai[q];
                            }
                    }
                }
                // the best node's topo_dom and el_node rows ride along
                if (S.topo && i != NO_NODE) {
                    const int l = i - X.lo;
                    const auto td = nview<SM>(S, X, PA_TOPO_DOM, S.topo_dom,
                                             S.TK);
                    const auto el = nview<SM>(S, X, PA_EL_NODE, S.el_node,
                                                 S.C);
                    for (int t = lane; t < S.TK; t += 32)
                        own3[BH + t] = td.at(0, l, S.TK, t);
                    uint8_t* eb = reinterpret_cast<uint8_t*>(
                        own3 + BH + S.TK);
                    for (int q = lane; q < G * C; q += 32) {
                        int gp = q / C;
                        eb[q] = el.at(gp, l, C, q - gp * C);
                    }
                }
                push_slot(cl, own3, s3, X.rank, CB);
            }
            if (wid == 1) asm volatile("cp.async.wait_all;\n" ::: "memory");
        }
        PROF(8);
        cl.sync();  // -------------------------- last barrier of the step
        PROF(4);
        // ---------------------------------------------------- phase C
        unsigned wtk = 0u, wpk = 0u;
        int wi = NO_NODE, wnan = 0, nxt = -1;
        if (lane < CB) {
            const int* w = box3 + lane * s3;
            wtk = (unsigned)w[0];
            wpk = (unsigned)w[1];
            wi = w[2];
            wnan = w[3];
            nxt = w[5];
        }
        const float total0 = __int_as_float(box3[4]);
        nxt = __reduce_max_sync(FULL, nxt);
        const int my_i = wi;
        warp_best(&wtk, &wpk, &wi, &wnan);
        const int wrank =
            __ffs(__ballot_sync(FULL, wi != NO_NODE && my_i == wi)) - 1;
        PROF(9);
        int row;
        float win;
        if (wnan) {
            // a NaN total makes the reference's top NaN: no node ties it
            // and its argmax falls to node 0
            row = 0;
            win = total0;
        } else if (wi == NO_NODE) {
            row = -1;
            win = 0.0f;
        } else {
            row = wi;
            win = kfloat(wtk);
        }
        if (X.rank == 0 && tid == 0) {
            S.rows[b] = row;
            S.win[b] = win;
            S.feas[b] = n_feas;
            for (int q = 0; q < 4; ++q) S.rejects[b * 4 + q] = sums[q + 1];
        }
        if (X.rank == 0 && wid == 0) {
            // the step's learned magnitude: the ranks' sums over its
            // feasible count, folded over the valid pods in batch order
            if constexpr (K9) {
                const float v = warp_fsum(
                    lane < CB ? __int_as_float(box3[lane * s3 + 6]) : 0.0f);
                if (lane == 0) {
                    const float st = v / (float)(n_feas > 1 ? n_feas : 1);
                    S.lmag_step[b] = st;
                    if (S.pod_valid[b]) lsum = lsum + st;
                }
            }
            // the top ALT_K over the ranks' lists
            if constexpr (EXP) {
                if (S.exp_alts) {
                    Top4 wt;
                    top4_init(wt);
                    if (lane < CB)
                        for (int q = 0; q < ALT_K; ++q) {
                            wt.k[q] = (unsigned)box3[lane * s3 + BEST_HEAD
                                                     + q];
                            wt.i[q] = box3[lane * s3 + BEST_HEAD + ALT_K + q];
                        }
                    unsigned ak[ALT_K];
                    int ai[ALT_K];
                    top4_warp(wt, CB, ak, ai);
                    if (lane == 0)
                        for (int q = 0; q < ALT_K; ++q) {
                            const bool has = ai[q] != NO_NODE;
                            const float sc = has ? kfloat(ak[q]) : ALT_NONE;
                            S.alt_score[(size_t)b * ALT_K + q] = sc;
                            S.alt_row[(size_t)b * ALT_K + q] =
                                (has && sc > ALT_NONE * 0.5f) ? ai[q] : -1;
                        }
                }
            }
        }
        if constexpr (EXP) {
            // the chosen row's (an unplaced pod: node 0's) features, by
            // the thread that owns it, before its commit moves nzr
            const int r = row < 0 ? 0 : row;
            if (S.exp_feats && r >= X.lo && r < X.lo + X.cnt
                    && tid == (r - X.lo) % T) {
                const int l = r - X.lo;
                const Pre q = pre_of(S, v_alloc.at(0, l, 2, 0),
                                     v_alloc.at(0, l, 2, 1),
                                     v_nzr.at(0, l, 2, 0),
                                     v_nzr.at(0, l, 2, 1), nzq0, nzq1);
                const bool ign = S.topo
                                 && nview<SM>(S, X, PA_IGN, S.ign, 1)
                                        .at(g, l);
                const Terms tr = terms_from(M, v_taint.at(g1, l),
                                            v_aff.at(g1, l), v_ipa.at(0, l),
                                            v_sp.at(0, l), ign);
                float* fo = S.chosen_feat + (size_t)b * NF;
                fo[0] = q.f0;
                fo[1] = q.f1;
                fo[2] = q.fit / 100.0f;
                fo[3] = q.bal / 100.0f;
                fo[4] = tr.taint / 100.0f;
                fo[5] = tr.aff / 100.0f;
                fo[6] = v_img.at(g1, l) / 100.0f;
                fo[7] = tr.spread / 100.0f;
                fo[8] = tr.ipa / 100.0f;
            }
        }
        if (S.pct) start = nxt;
        if (row >= X.lo && row < X.lo + X.cnt) {
            const int l = row - X.lo;
            if (tid == l % T) {
                for (int r = 0; r < S.R; ++r)
                    v_free.at(0, l, S.R, r) =
                        v_free.at(0, l, S.R, r) + (-rq[r]);
                v_nzr.at(0, l, 2, 0) = v_nzr.at(0, l, 2, 0) + nzq0;
                v_nzr.at(0, l, 2, 1) = v_nzr.at(0, l, 2, 1) + nzq1;
                if (S.ports) {
                    plog[2 * n_log] = b;
                    plog[2 * n_log + 1] = l;
                }
            }
            n_log += 1;
        }
        PROF(10);
        if (S.topo && row >= 0) {
            // the commit's domain row and spread hits (and their list):
            // from the winner's best slot, or (a NaN pick of node 0) global
            // memory
            if (wid == 0) {
                const int* wrow = box3 + (wrank < 0 ? 0 : wrank) * s3;
                const uint8_t* web = reinterpret_cast<const uint8_t*>(
                    wrow + BH + S.TK);
                for (int t = lane; t < S.TK; t += 32)
                    s_dom[t] = wnan ? S.topo_dom[(size_t)row * S.TK + t]
                                    : wrow[BH + t];
                int base = 0;
                for (int i0 = 0; i0 < G * C; i0 += 32) {
                    const int i = i0 + lane;
                    bool h = false;
                    if (i < G * C) {
                        const int gp = i / C;
                        const uint8_t el = wnan
                            ? S.el_node[((size_t)gp * S.N + row) * C
                                        + (i - gp * C)]
                            : web[i];
                        h = el && s_tsc[i];
                    }
                    const unsigned bal = __ballot_sync(FULL, h);
                    if (h) s_hl[base + __popc(bal & ((1u << lane) - 1u))] = i;
                    base += __popc(bal);
                }
                if (lane == 0) s_cnt[1] = base;
            }
            __syncthreads();
            PROF(12);
            const int tln = s_cnt[0], hln = s_cnt[1];
            const Tabs TB = tabs_of<SM>(S, X);
            if (tln + hln > 0) {
                const TopoV<SM> TV = topo_views<SM>(S, X);
                for (int l = tid; l < X.cnt; l += T)
                    map_updates_node(S, TB, TV, g, l, s_dom, s_tl, tln,
                                     s_hl, hln, s_mt);
            }
            // the domain-space part, on this block's copy (and the minima
            // of the rows it changed)
            float* live = live_view(S, X);
            for (int h = tid; h < hln; h += T) {
                const int i = s_hl[h];
                const int tk = TB.tsc_tk[i];
                if (tk == NONE) continue;
                const int d = s_dom[tk];
                if (d != NONE && d < S.D) {
                    live[(size_t)i * S.D + d] += 1.0f;
                    if (S.D <= SMALL_D && TB.tsc_hard[i])
                        s_mins[i] = row_min(S, TB, live, i);
                }
            }
            for (int e = tid; e < tln; e += T) {
                const int i = s_tl[e];
                const int tk = TB.aff_tk[i];
                if ((s_mt[i] & 32) && tk != NONE && s_dom[tk] != NONE)
                    any3[i / A] = 1;
            }
            __syncthreads();
            PROF(13);
        }
    }
    // ------------------------------------------------ write back
    __syncthreads();
    stage_node(S, X, PA_FREE, S.free, 1, S.R, 4, true);
    stage_node(S, X, PA_NZR, S.nzr, 1, 2, 4, true);
    if (S.topo) {
        stage_node(S, X, PA_FORBID1, S.forbid1, G, 1, 1, true);
        stage_node(S, X, PA_MAP2, S.map2, G, 1, 1, true);
        stage_node(S, X, PA_PRES, S.pres, G * A, 1, 1, true);
        stage_node(S, X, PA_WSCORE, S.wscore, G, 1, 4, true);
        stage_node(S, X, PA_CNT_MATCH, S.cnt_match, G * C, 1, 4, true);
        if (X.rank == 0)
            for (int i = tid; i < G; i += T) S.any3[i] = any3[i];
    }
    if (S.pct && X.rank == 0 && tid == 0) *S.pct_start = start;
    if (K9 && X.rank == 0 && tid == 0) *S.lmag_sum = lsum;
    cl.sync();  // no block leaves while another may write its inboxes
    PROF(14);
#ifdef SCAN_PROFILE
    if (prof_on)
        for (int k = 0; k < PROF_PHASES; ++k) scan_prof[k] = prof[k];
#endif
}

// ---------------------------------------------------------------- host

template <bool SM, bool K9, bool EXP, bool NW = false>
static cudaError_t scan_attributes(int smem) {
    cudaError_t e = cudaFuncSetAttribute(
        serial_scan_kernel<SM, K9, EXP, NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            serial_scan_kernel<SM, K9, EXP, NW>,
            cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
}

static cudaError_t all_scan_attributes(int smem) {
    cudaError_t e = scan_attributes<false, false, false>(smem);
    if (e == cudaSuccess) e = scan_attributes<true, false, false>(smem);
    if (e == cudaSuccess) e = scan_attributes<false, true, false>(smem);
    if (e == cudaSuccess) e = scan_attributes<true, true, false>(smem);
    if (e == cudaSuccess) e = scan_attributes<false, false, true>(smem);
    if (e == cudaSuccess) e = scan_attributes<true, false, true>(smem);
    if (e == cudaSuccess) e = scan_attributes<false, true, true>(smem);
    if (e == cudaSuccess) e = scan_attributes<true, true, true>(smem);
    if (e == cudaSuccess)
        e = scan_attributes<false, false, false, true>(smem);
    if (e == cudaSuccess) e = scan_attributes<true, false, false, true>(smem);
    return e;
}

static cudaLaunchConfig_t scan_config(int cluster, int threads, int smem,
                                      cudaStream_t stream,
                                      cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// how many clusters of `cluster` blocks of `threads` threads with `smem`
// bytes of dynamic shared memory the card can hold at once (0: none; a
// negated CUDA error code when the card refuses the query)
extern "C" int serial_scan_max_clusters(int cluster, int threads, int smem) {
    cudaError_t e = all_scan_attributes(smem);
    if (e != cudaSuccess) return -(int)e;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = scan_config(cluster, threads, smem, 0, attr);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(
        &n, serial_scan_kernel<false, false, false>, &cfg);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return e == cudaErrorInvalidClusterSize ? 0 : -(int)e;
    }
    return n;
}

extern "C" int serial_scan_port_conf_launch(const ScanArgs* args,
                                            void* port_conf, void* stream) {
    ScanArgs S = *args;
    long total = (long)S.B * S.B;
    int blocks = (int)min((total + 255) / 256, 132L * 8);
    if (blocks < 1) return 0;
    port_conf_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        S, (uint8_t*)port_conf);
    return (int)cudaGetLastError();
}

// does a launch take the narrow instantiation? (kernels/scan.py
// narrow_launch mirrors it)
static bool scan_narrow(const ScanArgs& S) {
    return S.learned.n_layers == 0 && !S.exp_feats && !S.exp_alts
           && S.A <= NARROW_A && S.C <= NARROW_C && S.TK <= NARROW_TK
           && S.R <= NARROW_R;
}

extern "C" int serial_scan_launch(const ScanArgs* args, void* stream) {
    ScanArgs S = *args;
    const bool k9 = S.learned.n_layers > 0;
    const bool ex = S.exp_feats || S.exp_alts;
    if (S.cluster < 1 || S.threads < 32
            || S.threads > MAX_THREADS || S.threads % 32 != 0
            || (long)S.per * S.cluster < S.N
            || !learned_net_ok(S.learned, LEARNED_NARROW_MAX)
            || (k9 && (!S.lmag_step || !S.lmag_sum || !S.pod_valid))
            || (S.exp_feats && !S.chosen_feat)
            || (S.exp_alts && (!S.alt_row || !S.alt_score)))
        return (int)cudaErrorInvalidValue;
    Fixed F = fixed_layout(learned_smem_floats(S.learned, MAX_THREADS / 32),
                           S.G, S.A, S.C, S.TK, S.R, ex ? 1 : 0);
    if (F.end != S.fixed_bytes || S.smem_bytes < F.end)
        return (int)cudaErrorInvalidValue;
    void (*kernel)(ScanArgs);
    if (scan_narrow(S))
        kernel = S.all_shared ? serial_scan_kernel<true, false, false, true>
                              : serial_scan_kernel<false, false, false, true>;
    else if (ex)
        kernel = S.all_shared ? (k9 ? serial_scan_kernel<true, true, true>
                                    : serial_scan_kernel<true, false, true>)
                              : (k9 ? serial_scan_kernel<false, true, true>
                                    : serial_scan_kernel<false, false, true>);
    else
        kernel = S.all_shared
                     ? (k9 ? serial_scan_kernel<true, true, false>
                           : serial_scan_kernel<true, false, false>)
                     : (k9 ? serial_scan_kernel<false, true, false>
                           : serial_scan_kernel<false, false, false>);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S.smem_bytes);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = scan_config(S.cluster, S.threads, S.smem_bytes,
                                         (cudaStream_t)stream, attr);
    e = cudaLaunchKernelEx(&cfg, kernel, S);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- probes

// Measurement probes, not on the scheduling path.
//
// cluster_sync_probe: `steps` rounds of `per_step` cluster barriers and
// nothing else, on the cluster shape and with the shared memory a scan
// uses. A timed launch with steps = B gives the barrier floor of a B-step
// scan of this design on this card.
__global__ void __launch_bounds__(MAX_THREADS, 1)
cluster_sync_probe(int steps, int per_step) {
    cg::cluster_group cl = cg::this_cluster();
    for (int b = 0; b < steps; ++b)
        for (int k = 0; k < per_step; ++k) cl.sync();
}

extern "C" int serial_scan_cluster_probe(int cluster, int threads, int smem,
                                         int steps, int per_step,
                                         void* stream) {
    cudaError_t e = cudaFuncSetAttribute(
        cluster_sync_probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            cluster_sync_probe,
            cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = scan_config(cluster, threads, smem,
                                         (cudaStream_t)stream, attr);
    e = cudaLaunchKernelEx(&cfg, cluster_sync_probe, steps, per_step);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// grid_sync_probe: the previous design's barrier, kept for comparison:
// `steps` rounds of three grid-wide barriers of one cooperative launch of
// ceil(n / 256) blocks of 256 threads (at most what the card holds at
// once), the grid that design ran a scan over n nodes on.
__global__ void grid_sync_probe(int steps) {
    cg::grid_group grid = cg::this_grid();
    for (int b = 0; b < steps; ++b) {
        grid.sync();
        grid.sync();
        grid.sync();
    }
}

extern "C" int serial_scan_sync_probe(int n, int steps, void* stream) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, grid_sync_probe, 256, 0);
    if (e != cudaSuccess) return (int)e;
    int blocks = min((n + 255) / 256, sms * per_sm);
    if (blocks < 1) blocks = 1;
    void* params[] = {&steps};
    e = cudaLaunchCooperativeKernel(grid_sync_probe, dim3(blocks), dim3(256),
                                    params, 0, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

#ifdef SCAN_PROFILE
extern "C" int serial_scan_read_profile(unsigned long long* out) {
    return (int)cudaMemcpyFromSymbol(out, scan_prof, sizeof(scan_prof));
}
#endif

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
