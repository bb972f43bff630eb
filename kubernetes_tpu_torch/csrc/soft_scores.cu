// K4 soft_scores: one auction round's live soft topology scores, one
// launch a round.
//
// Replaces: kubernetes_tpu/models/pipeline.py `_soft_scores` (:439-532),
// which every round of the soft-score auction (`_rounds_commit` :535,
// round `body` :649) recomputes from the set of pods placed so far; its
// per-group static halves (`_soft_statics` :360) come from K5
// (topo_statics.cu) through the view in kernels/soft.py. The twin is
// kubernetes_tpu_torch/kernels/soft.py:soft_scores_ref.
//
// The domain maps are the launch's state: `maps` [4, G, A, D] (paff P_b,
// P_j, panti P_b, P_j) and `tmap` [G, C, D] hold the counts of the pods
// recorded in `seen` (the row each pod is counted at, -1 none; both start
// empty with the auction launch, kernels/soft.py soft_out). A round is one
// cooperative launch of three phases:
//
// 1. Delta: every valid pod whose row in `placed` differs from `seen`
//    leaves the maps at its old row and joins them at its new one. One
//    warp takes 32 pods of one group g (g-major order) and walks g's 2A
//    preferred terms and C spread constraints together: a pod y of group
//    gy on node r whose node carries a domain dy < D under the term's key
//    adds 1 into P_b[g, a, dy] when M[g, a, gy] and into P_j[g, a, dy]
//    when gy == g; 1 into tmap[g, c, dy] when M_tsc[g, c, gy] and node r is
//    an eligible commit target (el_node). Lanes naming one cell add
//    together (__match_any_sync), so a hot zone cell takes one atomic a
//    warp. Where the maps fit in shared memory (kernels/soft.py
//    plan_soft: D = 8 on the zone and rack paths), each block adds into a
//    zeroed shared copy and then adds each cell it touched into the
//    global maps once; else (hostname keys, D = 1,024 or 8,192) the warps'
//    adds go to the global maps directly, and the wrapper counts the
//    launch. The counts are integers below 2^24: exact in any order.
// 2. One grid barrier; `seen` takes `placed`.
// 3. Gather: one block a (group g, 256 nodes) item. The block hoists g's
//    node-independent term list of each kind into shared memory once: its
//    own preferred terms (b-side) and the (g2, a) whose terms match g
//    (j-side), each as (key column, map row, weight); and, where they fit
//    (the same plan), stages the maps into shared memory after the
//    barrier. Each node's thread then reads its
//    domain under each listed term's key from topo_dom and gathers,
//    masking a domain outside [0, D) to 0 as the reference does:
//      ipa_live = ipa_raw + (pd(paff) - pd(panti)), where
//      pd = sum_a w[g, a] * P_b[g, a, nd] + sum_{(g2, a) matching g}
//           w[g2, a] * P_j[g2, a, nd(g2, a)]
//    (integer weights times counts: exact in any order), and
//      sp_r = sum over c, left to right, of (match_static + tmap) * tpw
//             + (skew - 1) where the constraint is soft and the node has
//             its key; 0 on an ignored node.
//
// The launch follows the auction's round flag: when *prog_in is 0 the
// round is a no-op (every block returns before the barrier), so the host
// can launch several rounds back to back. No memset: the maps change only
// by the delta.
//
// What bounds it on an H100: latency. A round after the first bulk
// accept moves only the few pods accepted last round; the gather reads
// every node's topology row and the [G, N, C] statics once and writes two
// [G, N] floats (a few hundred KB to a few MB); the launch, the grid
// barrier and the gather's dependent loads are its floor.
//
// Built with -fmad=false: sp_r's multiply and add round separately, as
// in the twin.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define NONE (-1)
#define THREADS 256
#define FULL 0xffffffffu

// Mirrored by kernels/soft.py:_SoftArgs (same members, same order).
struct SoftArgs {
    int B, G, N, TK, A, C, D;
    int maps_shared;             // 1: the maps staged in shared memory
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
    int* seen;                   // [B] the row each pod is counted at
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

// a cell of the maps and tmap taken as one array: [0, 4GAD) the maps,
// then the tmap
__device__ __forceinline__ float* cell_ptr(const SoftArgs& S, float* sm,
                                           long cell) {
    if (sm != nullptr) return sm + cell;
    long m4 = 4L * S.G * S.A * S.D;
    return cell < m4 ? S.maps + cell : S.tmap + (cell - m4);
}

// every lane with `has` adds `sign` at its cell; lanes naming one cell
// add together, one atomic from the lowest of them
__device__ __forceinline__ void add_cells(const SoftArgs& S, float* sm,
                                          bool has, long cell, float sign) {
    unsigned act = __ballot_sync(FULL, has);
    if (!has) return;
    unsigned peers = __match_any_sync(act, (unsigned long long)cell);
    unsigned lane = threadIdx.x & 31;
    if ((peers & ((1u << lane) - 1u)) == 0)
        atomicAdd(cell_ptr(S, sm, cell), sign * (float)__popc(peers));
}

// the cells pod (group gy, on node r) counts in for group g's term t
// (-1 where none): t < 2A a preferred term (P_b and P_j), else a spread
// constraint (tmap, into cb)
__device__ __forceinline__ void term_cells(const SoftArgs& S, int g, int t,
                                           int gy, int r, long& cb,
                                           long& cj) {
    cb = cj = -1;
    if (r < 0) return;
    const long plane = (long)S.G * S.A * S.D;
    if (t < 2 * S.A) {
        int kind = t / S.A, a = t % S.A;
        const int* tk = kind == 0 ? S.paff_tk : S.panti_tk;
        const uint8_t* m = kind == 0 ? S.m_paff : S.m_panti;
        int dy = dom_of(S, r, tk[g * S.A + a]);
        if (dy < 0 || dy >= S.D) return;
        long cell = ((long)g * S.A + a) * S.D + dy;
        if (m[((size_t)g * S.A + a) * S.G + gy]) cb = 2 * kind * plane + cell;
        if (gy == g) cj = (2 * kind + 1) * plane + cell;
    } else {
        int c = t - 2 * S.A;
        int dy = dom_of(S, r, S.tsc_tk[g * S.C + c]);
        if (dy < 0 || dy >= S.D) return;
        if (S.m_tsc[((size_t)g * S.C + c) * S.G + gy]
                && S.el_node[((size_t)g * S.N + r) * S.C + c])
            cb = 4 * plane + ((long)g * S.C + c) * S.D + dy;
    }
}

// node n's weighted same-domain mass over one kind's hoisted term list
__device__ __forceinline__ float pair_delta(const SoftArgs& S, float* sm,
                                            int n, const int* tk,
                                            const int* off, const float* w,
                                            int cnt) {
    float d = 0.0f;
    for (int j = 0; j < cnt; ++j) {
        int nd = dom_of(S, n, tk[j]);
        if (nd >= 0 && nd < S.D) d += *cell_ptr(S, sm, off[j] + nd) * w[j];
    }
    return d;
}

__global__ void __launch_bounds__(THREADS) soft_scores_kernel(SoftArgs S) {
    extern __shared__ float smem[];
    if (*S.prog_in == 0) return;
    cg::grid_group grid = cg::this_grid();
    const int tid = threadIdx.x, lane = tid & 31;
    const long plane = (long)S.G * S.A * S.D;
    const long cells = 4 * plane + (long)S.G * S.C * S.D;
    float* sm = S.maps_shared ? smem : nullptr;
    // group g's preferred terms of each kind, hoisted: its own (b-side)
    // and the (g2, a) whose terms match g (j-side), as (key column, first
    // cell of the term's map row, weight)
    const int cap = S.A + S.G * S.A;
    int* nt = (int*)(smem + (S.maps_shared ? cells : 0));  // [2]
    int* t_tk = nt + 2;                                    // [2, cap]
    int* t_off = t_tk + 2 * cap;                           // [2, cap]
    float* t_w = (float*)(t_off + 2 * cap);                // [2, cap]

    // ---- 1. delta: pods whose row changed leave and join the maps
    if (sm != nullptr)
        for (long i = tid; i < cells; i += THREADS) sm[i] = 0.0f;
    __syncthreads();
    const long pairs = (long)S.G * S.B;
    const int terms = 2 * S.A + S.C;
    // the grid's warps share the pairs
    for (long base = (long)blockIdx.x * THREADS + (tid >> 5) * 32;
         base < pairs; base += (long)gridDim.x * THREADS) {
        long idx = base + lane;
        int g = 0, b = 0, gy = 0, old_r = -1, new_r = -1;
        if (idx < pairs) {
            g = (int)(idx / S.B);
            b = (int)(idx % S.B);
            if (S.valid[b]) {
                int p = S.placed[b], s = S.seen[b];
                if (p != s) {
                    old_r = s;
                    new_r = p;
                    gy = S.gid[b];
                }
            }
        }
        if (__ballot_sync(FULL, old_r >= 0 || new_r >= 0) == 0) continue;
        for (int pass = 0; pass < 2; ++pass) {
            int r = pass == 0 ? old_r : new_r;
            float sign = pass == 0 ? -1.0f : 1.0f;
            for (int t = 0; t < terms; ++t) {
                long cb, cj;
                term_cells(S, g, t, gy, r, cb, cj);
                add_cells(S, sm, cb >= 0, cb, sign);
                add_cells(S, sm, cj >= 0, cj, sign);
            }
        }
    }
    if (sm != nullptr) {
        __syncthreads();
        for (long i = tid; i < cells; i += THREADS) {
            float v = sm[i];
            if (v != 0.0f) atomicAdd(cell_ptr(S, nullptr, i), v);
        }
    }
    // ---- 2. every block's delta is in the maps
    grid.sync();
    for (long b = (long)blockIdx.x * THREADS + tid; b < S.B;
         b += (long)gridDim.x * THREADS)
        S.seen[b] = S.placed[b];
    if (sm != nullptr) {
        for (long i = tid; i < cells; i += THREADS)
            sm[i] = *cell_ptr(S, nullptr, i);
    }

    // ---- 3. gather: one (group, 256 nodes) item at a time
    const int chunks = (S.N + THREADS - 1) / THREADS;
    const long items = (long)S.G * chunks;
    int listed = -1;
    for (long it = blockIdx.x; it < items; it += gridDim.x) {
        const int g = (int)(it / chunks);
        if (g != listed) {
            __syncthreads();
            if (tid < 2) nt[tid] = 0;
            __syncthreads();
            for (int t = tid; t < 2 * cap; t += THREADS) {
                int kind = t / cap, q = t % cap;
                const uint8_t* m = kind == 0 ? S.m_paff : S.m_panti;
                const int* tk = kind == 0 ? S.paff_tk : S.panti_tk;
                const float* w = kind == 0 ? S.paff_w : S.panti_w;
                long off;
                int row;
                if (q < S.A) {               // g's own term a: P_b
                    row = g * S.A + q;
                    off = 2 * kind * plane + (long)row * S.D;
                } else {                     // (g2, a) = q - A: P_j
                    row = q - S.A;
                    if (!m[(size_t)row * S.G + g]) continue;
                    off = (2 * kind + 1) * plane + (long)row * S.D;
                }
                if (tk[row] == NONE) continue;
                int at = kind * cap + atomicAdd(&nt[kind], 1);
                t_tk[at] = tk[row];
                t_off[at] = (int)off;
                t_w[at] = w[row];
            }
            listed = g;
            __syncthreads();
        }
        const int n = (int)(it % chunks) * THREADS + tid;
        if (n >= S.N) continue;
        size_t gn = (size_t)g * S.N + n;
        float paff = pair_delta(S, sm, n, t_tk, t_off, t_w, nt[0]);
        float panti = pair_delta(S, sm, n, t_tk + cap, t_off + cap,
                                 t_w + cap, nt[1]);
        S.ipa_live[gn] = S.ipa_raw[gn] + (paff - panti);
        float acc = 0.0f;
        for (int c = 0; c < S.C; ++c) {
            int gc = g * S.C + c;
            int nd = dom_of(S, n, S.tsc_tk[gc]);
            float gath = (nd >= 0 && nd < S.D)
                             ? *cell_ptr(S, sm, 4 * plane
                                         + (long)gc * S.D + nd)
                             : 0.0f;
            float match = S.match_static[gn * S.C + c] + gath;
            float v = match * S.tpw[gc];
            v = v + (S.skew[gc] - 1.0f);
            if (!(S.used_soft[gc] && S.dom_ok[gn * S.C + c])) v = 0.0f;
            acc = c == 0 ? v : acc + v;
        }
        S.sp_r[gn] = S.ign[gn] ? 0.0f : acc;
    }
}

// the kernel's dynamic shared-memory limit raised to `smem` past the
// default 48 KB; set at every launch, since a launch of a smaller plan
// lowers it for every other
static cudaError_t allow_smem(int smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(soft_scores_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
}

// blocks of THREADS the card holds at once with `smem` bytes each (the
// cooperative launch's largest grid)
extern "C" int soft_scores_grid(int smem, int* blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = allow_smem(smem);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, soft_scores_kernel, THREADS, smem);
    *blocks = sms * per_sm;
    return (int)e;
}

extern "C" int soft_scores_launch(const SoftArgs* args, int blocks, int smem,
                                  void* stream) {
    const SoftArgs& S = *args;
    if (S.C < 1 || S.D < 1 || S.G < 1 || blocks < 1)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_smem(smem);
    if (e != cudaSuccess) return (int)e;
    void* params[] = {(void*)args};
    e = cudaLaunchCooperativeKernel(
        (void*)soft_scores_kernel, dim3(blocks), dim3(THREADS), params,
        (size_t)smem, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
