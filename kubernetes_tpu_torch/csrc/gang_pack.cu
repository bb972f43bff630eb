// K7a gang_pack: the fused gang packer — for G gangs in order, member
// capacity per node, the all-or-nothing verdict, the domain-major greedy
// fill, and the commit into the carried usage.
//
// Replaces: kubernetes_tpu/ops/gang.py `pack_gangs` (:77, jitted at
// :189-191), the `lax.scan` body at :133-178. The twin is
// kubernetes_tpu_torch/ops/gang.py:pack_core (through
// kernels/gang.py:pack_core_ref); the static filter mask it reads comes
// from K1 (phase1_static.cu) on the gangs' representative rows.
//
// Design: ONE thread-block cluster of `cluster` blocks (16, a
// non-portable size that needs sm_90a, else 8) carries the whole launch
// and walks the gangs in order, so gang g+1 reads g's commit. Block k owns
// nodes [k * per, (k + 1) * per); that slice's free, nominated and nzr
// rows (stored [R, per]: a warp's neighbouring nodes in neighbouring
// banks), its member capacities and its domains stay in the block's
// shared memory for the whole launch, and free/nzr are written back once
// at its end (kernels/gang.py plan_pack places them from a byte count;
// what does not fit is read and written in global memory, counted under
// LAUNCHES["gang_pack_global"]). Each block also holds a domain table
// (partial sums, the sorted domains, ranks, the used flags of two gangs)
// and 4,096 / cluster bins of the threshold histogram. Per gang, four
// cluster barriers:
//
//   1. cap[n] = static_ok ? clip(min over active columns r of
//      floor(max((free - nom) + onom * req, 0) / req), 0, 2^20) : 0 (2^20
//      for every column when NodeResourcesFit is off), the twin's f32
//      operations in its order (-fmad=false), true division; each warp
//      adds its nodes' capacities into the block's per-domain partials
//      (lanes of one domain summed first, __match_any_sync), int64.
//      -- barrier A --
//   2. every block folds the cluster's partials (DSMEM reads) into the
//      domain sums, sorts the domains in shared memory (bitonic: capacity
//      descending, then id) and walks them in rank order (warp 0, a
//      shuffle scan 32 ranks at a time): the exact total, the verdict
//      (cap = min(f32(total), 2^30), ok = cap >= m and m > 0), the domain
//      d* where the fill reaches m and what is left to place there. The
//      nodes of d* add their capacity into the threshold histogram bin
//      min(cap, 4095), which lives in the shared memory of the block that
//      owns that bin (DSMEM atomics). -- barrier B --
//   3. each block sums its bins and stores the total into every block's
//      inbox. -- barrier C --
//   4. from the totals, in bin order from 4095 down (a cluster scan),
//      every block finds the block whose bins hold the crossing and scans
//      that block's bins (DSMEM reads) for the threshold density cc*;
//      each block sums the capacity of its own threshold nodes (d*,
//      min(cap, 4095) = cc*) and stores it into every inbox. -- barrier
//      E --
//   5. each block's threshold prefix is the totals of the lower ranks
//      plus a block scan in index order; every node before the threshold
//      takes its whole capacity, every node after it nothing, a threshold
//      node clip(m - prefix, 0, cap): the twin's stable double argsort and
//      cumulative take, node for node. alloc, and the commit into the
//      block's rows (free -= take * req, nzr += take * nzreq, the twin's
//      product then difference); the used flags of this gang's domains.
//      spans (the domains where some node took members) is counted by
//      rank 0 after the next barrier A from every block's flags.
//
// The guard (bit 1: a NaN in the post-batch free) is OR-ed into a zeroed
// word by the blocks that see one. Sums are int64, so they are exact in
// any order; the outputs are integers, bools and the twin's f32
// operations: card and twin agree exactly. (The reference's int32 prefix
// wraps past 2^31 member slots; see ops/gang.py.)
//
// Measurement build: -DPACK_PROFILE adds the SM clock cycles of each
// step of a gang, summed over the launch, on rank 0's thread 0
// (kernels/gang.py pack_profile).
//
// What bounds it on an H100: latency, not bytes. A launch of G = 16 gangs
// over N = 8,192 nodes of R = 8 columns reads each gang's static mask
// (8 KB) and writes its alloc row (32 KB); the carried rows cross the
// memory bus twice a launch. The gangs are serial, each four cluster
// barriers and a chain of dependent block-wide steps.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define MAX_THREADS 512
#define MAX_CLUSTER 16
#define MIN_CLUSTER 8
#define KEY_STRIDE 4096
#define UNBOUNDED 1048576.0f
#define CAP_LIMIT 1073741824.0f
#define SMEM_MAX 232448
#define FULL 0xffffffffu
// the fixed front of a block's shared memory: the histogram bins (at most
// KEY_STRIDE / MIN_CLUSTER), the two inboxes, the block-scan slots, the
// gang's scalars
#define FIXED_BYTES ((KEY_STRIDE / MIN_CLUSTER) * 8 + 2 * MAX_CLUSTER * 8 + 32 * 8 + 64)

// the arrays kernels/gang.py plan_pack places, in its order
enum { PO_DOMAIN, PO_CAPN, PO_DOM, PO_FREE, PO_NZR, PO_NOM, PO_COUNT };

// Mirrored by kernels/gang.py:_PackArgs (same members, same order).
struct PackArgs {
    int G, N, R, d_cap, tk, fit_on, dom_stride;
    int cluster, threads, per, smem_bytes, fixed_bytes;
    int off[PO_COUNT];          // byte offset in shared memory, -1: global
    float* free;                // [N, R] in/out: the carried free
    float* nzr;                 // [N, 2] in/out: the carried nzr
    const float* nom;           // [N, R] nominated reservations
    const uint8_t* static_ok;   // [G, N] K1's mask
    const int* topo;            // topo_dom[:, max(tk, 0)], row stride dom_stride
    const float* req;           // [G, R]
    const float* nzreq;         // [G, 2]
    const int* need;            // [G]
    const int* own_nom;         // [G, N] or null (all zero)
    uint8_t* ok;                // [G]
    int* alloc;                 // [G, N]
    int* cap;                   // [G]
    int* spans;                 // [G]
    int* guard;                 // [] zeroed by the caller
    int* capn;                  // [N] scratch where capn is global
    int* dom;                   // [N] scratch where dom is global
    unsigned char* dscratch;    // [cluster, domain bytes] where the domain
                                // tables are global
};

__host__ __device__ inline int a16(int x) { return (x + 15) & ~15; }

// a block's domain tables (byte offsets from their base); mirrored by
// kernels/gang.py:domain_bytes
struct DomLayout {
    int part, key, id, rank, used, bytes, p2;
};

__host__ __device__ inline DomLayout dom_layout(int D) {
    DomLayout L;
    int p2 = 1;
    while (p2 < D) p2 <<= 1;
    int o = 0;
    L.part = o; o += a16(D * 8);      // this block's partial domain sums
    L.key = o; o += a16(p2 * 8);      // domain sums, sorted
    L.id = o; o += a16(p2 * 4);       // their ids
    L.rank = o; o += a16(D * 4);      // rank of each domain
    L.used = o; o += a16(2 * D * 4);  // took members: two gangs' flags
    L.bytes = o;
    L.p2 = p2;
    return L;
}

// the gang's scalars, at the end of the fixed front
struct Misc {
    long long need_in, above;
    int feas, rstar, dstar, ccstar, split;
};

// jnp.maximum(x, 0) / torch.maximum: a NaN propagates
__device__ __forceinline__ float max0_nan(float x) {
    return (x != x) ? x : (x > 0.0f ? x : 0.0f);
}

// jnp.min / torch.amin over a row: a NaN wins
__device__ __forceinline__ float min_nan(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return b < a ? b : a;
}

// jnp.clip / torch.clamp: a NaN propagates
__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
    if (x != x) return x;
    return x < lo ? lo : (x > hi ? hi : x);
}

// XLA's f32 -> i32: NaN -> 0, saturating (ops/gang.py:f32_to_i32)
__device__ __forceinline__ int f2i(float x) {
    if (x != x) return 0;
    if (x >= 2147483648.0f) return 2147483647;
    if (x <= -2147483648.0f) return (int)0x80000000;
    return (int)x;
}

// Block-wide exclusive scan of one int64 a thread; the block total in
// *total when given. Every thread must call it.
__device__ long long block_excl_scan(long long v, long long* s_warp,
                                     long long* total) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    long long x = v;
    for (int o = 1; o < 32; o <<= 1) {
        long long y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[wid] = x;
    __syncthreads();
    if (wid == 0) {
        long long w = lane < nw ? s_warp[lane] : 0;
        for (int o = 1; o < 32; o <<= 1) {
            long long y = __shfl_up_sync(FULL, w, o);
            if (lane >= o) w += y;
        }
        s_warp[lane] = w;
    }
    __syncthreads();
    long long excl = (wid > 0 ? s_warp[wid - 1] : 0) + x - v;
    if (total) *total = s_warp[nw - 1];
    __syncthreads();
    return excl;
}

// a block's view of a node-slice array [per, J]: element (l, j) at
// p[l * ls + j * lj]; in shared memory stored [J, per] (ls 1, lj per), in
// global memory the caller's [N, J] rows (ls J, lj 1)
template <typename T>
struct NV {
    T* p;
    int ls, lj;
    __device__ __forceinline__ T& at(int l, int j = 0) const {
        return p[(long)l * ls + (long)j * lj];
    }
};

template <typename T>
__device__ __forceinline__ NV<T> node_view(unsigned char* sm, int off,
                                           T* global, int lo, int J,
                                           int per) {
    NV<T> v;
    if (off >= 0) {
        v.p = reinterpret_cast<T*>(sm + off);
        v.ls = 1;
        v.lj = per;
    } else {
        v.p = global + (long)lo * J;
        v.ls = J;
        v.lj = 1;
    }
    return v;
}

// Step profile (a measurement build only, -DPACK_PROFILE): rank 0's
// thread 0 adds the SM clock cycles from the previous mark to slot k, and
// gang_read_profile copies the sums out. Slots: 0 staging, 1 capacity
// and domain partials, 2 barrier A, 3 spans, 4 domain fold, 5 sort, 6
// walk, 7 histogram adds, 8 barrier B, 9 bin totals, 10 barrier C, 11
// crossing, 12 threshold totals, 13 barrier E, 14 take and commit, 15
// write-back and guard.
#define PACK_STEPS 16
#ifdef PACK_PROFILE
__device__ unsigned long long pack_prof[PACK_STEPS];
#define PPROF(k)                                                   \
    if (prof_on) {                                                 \
        unsigned long long t_ = clock64();                         \
        prof[k] += t_ - prof_t;                                    \
        prof_t = t_;                                               \
    }
#else
#define PPROF(k)
#endif

__global__ void __launch_bounds__(MAX_THREADS, 1) gang_pack(PackArgs A) {
    extern __shared__ __align__(16) unsigned char sm[];
    cg::cluster_group cl = cg::this_cluster();
    const int tid = threadIdx.x, T = blockDim.x;
    const int lane = tid & 31, wid = tid >> 5;
    const int CB = A.cluster, rank = (int)cl.block_rank();
    const int per = A.per, lo = rank * per;
    const int cnt = max(0, min(A.N - lo, per));
    const int N = A.N, R = A.R, D = A.d_cap;
    const int HB = KEY_STRIDE / CB;
#ifdef PACK_PROFILE
    const bool prof_on = rank == 0 && tid == 0;
    unsigned long long prof[PACK_STEPS] = {0}, prof_t = clock64();
#endif
    // the fixed front
    long long* s_bins = reinterpret_cast<long long*>(sm);
    long long* s_binbox = s_bins + KEY_STRIDE / MIN_CLUSTER;
    long long* s_tiebox = s_binbox + MAX_CLUSTER;
    long long* s_warp = s_tiebox + MAX_CLUSTER;
    Misc* s_m = reinterpret_cast<Misc*>(s_warp + 32);
    // the node slice
    const NV<float> v_free = node_view(sm, A.off[PO_FREE], A.free, lo, R,
                                       per);
    const NV<float> v_nzr = node_view(sm, A.off[PO_NZR], A.nzr, lo, 2, per);
    const NV<const float> v_nom =
        node_view(sm, A.off[PO_NOM], A.nom, lo, R, per);
    const NV<int> v_capn = node_view(sm, A.off[PO_CAPN], A.capn, lo, 1, per);
    const NV<int> v_dom = node_view(sm, A.off[PO_DOM], A.dom, lo, 1, per);
    // the domain tables: this block's, and block r's (DSMEM, or its slice
    // of the global scratch)
    const DomLayout DL = dom_layout(D);
    auto dom_base = [&](int r) -> unsigned char* {
        if (A.off[PO_DOMAIN] >= 0)
            return cl.map_shared_rank(sm + A.off[PO_DOMAIN], r);
        return A.dscratch + (size_t)r * DL.bytes;
    };
    unsigned char* db = A.off[PO_DOMAIN] >= 0 ? sm + A.off[PO_DOMAIN]
                                              : A.dscratch
                                                    + (size_t)rank * DL.bytes;
    long long* d_part = reinterpret_cast<long long*>(db + DL.part);
    long long* d_key = reinterpret_cast<long long*>(db + DL.key);
    int* d_id = reinterpret_cast<int*>(db + DL.id);
    int* d_rank = reinterpret_cast<int*>(db + DL.rank);
    int* d_used = reinterpret_cast<int*>(db + DL.used);
    // rank 0: spans of gang h, the domains where any block's nodes took
    // members (every block's flags of gang h, after a barrier)
    auto count_spans = [&](int h) {
        int cnt_used = 0;
        for (int d = tid; d < D; d += T) {
            int any = 0;   // every block's flag in flight at once
#pragma unroll
            for (int r = 0; r < MAX_CLUSTER; ++r)
                if (r < CB)
                    any |= reinterpret_cast<const int*>(dom_base(r)
                                                        + DL.used)
                               [(h & 1) * D + d];
            cnt_used += any != 0;
        }
        long long n_used;
        block_excl_scan(cnt_used, s_warp, &n_used);
        if (tid == 0) A.spans[h] = (int)n_used;
    };

    // ------------------------------------------------------- staging
    if (A.off[PO_FREE] >= 0)
        for (int i = tid; i < cnt * R; i += T)
            v_free.p[(i % R) * per + i / R] = A.free[(long)lo * R + i];
    if (A.off[PO_NOM] >= 0) {
        float* s = reinterpret_cast<float*>(sm + A.off[PO_NOM]);
        for (int i = tid; i < cnt * R; i += T)
            s[(i % R) * per + i / R] = A.nom[(long)lo * R + i];
    }
    if (A.off[PO_NZR] >= 0)
        for (int i = tid; i < cnt * 2; i += T)
            v_nzr.p[(i & 1) * per + (i >> 1)] = A.nzr[(long)lo * 2 + i];
    // node -> packing domain: the tk column, NONE labels, tk = -1 and ids
    // past the bucket in the last slot
    for (int l = tid; l < cnt; l += T) {
        int d = D - 1;
        if (A.tk >= 0) {
            int raw = A.topo[(long)(lo + l) * A.dom_stride];
            if (raw >= 0 && raw < D - 1) d = raw;
        }
        v_dom.at(l) = d;
    }
    for (int d = tid; d < D; d += T) {
        d_part[d] = 0;
        d_used[d] = 0;
        d_used[D + d] = 0;
    }
    for (int b = tid; b < HB; b += T) s_bins[b] = 0;
    cl.sync();  // every block runs before the first DSMEM access
    PPROF(0);

    for (int g = 0; g < A.G; ++g) {
        const float* rq = A.req + (long)g * R;
        const float* nzq = A.nzreq + (long)g * 2;
        const int m = A.need[g];
        // 1. capacity of each node of the slice, domain partials
        for (int l0 = 0; l0 < cnt; l0 += T) {
            const int l = l0 + tid;
            int c = 0, d = -1;
            if (l < cnt) {
                const int n = lo + l;
                if (A.static_ok[(long)g * N + n]) {
                    float cf = UNBOUNDED;
                    if (A.fit_on) {
                        float onom = A.own_nom
                            ? (float)A.own_nom[(long)g * N + n] : 0.0f;
                        for (int r = 0; r < R; ++r) {
                            float q = rq[r];
                            float pc = UNBOUNDED;
                            if (q > 0.0f) {
                                float e = v_free.at(l, r) - v_nom.at(l, r);
                                float prod = onom * q;
                                e = e + prod;
                                pc = floorf(max0_nan(e) / q);
                            }
                            cf = (r == 0) ? pc : min_nan(cf, pc);
                        }
                    }
                    c = f2i(clip_nan(cf, 0.0f, UNBOUNDED));
                }
                v_capn.at(l) = c;
                if (c > 0) d = v_dom.at(l);
            }
            // the lanes of one domain summed first, one atomic a domain
            const unsigned peers = __match_any_sync(FULL, d);
            const unsigned sum = __reduce_add_sync(peers, (unsigned)c);
            if (d >= 0 && lane == __ffs(peers) - 1)
                atomicAdd((unsigned long long*)&d_part[d],
                          (unsigned long long)sum);
        }
        PPROF(1);
        cl.sync();  // ------------------------------------- barrier A
        PPROF(2);
        // spans of the previous gang: the domains any block marked
        if (g > 0 && rank == 0) count_spans(g - 1);
        PPROF(3);
        // 2. the cluster's domain sums, sorted (capacity descending, then
        // id; the padding after every domain)
        for (int d = tid; d < DL.p2; d += T) {
            long long v = -1;
            if (d < D) {
                long long p[MAX_CLUSTER];   // every block's partial in
#pragma unroll                              // flight at once
                for (int r = 0; r < MAX_CLUSTER; ++r)
                    p[r] = r < CB ? reinterpret_cast<const long long*>(
                                        dom_base(r) + DL.part)[d]
                                  : 0;
                v = 0;
#pragma unroll
                for (int r = 0; r < MAX_CLUSTER; ++r) v += p[r];
            }
            d_key[d] = v;
            d_id[d] = d;
        }
        __syncthreads();
        PPROF(4);
        for (int k = 2; k <= DL.p2; k <<= 1) {
            for (int j = k >> 1; j > 0; j >>= 1) {
                for (int i = tid; i < DL.p2; i += T) {
                    const int x = i ^ j;
                    if (x <= i) continue;
                    const long long vi = d_key[i], vx = d_key[x];
                    const int ii = d_id[i], ix = d_id[x];
                    // does element x belong before element i?
                    const bool x_first = vx > vi || (vx == vi && ix < ii);
                    if (((i & k) == 0) == x_first) {
                        d_key[i] = vx;
                        d_key[x] = vi;
                        d_id[i] = ix;
                        d_id[x] = ii;
                    }
                }
                __syncthreads();
            }
        }
        for (int r = tid; r < D; r += T) d_rank[d_id[r]] = r;
        PPROF(5);
        // the walk in rank order: the exact total, the verdict and the
        // domain where the fill reaches m
        if (wid == 0) {
            long long acc = 0, before = 0;
            int rs = D;
            for (int base = 0; base < D; base += 32) {
                const long long v =
                    base + lane < D ? max(d_key[base + lane], 0LL) : 0LL;
                long long x = v;
                for (int o = 1; o < 32; o <<= 1) {
                    long long y = __shfl_up_sync(FULL, x, o);
                    if (lane >= o) x += y;
                }
                const unsigned hit =
                    __ballot_sync(FULL, v > 0 && acc + x >= (long long)m);
                if (rs == D && hit) {
                    const int h = __ffs(hit) - 1;
                    rs = base + h;
                    before = acc + __shfl_sync(FULL, x - v, h);
                }
                acc += __shfl_sync(FULL, x, 31);
            }
            if (lane == 0) {
                const float tf = (float)acc;
                const float tot = tf < CAP_LIMIT ? tf : CAP_LIMIT;
                const int cap_total = f2i(tot);
                const int feas = (cap_total >= m) && (m > 0);
                if (rank == 0) {
                    A.cap[g] = cap_total;
                    A.ok[g] = (uint8_t)feas;
                }
                s_m->feas = feas;
                s_m->rstar = feas && rs < D ? rs : D;
                s_m->dstar = feas && rs < D ? d_id[rs] : -1;
                s_m->split = feas && rs < D;
                s_m->need_in = (long long)m - before;
            }
        }
        __syncthreads();
        PPROF(6);
        const bool split = s_m->split != 0;
        const int feas = s_m->feas, rstar = s_m->rstar, dstar = s_m->dstar;
        // the nodes of d* into the threshold histogram, each bin in its
        // owner's shared memory
        if (split) {
            for (int l0 = 0; l0 < cnt; l0 += T) {
                const int l = l0 + tid;
                int b = -1, c = 0;
                if (l < cnt) {
                    c = v_capn.at(l);
                    if (c > 0 && v_dom.at(l) == dstar)
                        b = min(c, KEY_STRIDE - 1);
                }
                const unsigned peers = __match_any_sync(FULL, b);
                const unsigned sum = __reduce_add_sync(peers, (unsigned)c);
                if (b >= 0 && lane == __ffs(peers) - 1)
                    atomicAdd((unsigned long long*)cl.map_shared_rank(
                                  s_bins + b % HB, b / HB),
                              (unsigned long long)sum);
            }
        }
        PPROF(7);
        cl.sync();  // ------------------------------------- barrier B
        PPROF(8);
        // partials and the flags of gang g - 1 are read: clear them for
        // gang g + 1
        for (int d = tid; d < D; d += T) {
            d_part[d] = 0;
            d_used[((g + 1) & 1) * D + d] = 0;
        }
        // 3. this block's bin total, into every block's inbox
        if (split) {
            long long loc = 0;
            for (int b = tid; b < HB; b += T) loc += s_bins[b];
            long long tot;
            block_excl_scan(loc, s_warp, &tot);
            if (tid < CB) cl.map_shared_rank(s_binbox, tid)[rank] = tot;
        }
        PPROF(9);
        cl.sync();  // ------------------------------------- barrier C
        PPROF(10);
        // 4. the crossing: the owner block (bins from 4095 down), then the
        // density inside its bins
        if (split) {
            if (tid == 0) {
                long long acc = 0;
                int owner = 0;
                for (int r = CB - 1; r >= 0; --r) {
                    if (acc + s_binbox[r] >= s_m->need_in) {
                        owner = r;
                        break;
                    }
                    acc += s_binbox[r];
                }
                s_m->ccstar = owner;   // the owner, until the scan below
                s_m->above = acc;
            }
            __syncthreads();
            const int owner = s_m->ccstar;
            const long long above0 = s_m->above, need_in = s_m->need_in;
            const long long* ob = cl.map_shared_rank(s_bins, owner);
            long long run = above0;
            for (int j0 = 0; j0 < HB; j0 += T) {
                const int j = j0 + tid;
                const int b = HB - 1 - j;     // the owner's bins, descending
                const long long h = j < HB ? ob[b] : 0;
                long long chunk;
                const long long ex = block_excl_scan(h, s_warp, &chunk);
                if (j < HB && run + ex < need_in && run + ex + h >= need_in) {
                    s_m->ccstar = owner * HB + b;
                    s_m->above = run + ex;
                }
                run += chunk;
            }
            __syncthreads();
        }
        PPROF(11);
        const int ccstar = split ? s_m->ccstar : -1;
        const long long rem0 = split ? s_m->need_in - s_m->above : 0;
        // this block's threshold nodes, into every block's inbox
        if (split) {
            long long tl = 0;
            for (int l = tid; l < cnt; l += T) {
                const int c = v_capn.at(l);
                if (c > 0 && v_dom.at(l) == dstar
                        && min(c, KEY_STRIDE - 1) == ccstar)
                    tl += c;
            }
            long long tot;
            block_excl_scan(tl, s_warp, &tot);
            if (tid < CB) cl.map_shared_rank(s_tiebox, tid)[rank] = tot;
        }
        PPROF(12);
        cl.sync();  // ------------------------------------- barrier E
        PPROF(13);
        for (int b = tid; b < HB; b += T) s_bins[b] = 0;
        // 5. take, alloc, commit; the prefix of the threshold nodes in
        // index order: the lower ranks' totals, then a block scan
        long long tie = 0;
        if (split)
            for (int r = 0; r < rank; ++r) tie += s_tiebox[r];
        int* used = d_used + (g & 1) * D;
        for (int l0 = 0; l0 < cnt; l0 += T) {
            const int l = l0 + tid;
            const bool in = l < cnt;
            const int c = in ? v_capn.at(l) : 0;
            const int d = in ? v_dom.at(l) : 0;
            const bool thr = split && c > 0 && d == dstar
                             && min(c, KEY_STRIDE - 1) == ccstar;
            long long chunk = 0, ex = 0;
            if (split) ex = block_excl_scan(thr ? c : 0, s_warp, &chunk);
            if (in) {
                long long take = 0;
                if (feas && c > 0) {
                    const int rk = d_rank[d];
                    if (rk < rstar) {
                        take = c;
                    } else if (rk == rstar) {
                        const int cc = min(c, KEY_STRIDE - 1);
                        if (cc > ccstar) {
                            take = c;
                        } else if (cc == ccstar) {
                            const long long left = rem0 - (tie + ex);
                            take = left <= 0 ? 0 : (left < c ? left : c);
                        }
                    }
                }
                A.alloc[(long)g * N + lo + l] = (int)take;
                const float tf = (float)take;
                for (int r = 0; r < R; ++r) {
                    const float prod = tf * rq[r];
                    v_free.at(l, r) = v_free.at(l, r) - prod;
                }
                for (int k = 0; k < 2; ++k) {
                    const float prod = tf * nzq[k];
                    v_nzr.at(l, k) = v_nzr.at(l, k) + prod;
                }
                if (take > 0) used[d] = 1;
            }
            tie += chunk;
        }
        __syncthreads();
        PPROF(14);
    }
    cl.sync();  // every block's flags of the last gang are set
    if (A.G > 0 && rank == 0) count_spans(A.G - 1);
    // write back the carried rows once; the guard
    int nan_local = 0;
    if (A.off[PO_FREE] >= 0) {
        for (int i = tid; i < cnt * R; i += T) {
            const float v = v_free.p[(i % R) * per + i / R];
            A.free[(long)lo * R + i] = v;
            nan_local |= (v != v);
        }
    } else {
        for (int i = tid; i < cnt * R; i += T) {
            const float v = A.free[(long)lo * R + i];
            nan_local |= (v != v);
        }
    }
    if (A.off[PO_NZR] >= 0)
        for (int i = tid; i < cnt * 2; i += T)
            A.nzr[(long)lo * 2 + i] = v_nzr.p[(i & 1) * per + (i >> 1)];
    if (__syncthreads_or(nan_local) && tid == 0) atomicOr(A.guard, 1 << 1);
    PPROF(15);
#ifdef PACK_PROFILE
    if (prof_on)
        for (int k = 0; k < PACK_STEPS; ++k) pack_prof[k] = prof[k];
#endif
    cl.sync();  // no block leaves while rank 0 reads its flags
}

// ---------------------------------------------------------------- host

static cudaError_t pack_attributes(int smem) {
    cudaError_t e = cudaFuncSetAttribute(
        gang_pack, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            gang_pack, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
}

static cudaLaunchConfig_t pack_config(int cluster, int threads, int smem,
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
// bytes of dynamic shared memory the card holds at once (0: none; a
// negated CUDA error code when the card refuses the query)
extern "C" int gang_pack_max_clusters(int cluster, int threads, int smem) {
    cudaError_t e = pack_attributes(smem);
    if (e != cudaSuccess) return -(int)e;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = pack_config(cluster, threads, smem, 0, attr);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, gang_pack, &cfg);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return e == cudaErrorInvalidClusterSize ? 0 : -(int)e;
    }
    return n;
}

extern "C" int gang_pack_launch(const PackArgs* args, void* stream) {
    PackArgs A = *args;
    if (A.G < 0 || A.N < 1 || A.R < 1 || A.d_cap < 1
            || A.cluster < MIN_CLUSTER || A.cluster > MAX_CLUSTER
            || KEY_STRIDE % A.cluster != 0 || A.threads < 32
            || A.threads > MAX_THREADS || A.threads % 32 != 0
            || (long)A.per * A.cluster < A.N || A.fixed_bytes != FIXED_BYTES
            || A.smem_bytes < A.fixed_bytes || A.smem_bytes > SMEM_MAX
            || (A.off[PO_CAPN] < 0 && !A.capn) || (A.off[PO_DOM] < 0 && !A.dom)
            || (A.off[PO_DOMAIN] < 0 && !A.dscratch))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = pack_attributes(A.smem_bytes);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = pack_config(A.cluster, A.threads, A.smem_bytes,
                                         (cudaStream_t)stream, attr);
    e = cudaLaunchKernelEx(&cfg, gang_pack, A);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

#ifdef PACK_PROFILE
extern "C" int gang_read_profile(unsigned long long* out) {
    return (int)cudaMemcpyFromSymbol(out, pack_prof, sizeof(pack_prof));
}
#endif

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
