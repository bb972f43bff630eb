// The export tails' warp-level pieces, shared by K2a's export pass
// (auction_score_argmax.cu) and K3's export outputs (serial_scan.cu): a
// running top K (ALT_K) of (total key, node) pairs and its warp merge, in
// jax.lax.top_k's order, and the warp sum whose order the twins repeat
// (kernels/auction.py halving_tree, lane_sum). The including file defines
// FULL, NO_NODE and ALT_K, and fkey (the order-preserving key of a float).

#pragma once

// a running top K of (key, node), best first: higher key, then the lower
// node (jax.lax.top_k's order); node NO_NODE is an empty slot. K3 and the
// export pass keep ALT_K; the export's CTA-wide list one more (Top4 is
// TopK<ALT_K>; the functions below take any K)
template <int K>
struct TopK {
    unsigned k[K];
    int i[K];
};
using Top4 = TopK<ALT_K>;

template <int K>
__device__ __forceinline__ void top4_init(TopK<K>& t) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
        t.k[q] = 0u;
        t.i[q] = NO_NODE;
    }
}

// does (ka, ia) rank before (kb, ib)?
__device__ __forceinline__ bool ranks_before(unsigned ka, int ia,
                                             unsigned kb, int ib) {
    if (ia == NO_NODE) return false;
    if (ib == NO_NODE) return true;
    if (ka != kb) return ka > kb;
    return ia < ib;
}

template <int K>
__device__ __forceinline__ void top4_push(TopK<K>& t, unsigned k, int i) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
        if (ranks_before(k, i, t.k[q], t.i[q])) {
            const unsigned tk = t.k[q];
            const int ti = t.i[q];
            t.k[q] = k;
            t.i[q] = i;
            k = tk;
            i = ti;
        }
    }
}

// the warp's merged top K of every lane's list (lanes past `lanes` carry
// none), in every lane: K rounds of the warp's best head, whose lane pops
// it
template <int K>
__device__ __forceinline__ void top4_warp(TopK<K>& t, int lanes,
                                          unsigned* ok, int* oi) {
    const int lane = threadIdx.x & 31;
    if (lane >= lanes) top4_init(t);
#pragma unroll
    for (int q = 0; q < K; ++q) {
        const bool has = t.i[0] != NO_NODE;
        const unsigned m = __reduce_max_sync(FULL, has ? t.k[0] : 0u);
        const int w = __reduce_min_sync(
            FULL, (has && t.k[0] == m) ? t.i[0] : NO_NODE);
        ok[q] = m;
        oi[q] = w;
        if (has && t.i[0] == w) {
#pragma unroll
            for (int r = 0; r < K - 1; ++r) {
                t.k[r] = t.k[r + 1];
                t.i[r] = t.i[r + 1];
            }
            t.k[K - 1] = 0u;
            t.i[K - 1] = NO_NODE;
        }
    }
}

__device__ __forceinline__ float warp_fsum(float v) {
    // the xor tree: lane 0 ends with ((v0 + v16) + (v8 + v24)) + ...,
    // the twin's halving tree (kernels/auction.py lane_sum)
    for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(FULL, v, o);
    return v;
}

