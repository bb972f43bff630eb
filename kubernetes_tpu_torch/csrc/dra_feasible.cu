// K8 dra_feasible: batched DRA allocation feasibility, fused after phase 1.
//
// Replaces: kubernetes_tpu/ops/dra.py `batch_feasible` (:104, jit :152) as
// the JAX package fuses it into phase 1 (kubernetes_tpu/models/pipeline.py
// :1023-1039): dra_ok = batch_feasible(dra); dra_reject[b] = sum_n
// (static_ok & ~dra_ok); static_ok &= dra_ok; then the host Filter
// verdicts (host_ok) AND in. The twin is
// kubernetes_tpu_torch/ops/dra.py:fuse_phase1.
//
// The function: for each pod b and node n, the pod's requests in order,
// each taking the lowest `count` eligible devices in device order (every
// one in All mode), eligible = valid, not in use, not taken by an earlier
// request of the pod, every required selector bit set; the pod fits when
// each used request found `want` eligible devices (1 in All mode), and n
// passes its allocated-claim pins. Inactive rows verdict True.
//
// What bounds it on an H100: the selector tests. The previous design (a
// thread a (pod, node)) re-read its node's D validity, in-use and
// selector bytes once per pod and compared D x 8 words per request, kept
// the taken devices in a 512-byte local array, and refused D > 4,096,
// B > 65,535 and Q > 64.
//
// This design:
// - A block takes a tile of nt nodes, one after the other, and a chunk of
//   up to `pods` pods (a thread a pod, ppt pods a thread); blocks cover
//   (node tiles x pod chunks) on grid.x, so any B launches.
// - Bitsliced eligibility: the block stages a node's devices a chunk of
//   SW device words (32 devices a word) at a time: the free word
//   (valid & ~in_use) and, for each selector bit any request of the
//   block's pods uses (the block's union of request masks, ranked), the
//   word of devices carrying that bit, built with warp ballots from the
//   selector words read once, coalesced. A request's eligible word is
//   then free & ~taken & AND over its mask bits of the bit's word:
//   popcount(mask) ANDs a word instead of 32 x 8 compares a word.
// - Any D, chunk by chunk: a request's state (devices still wanted;
//   All mode: none found yet) is carried across chunks in shared memory,
//   the taken devices only for the current chunk in registers (SW words),
//   requests inside each chunk in order: the same greedy pick, since a
//   chunk's picks depend only on that chunk and the state entering it.
//   A satisfied count-mode request skips the rest of the node.
// - A pod whose static mask is already false at a node skips the node
//   unless dra_ok is asked for (the card check).
// - The tile's static_ok / host_ok bytes are read, and out_ok / dra_ok
//   written, as the tile's rows through shared memory; each pod's
//   dra_reject is counted over the tile and added with one integer atomic
//   a tile, exact in any order.
// - The only limit left is the block's shared memory: the union's ranked
//   bit words (256 x SW words) and the request state (Q x pods words) at
//   one node and 128 pods a block must fit 232,448 bytes
//   (kernels/dra.py plan_dra states it: Q <= 436 request slots).
//
// Every step is integer: card and twin agree exactly.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define WARPS (THREADS / 32)
#define SW 8                 // device words a staged chunk (256 devices)
#define SELBIT_WORDS 8
#define SELBITS (SELBIT_WORDS * 32)
#define PIN_ANY (-1)
#define FULL 0xffffffffu

// Mirrored by kernels/dra.py:_DraArgs (same members, same order).
struct DraArgs {
    int B, N, D, Q;
    int nt, pods, tiles;          // nodes a block, pods a block, node tiles
    const uint8_t* dev_valid;     // [N, D] bool
    const uint32_t* dev_selbits;  // [N, D, 8]
    const uint8_t* dev_in_use;    // [N, D] bool
    const uint32_t* req_mask;     // [B, Q, 8]
    const int* req_count;         // [B, Q]
    const uint8_t* req_all;       // [B, Q] bool
    const int* pinned;            // [B]
    const uint8_t* active;        // [B] bool
    const uint8_t* static_ok;     // [B, N] bool: phase 1's per-pod mask
    const uint8_t* host_ok;       // [B, N] bool, or null
    uint8_t* out_ok;              // [B, N] bool: static_ok & dra_ok & host_ok
    uint8_t* dra_ok;              // [B, N] bool, or null (not written)
    int* dra_reject;              // [B], zeroed by the caller
};

// a tile byte's bits
#define T_SOK 1u
#define T_HOST 2u
#define T_DOK 4u

__global__ void __launch_bounds__(THREADS) dra_feasible(DraArgs A) {
    extern __shared__ __align__(16) uint32_t sm[];
    uint32_t* s_union = sm;                          // [warps, 8]
    uint32_t* s_free = s_union + WARPS * SELBIT_WORDS;  // [SW]
    uint32_t* s_bits = s_free + SW;                  // [used bits, SW]
    int* s_rem = reinterpret_cast<int*>(s_bits + SELBITS * SW);  // [Q, pods]
    uint8_t* s_rank = reinterpret_cast<uint8_t*>(s_rem + A.Q * A.pods);
    uint8_t* s_tile = s_rank + SELBITS;              // [pods, nt]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int tile = blockIdx.x % A.tiles, chunk = blockIdx.x / A.tiles;
    const int n0 = tile * A.nt, p0 = chunk * A.pods;
    const int np = min(A.pods, A.B - p0), nn = min(A.nt, A.N - n0);
    const int ndw = (A.D + 31) >> 5;
    const bool want_dok = A.dra_ok != nullptr;

    // the block's union of request masks (active pods, used slots): each
    // warp's, then every thread ORs the warps' after the barrier
    uint32_t u[SELBIT_WORDS] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    for (int i = tid; i < np * A.Q; i += THREADS) {
        const long bq = (long)p0 * A.Q + i;
        if (!A.active[p0 + i / A.Q]) continue;
        if (!(A.req_count[bq] > 0 || A.req_all[bq])) continue;
        const uint4* m = reinterpret_cast<const uint4*>(A.req_mask + bq * 8);
        const uint4 lo = m[0], hi = m[1];
        u[0] |= lo.x; u[1] |= lo.y; u[2] |= lo.z; u[3] |= lo.w;
        u[4] |= hi.x; u[5] |= hi.y; u[6] |= hi.z; u[7] |= hi.w;
    }
    for (int w = 0; w < SELBIT_WORDS; ++w) {
        uint32_t x = u[w];
        for (int o = 16; o > 0; o >>= 1) x |= __shfl_xor_sync(FULL, x, o);
        if (lane == 0) s_union[warp * SELBIT_WORDS + w] = x;
    }
    // the tile's static / host bytes, as rows of nt
    for (int i = tid; i < np * A.nt; i += THREADS) {
        const int k = i / A.nt, l = i - k * A.nt;
        uint8_t t = 0;
        if (l < nn) {
            const long at = (long)(p0 + k) * A.N + n0 + l;
            if (A.static_ok[at]) t |= T_SOK;
            if (A.host_ok == nullptr || A.host_ok[at]) t |= T_HOST;
        }
        s_tile[i] = t;
    }
    __syncthreads();
    uint32_t un[SELBIT_WORDS];
    for (int w = 0; w < SELBIT_WORDS; ++w) {
        un[w] = 0u;
        for (int j = 0; j < WARPS; ++j) un[w] |= s_union[j * SELBIT_WORDS + w];
    }
    // each used bit's rank: its row of s_bits
    for (int b = tid; b < SELBITS; b += THREADS) {
        const int w = b >> 5, bit = b & 31;
        int r = 0;
        for (int j = 0; j < w; ++j) r += __popc(un[j]);
        r += __popc(un[w] & ((1u << bit) - 1u));
        s_rank[b] = (uint8_t)r;
    }

    for (int l = 0; l < nn; ++l) {
        const int n = n0 + l;
        const long drow = (long)n * A.D;
        for (int c0 = 0; c0 < ndw; c0 += SW) {
            // the previous chunk's readers are done (the first chunk's
            // stage reads only the union)
            if (l > 0 || c0 > 0) __syncthreads();
            // stage: a warp a device word
            for (int wl = warp; wl < SW; wl += THREADS / 32) {
                const int w = c0 + wl;
                const int d = (w << 5) + lane;
                const bool has = w < ndw && d < A.D;
                uint32_t sel[SELBIT_WORDS] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
                bool fr = false;
                if (has) {
                    fr = A.dev_valid[drow + d] && !A.dev_in_use[drow + d];
                    const uint4* p = reinterpret_cast<const uint4*>(
                        A.dev_selbits + (drow + d) * SELBIT_WORDS);
                    const uint4 lo = p[0], hi = p[1];
                    sel[0] = lo.x; sel[1] = lo.y; sel[2] = lo.z;
                    sel[3] = lo.w; sel[4] = hi.x; sel[5] = hi.y;
                    sel[6] = hi.z; sel[7] = hi.w;
                }
                const uint32_t f = __ballot_sync(FULL, fr);
                if (lane == 0) s_free[wl] = f;
                int r = 0;
#pragma unroll
                for (int j = 0; j < SELBIT_WORDS; ++j) {
                    uint32_t bits = un[j];
                    while (bits) {
                        const int b = __ffs(bits) - 1;
                        bits &= bits - 1u;
                        const uint32_t v = __ballot_sync(
                            FULL, (sel[j] >> b) & 1u);
                        if (lane == 0) s_bits[r * SW + wl] = v;
                        ++r;
                    }
                }
            }
            __syncthreads();
            for (int k = tid; k < np; k += THREADS) {
                const int b = p0 + k;
                uint8_t* tb = s_tile + k * A.nt + l;
                if (!A.active[b]) continue;
                if (!want_dok && !(*tb & T_SOK)) continue;
                const int pin = A.pinned[b];
                if (!(pin >= 0 ? n == pin : pin == PIN_ANY)) continue;
                const long qb = (long)b * A.Q;
                uint32_t taken[SW];
#pragma unroll
                for (int w = 0; w < SW; ++w) taken[w] = 0u;
                for (int q = 0; q < A.Q; ++q) {
                    const int cnt = A.req_count[qb + q];
                    const bool all = A.req_all[qb + q] != 0;
                    // an unused slot picks nothing and constrains nothing
                    if (!(cnt > 0 || all)) continue;
                    int* rem = s_rem + q * A.pods + k;
                    if (c0 == 0) *rem = all ? 1 : cnt;
                    int left = *rem;
                    if (!all && left <= 0) continue;  // satisfied
                    uint32_t e[SW];
#pragma unroll
                    for (int w = 0; w < SW; ++w) e[w] = s_free[w] & ~taken[w];
                    const uint4* mp = reinterpret_cast<const uint4*>(
                        A.req_mask + (qb + q) * SELBIT_WORDS);
                    const uint4 lo = mp[0], hi = mp[1];
                    const uint32_t m[SELBIT_WORDS] = {lo.x, lo.y, lo.z, lo.w,
                                                      hi.x, hi.y, hi.z, hi.w};
#pragma unroll
                    for (int j = 0; j < SELBIT_WORDS; ++j) {
                        uint32_t bits = m[j];
                        while (bits) {
                            const int bb = __ffs(bits) - 1;
                            bits &= bits - 1u;
                            const uint32_t* row =
                                s_bits + s_rank[(j << 5) + bb] * SW;
#pragma unroll
                            for (int w = 0; w < SW; ++w) e[w] &= row[w];
                        }
                    }
                    if (all) {
#pragma unroll
                        for (int w = 0; w < SW; ++w) {
                            taken[w] |= e[w];
                            if (e[w]) left = 0;
                        }
                    } else {
                        // the lowest `left` eligible devices, device order
#pragma unroll
                        for (int w = 0; w < SW; ++w) {
                            uint32_t x = e[w];
                            const int pc = __popc(x);
                            if (left <= 0 || !x) continue;
                            if (pc <= left) {
                                taken[w] |= x;
                                left -= pc;
                            } else {
                                uint32_t pick = 0u;
                                for (int i = 0; i < left; ++i) {
                                    const uint32_t low = x & (~x + 1u);
                                    pick |= low;
                                    x ^= low;
                                }
                                taken[w] |= pick;
                                left = 0;
                            }
                        }
                    }
                    *rem = left;
                }
                if (c0 + SW >= ndw) {
                    // the node's last chunk: every used request satisfied?
                    bool ok = true;
                    for (int q = 0; q < A.Q; ++q) {
                        const int cnt = A.req_count[qb + q];
                        if (!(cnt > 0 || A.req_all[qb + q])) continue;
                        if (s_rem[q * A.pods + k] > 0) ok = false;
                    }
                    if (ok) *tb |= T_DOK;
                }
            }
        }
    }
    __syncthreads();
    // verdicts, written as the tile's rows; inactive rows verdict True
    for (int i = tid; i < np * A.nt; i += THREADS) {
        const int k = i / A.nt, l = i - k * A.nt;
        if (l >= nn) continue;
        const uint8_t t = s_tile[i];
        const bool dok = (t & T_DOK) || !A.active[p0 + k];
        const long at = (long)(p0 + k) * A.N + n0 + l;
        A.out_ok[at] = ((t & T_SOK) && (t & T_HOST) && dok) ? 1 : 0;
        if (want_dok) A.dra_ok[at] = dok ? 1 : 0;
    }
    for (int k = tid; k < np; k += THREADS) {
        if (!A.active[p0 + k]) continue;
        int rej = 0;
        for (int l = 0; l < nn; ++l) {
            const uint8_t t = s_tile[k * A.nt + l];
            if ((t & T_SOK) && !(t & T_DOK)) ++rej;
        }
        if (rej) atomicAdd(A.dra_reject + p0 + k, rej);
    }
}

extern "C" int dra_feasible_launch(const DraArgs* args, int smem,
                                   void* stream) {
    const DraArgs& A = *args;
    if (A.B < 1 || A.N < 1 || A.D < 1 || A.Q < 1 || A.nt < 1 || A.pods < 1
            || A.tiles != (A.N + A.nt - 1) / A.nt)
        return (int)cudaErrorInvalidValue;
    const long blocks = (long)A.tiles * ((A.B + A.pods - 1) / A.pods);
    if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            dra_feasible, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    dra_feasible<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
        A);
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
