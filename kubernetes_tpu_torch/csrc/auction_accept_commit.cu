// K2b auction_accept_commit: one auction round's per-node acceptance and
// the commit of the accepted pods into the (free, nzr) usage chain.
//
// Replaces: the acceptance half of kubernetes_tpu/models/pipeline.py
// `_rounds_commit` (:535) round `body` (:649-702): the one-accept-per-node
// branch (B <= N, first chooser in batch order) and the K-accept branch
// (B > N: per node, the first k_accept choosers in batch order are
// "taken"; a taken pod is accepted when the cumulative request of ALL
// taken pods up to and including it fits its own effective free row, per
// resource), then free -= onehot.T @ req, nzr += onehot.T @ nonzero_req,
// placed, win and the progress flag. The twin is
// kubernetes_tpu_torch/kernels/auction.py:auction_accept_commit_ref.
//
// Work: the nodes are cut into slices, one a block, sized by the wrapper
// (kernels/auction.py plan_commit) so that the grid covers the card's SMs
// (64 nodes a block at N = 8,192). Each block streams the round's B
// choices once, coalesced, and keeps only those that land in its slice:
//
// - one accept a node: the first chooser of each node is a shared-memory
//   atomicMin on the batch index (one a warp: lanes naming one node are
//   merged by __match_any_sync, the lowest lane being the earliest pod);
// - K-accept: a stable counting sort by node. A first pass counts each
//   warp's choosers of each node (warps take consecutive stretches of the
//   batch); a prefix over warps and nodes gives every (warp, node) its
//   first rank; a second pass writes each chooser of rank < k_accept at
//   its node's offset plus its rank, so each node's list holds its first
//   k_accept choosers in batch order. Each node's thread then walks only
//   its own list: one resource at a time, a running cumulative request
//   against the effective free row, marking the entries that do not fit
//   (no run-time-indexed array: nothing sits in local memory, and R is
//   not capped); then the accepted entries' placed/win, nzr and free.
//
// Each node's row and each accepted pod's placed/win entries have one
// writer, so the commit is deterministic; it is exact because requests are
// integer-valued float32 (milli-CPU, MiB, counts), whose sums are exact in
// any order below 2^24; the sums still run in batch order, as in the twin.
// A node's list needs at most B entries; it is in shared memory when B
// entries fit (plan_commit), else in a global scratch of B entries a
// block (the wrapper counts those launches).
//
// What bounds it on an H100: latency. A round moves ~B*8 + N*(3R+2)*4
// bytes and does ~(R+2) operations an accepted pod; the block's pass over
// the choices (16 KB at B = 4,096, from L2) and a few barriers are its
// floor.
//
// Built with -fmad=false like the other kernels of the round.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define FULL 0xffffffffu
#define UNROLL 8                // choices a thread loads before using them
#define ENTRY_B 0x1fffffff      // a list entry's batch index
#define ENTRY_OWN 0x20000000    // the pod's nominated row is this node
#define ENTRY_REJ 0x40000000    // its cumulative request did not fit

// Mirrored by kernels/auction.py:_CommitArgs (same members, same order).
struct CommitArgs {
    int N, B, R, multi_accept;
    int slice;              // nodes a block
    int list_shared;        // K-accept: 1 = lists in shared memory
    const int* choice;      // [B]  this round's bids (-1 = none)
    const float* win_now;   // [B]
    const float* nom;       // [N, R]
    const float* req;       // [B, R]
    const float* nzreq;     // [B, 2]
    const int* nominated_row;  // [B]
    const int* k_accept;    // [] per-node budget (multi_accept only)
    const int* prog_in;
    int* prog_out;
    float* free;            // [N, R]  updated in place
    float* nzr;             // [N, 2]  updated in place
    int* placed;            // [B]     updated in place
    float* win;             // [B]     updated in place
    int* scratch;           // [blocks, B] lists when list_shared == 0
};

// one accepted pod b of node n (one accept a node): its row, nzr, placed
// and win; 0 + q as the twin's index_add into zeros
__device__ __forceinline__ void commit_one(const CommitArgs& A, int n,
                                           int b) {
    const int R = A.R;
    for (int r = 0; r < R; ++r) {
        float acc = 0.0f + A.req[(size_t)b * R + r];
        A.free[(size_t)n * R + r] = A.free[(size_t)n * R + r] - acc;
    }
    A.nzr[2 * n] = A.nzr[2 * n] + (0.0f + A.nzreq[2 * b]);
    A.nzr[2 * n + 1] = A.nzr[2 * n + 1] + (0.0f + A.nzreq[2 * b + 1]);
    A.placed[b] = n;
    A.win[b] = A.win_now[b];
}

// node n's walk over its list (its first k choosers, batch order)
__device__ bool walk_node(const CommitArgs& A, int n, int* list, int t) {
    const int R = A.R;
    for (int j = 0; j < t; ++j)
        if (A.nominated_row[list[j]] == n) list[j] |= ENTRY_OWN;
    for (int r = 0; r < R; ++r) {
        // round-start effective free before the own-nomination hand-back
        float base = A.free[(size_t)n * R + r] - A.nom[(size_t)n * R + r];
        float cum = 0.0f;
        for (int j = 0; j < t; ++j) {
            int e = list[j];
            float q = A.req[(size_t)(e & ENTRY_B) * R + r];
            cum = cum + q;
            float eff = base + ((e & ENTRY_OWN) ? q : 0.0f);
            if (!(cum <= eff)) list[j] = e | ENTRY_REJ;
        }
    }
    float nz0 = 0.0f, nz1 = 0.0f;
    bool any = false;
    for (int j = 0; j < t; ++j) {
        int e = list[j];
        if (e & ENTRY_REJ) continue;
        int b = e & ENTRY_B;
        nz0 = nz0 + A.nzreq[2 * b];
        nz1 = nz1 + A.nzreq[2 * b + 1];
        A.placed[b] = n;
        A.win[b] = A.win_now[b];
        any = true;
    }
    if (!any) return false;
    for (int r = 0; r < R; ++r) {
        float acc = 0.0f;
        for (int j = 0; j < t; ++j) {
            int e = list[j];
            if (!(e & ENTRY_REJ))
                acc = acc + A.req[(size_t)(e & ENTRY_B) * R + r];
        }
        A.free[(size_t)n * R + r] = A.free[(size_t)n * R + r] - acc;
    }
    A.nzr[2 * n] = A.nzr[2 * n] + nz0;
    A.nzr[2 * n + 1] = A.nzr[2 * n + 1] + nz1;
    return true;
}

template <bool MULTI>
__global__ void __launch_bounds__(THREADS) auction_commit(CommitArgs A) {
    extern __shared__ int smem[];
    if (*A.prog_in == 0) return;
    const int lo = blockIdx.x * A.slice;
    const int cnt = min(A.slice, A.N - lo);
    const int hi = lo + cnt;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned below = (1u << lane) - 1u;
    bool any = false;
    if (!MULTI) {
        int* first = smem;                       // [slice]
        for (int i = tid; i < cnt; i += THREADS) first[i] = A.B;
        __syncthreads();
        for (int base = 0; base < A.B; base += THREADS * UNROLL) {
            int cs[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                int b = base + u * THREADS + tid;
                cs[u] = b < A.B ? A.choice[b] : -1;
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                int b = base + u * THREADS + tid, c = cs[u];
                bool hit = c >= lo && c < hi;
                unsigned hits = __ballot_sync(FULL, hit);
                if (hit) {
                    unsigned peers = __match_any_sync(hits, c);
                    if ((peers & below) == 0) atomicMin(&first[c - lo], b);
                }
            }
        }
        __syncthreads();
        for (int i = tid; i < cnt; i += THREADS) {
            int b = first[i];
            if (b < A.B) {
                commit_one(A, lo + i, b);
                any = true;
            }
        }
    } else {
        const int k = *A.k_accept;
        int* wcnt = smem;                        // [WARPS, slice]
        int* noff = wcnt + WARPS * A.slice;      // [slice + 1]
        int* list = A.list_shared
                        ? noff + A.slice + 1     // [B]
                        : A.scratch + (size_t)blockIdx.x * A.B;
        int* mine = wcnt + warp * A.slice;
        for (int i = tid; i < WARPS * A.slice; i += THREADS) wcnt[i] = 0;
        __syncthreads();
        // each warp's consecutive stretch of the batch
        const int seg = ((A.B + WARPS - 1) / WARPS + 31) & ~31;
        const int s0 = warp * seg, s1 = min(A.B, s0 + seg);
        for (int base = s0; base < s1; base += 32 * UNROLL) {
            int cs[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                int b = base + 32 * u + lane;
                cs[u] = b < s1 ? A.choice[b] : -1;
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                int c = cs[u];
                bool hit = c >= lo && c < hi;
                unsigned hits = __ballot_sync(FULL, hit);
                if (hit) {
                    unsigned peers = __match_any_sync(hits, c);
                    if ((peers & below) == 0) mine[c - lo] += __popc(peers);
                }
                __syncwarp();
            }
        }
        __syncthreads();
        // each warp's first rank at each node; the node's taken count
        for (int i = tid; i < cnt; i += THREADS) {
            int run = 0;
            for (int w = 0; w < WARPS; ++w) {
                int t = wcnt[w * A.slice + i];
                wcnt[w * A.slice + i] = run;
                run += t;
            }
            noff[i] = min(run, k);
        }
        __syncthreads();
        // exclusive prefix of the taken counts: each node's list offset
        if (warp == 0) {
            int carry = 0;
            for (int i0 = 0; i0 < cnt; i0 += 32) {
                int i = i0 + lane;
                int v = i < cnt ? noff[i] : 0;
                int x = v;
                for (int o = 1; o < 32; o <<= 1) {
                    int y = __shfl_up_sync(FULL, x, o);
                    if (lane >= o) x += y;
                }
                if (i < cnt) noff[i] = carry + x - v;
                carry += __shfl_sync(FULL, x, 31);
            }
            if (lane == 0) noff[cnt] = carry;
        }
        __syncthreads();
        // stable scatter: a chooser of rank < k at its node's offset + rank
        for (int base = s0; base < s1; base += 32 * UNROLL) {
            int cs[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                int b = base + 32 * u + lane;
                cs[u] = b < s1 ? A.choice[b] : -1;
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                int b = base + 32 * u + lane, c = cs[u];
                bool hit = c >= lo && c < hi;
                unsigned hits = __ballot_sync(FULL, hit);
                unsigned peers = 0;
                int start = 0;
                if (hit) {
                    peers = __match_any_sync(hits, c);
                    start = mine[c - lo];
                    int r = start + __popc(peers & below);
                    if (r < k) list[noff[c - lo] + r] = b;
                }
                __syncwarp();
                if (hit && (peers & below) == 0)
                    mine[c - lo] = start + __popc(peers);
                __syncwarp();
            }
        }
        __syncthreads();
        for (int i = tid; i < cnt; i += THREADS)
            if (walk_node(A, lo + i, list + noff[i], noff[i + 1] - noff[i]))
                any = true;
    }
    if (any) *A.prog_out = 1;
}

extern "C" int auction_accept_commit_launch(const CommitArgs* args, int smem,
                                            void* stream) {
    const CommitArgs& A = *args;
    if (A.slice < 1 || A.N < 1 || A.B >= ENTRY_B)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    int blocks = (A.N + A.slice - 1) / A.slice;
    if (A.multi_accept) {
        if (smem > 48 * 1024) {
            cudaError_t e = cudaFuncSetAttribute(
                auction_commit<true>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (e != cudaSuccess) return (int)e;
        }
        auction_commit<true><<<blocks, THREADS, smem, s>>>(A);
    } else {
        auction_commit<false><<<blocks, THREADS, smem, s>>>(A);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
