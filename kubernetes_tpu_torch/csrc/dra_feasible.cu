// K8 dra_feasible: batched DRA allocation feasibility, fused after phase 1.
//
// Replaces: kubernetes_tpu/ops/dra.py `batch_feasible` (:104, jit :152) as
// the JAX package fuses it into phase 1 (kubernetes_tpu/models/pipeline.py
// :1023-1039): dra_ok = batch_feasible(dra); dra_reject[b] = sum_n
// (static_ok & ~dra_ok); static_ok &= dra_ok; then the host Filter
// verdicts (host_ok) AND in. The twin is
// kubernetes_tpu_torch/ops/dra.py:fuse_phase1.
//
// One thread per (pod, node): blockIdx.y is the pod, blockIdx.x * THREADS
// + threadIdx.x the node row. The block stages the pod's request masks,
// counts and modes in shared memory. The thread keeps the devices taken
// by the pod's earlier requests as 64-bit words (D may exceed 64), and for
// each request builds the word of eligible devices (valid, not in use,
// not taken, every required selector bit set), counts it with popcount
// against `want`, and takes its lowest `count` set bits (all of them in
// All mode) in device order: the reference's cumsum pick. Then the pin
// check. Every step is integer: card and twin agree exactly. The per-pod
// reject count is a block count (__syncthreads_count) plus one integer
// atomicAdd, exact in any order.
//
// What bounds it on an H100: the selector tests, B * N * Q * D words of 8
// 32-bit ANDs, read from L2 (the [N, D, 8] verdict table of a 5,000-node
// cluster with 128 devices a node is 33.5 MB, within the 50 MB L2). A
// faster design shares one pass over a node's selector bits among the
// pods of a block, or bitslices the table; this one is simple and exact.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define SELBIT_WORDS 8
#define MAX_Q 64
#define MAX_DWORDS 64        // D <= 4096 devices a node
#define PIN_ANY (-1)

// Mirrored by kernels/dra.py:_DraArgs (same members, same order).
struct DraArgs {
    int B, N, D, Q;
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

__global__ void __launch_bounds__(THREADS) dra_feasible(DraArgs A) {
    __shared__ uint32_t s_mask[MAX_Q * SELBIT_WORDS];
    __shared__ int s_count[MAX_Q];
    __shared__ uint8_t s_all[MAX_Q];
    const int b = blockIdx.y;
    const int n = blockIdx.x * THREADS + threadIdx.x;
    const bool act = A.active[b] != 0;
    if (act) {
        const long qb = (long)b * A.Q;
        for (int i = threadIdx.x; i < A.Q * SELBIT_WORDS; i += THREADS)
            s_mask[i] = A.req_mask[qb * SELBIT_WORDS + i];
        for (int i = threadIdx.x; i < A.Q; i += THREADS) {
            s_count[i] = A.req_count[qb + i];
            s_all[i] = A.req_all[qb + i];
        }
    }
    __syncthreads();
    const bool in_range = n < A.N;
    const long bn = (long)b * A.N + n;
    const bool sok = in_range && A.static_ok[bn] != 0;
    bool ok = true;
    if (act && in_range) {
        const int ndw = (A.D + 63) >> 6;
        uint64_t taken[MAX_DWORDS];
        for (int w = 0; w < ndw; ++w) taken[w] = 0ull;
        const long row = (long)n * A.D;
        for (int q = 0; q < A.Q; ++q) {
            const int cnt = s_count[q];
            const bool all = s_all[q] != 0;
            // an unused slot (count <= 0, not All) picks nothing and
            // constrains nothing
            if (!(cnt > 0 || all)) continue;
            uint32_t m[SELBIT_WORDS];
            for (int w = 0; w < SELBIT_WORDS; ++w)
                m[w] = s_mask[q * SELBIT_WORDS + w];
            const int want = all ? 1 : cnt;
            int remaining = all ? 0x7fffffff : cnt;
            int total = 0;
            for (int w = 0; w < ndw; ++w) {
                uint64_t e = 0ull;
                const int d0 = w << 6;
                const int d1 = min(A.D, d0 + 64);
                for (int d = d0; d < d1; ++d) {
                    const long idx = row + d;
                    if (!A.dev_valid[idx] || A.dev_in_use[idx]) continue;
                    const uint64_t bit = 1ull << (d - d0);
                    if (taken[w] & bit) continue;
                    const uint4* p = reinterpret_cast<const uint4*>(
                        A.dev_selbits + idx * SELBIT_WORDS);
                    const uint4 lo = p[0], hi = p[1];
                    const bool sel =
                        (lo.x & m[0]) == m[0] && (lo.y & m[1]) == m[1]
                        && (lo.z & m[2]) == m[2] && (lo.w & m[3]) == m[3]
                        && (hi.x & m[4]) == m[4] && (hi.y & m[5]) == m[5]
                        && (hi.z & m[6]) == m[6] && (hi.w & m[7]) == m[7];
                    if (sel) e |= bit;
                }
                const int pc = __popcll(e);
                total += pc;
                if (remaining > 0) {
                    if (pc <= remaining) {
                        taken[w] |= e;
                        remaining -= pc;
                    } else {
                        // the lowest `remaining` eligible devices of this
                        // word: the rest of the cumsum pick
                        uint64_t pick = 0ull;
                        for (int k = 0; k < remaining; ++k) {
                            const uint64_t low = e & (~e + 1ull);
                            pick |= low;
                            e ^= low;
                        }
                        taken[w] |= pick;
                        remaining = 0;
                    }
                }
            }
            if (total < want) ok = false;
        }
        const int pin = A.pinned[b];
        ok = ok && (pin >= 0 ? n == pin : pin == PIN_ANY);
    }
    // inactive rows verdict True
    const bool dok = ok || !act;
    if (in_range) {
        bool out = sok && dok;
        if (A.host_ok != nullptr) out = out && A.host_ok[bn] != 0;
        A.out_ok[bn] = out ? 1 : 0;
        if (A.dra_ok != nullptr) A.dra_ok[bn] = dok ? 1 : 0;
    }
    const int rej = __syncthreads_count(sok && !dok);
    if (threadIdx.x == 0 && rej > 0) atomicAdd(A.dra_reject + b, rej);
}

extern "C" int dra_feasible_launch(const DraArgs* args, void* stream) {
    DraArgs A = *args;
    if (A.B < 1 || A.N < 1 || A.D < 1 || A.Q < 1 || A.Q > MAX_Q
            || A.D > MAX_DWORDS * 64 || A.B > 65535)
        return (int)cudaErrorInvalidValue;
    dim3 grid((A.N + THREADS - 1) / THREADS, A.B);
    dra_feasible<<<grid, THREADS, 0, (cudaStream_t)stream>>>(A);
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
