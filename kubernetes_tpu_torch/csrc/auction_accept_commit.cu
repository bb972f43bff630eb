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
// Work: one thread per node, walking the batch's choices in batch order
// (staged through shared memory in tiles). One thread owns each node's
// updates, so the commit is deterministic; it is exact because requests
// are integer-valued float32 (milli-CPU, MiB, counts), whose sums are
// exact in any order below 2^24. Each accepted pod's placed/win entries
// are written by the one thread that owns its chosen node.
//
// What bounds it on an H100: latency, not bytes or flops. Every node
// thread reads all B choices (from shared memory) and touches only its
// own R+2 state words; a round moves ~B*4 + N*(2R+2)*4 bytes. The design
// stages the choices in 1024-entry shared tiles so the walk is served by
// shared memory; a bucketed (per-node list) layout is later work.
//
// Built with -fmad=false like the other kernels of the round.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define TILE 1024
#define MAX_R 32

struct CommitArgs {
    int N, B, R, multi_accept;
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
};

__global__ void auction_commit(CommitArgs A) {
    __shared__ int s_choice[TILE];
    if (*A.prog_in == 0) return;
    int n = blockIdx.x * blockDim.x + threadIdx.x;
    bool live = n < A.N;
    int R = A.R;
    float base[MAX_R], cum[MAX_R], acc[MAX_R];
    if (live) {
        for (int r = 0; r < R; ++r) {
            // round-start effective free row before the own-nomination
            // hand-back (eff_all's first two terms)
            base[r] = A.free[(size_t)n * R + r] - A.nom[(size_t)n * R + r];
            cum[r] = 0.0f;
            acc[r] = 0.0f;
        }
    }
    float acc_nz0 = 0.0f, acc_nz1 = 0.0f;
    int k = A.multi_accept ? *A.k_accept : 1;
    int rank = 0;
    bool any = false, done = false;
    for (int t0 = 0; t0 < A.B; t0 += TILE) {
        int len = min(TILE, A.B - t0);
        __syncthreads();
        for (int j = threadIdx.x; j < len; j += blockDim.x)
            s_choice[j] = A.choice[t0 + j];
        __syncthreads();
        if (!live || done) continue;
        for (int j = 0; j < len; ++j) {
            if (s_choice[j] != n) continue;
            int b = t0 + j;
            const float* rq = A.req + (size_t)b * R;
            bool accept;
            if (A.multi_accept) {
                bool take = rank < k;
                rank += 1;
                if (!take) continue;
                bool own = A.nominated_row[b] == n;
                accept = true;
                for (int r = 0; r < R; ++r) {
                    cum[r] = cum[r] + rq[r];
                    float eff = base[r] + (own ? rq[r] : 0.0f);
                    if (!(cum[r] <= eff)) accept = false;
                }
            } else {
                // first chooser in batch index order wins the node
                accept = true;
                done = true;
            }
            if (accept) {
                for (int r = 0; r < R; ++r) acc[r] = acc[r] + rq[r];
                acc_nz0 = acc_nz0 + A.nzreq[2 * b];
                acc_nz1 = acc_nz1 + A.nzreq[2 * b + 1];
                A.placed[b] = n;
                A.win[b] = A.win_now[b];
                any = true;
            }
            if (done) break;
        }
    }
    if (!live) return;
    if (any) {
        for (int r = 0; r < R; ++r)
            A.free[(size_t)n * R + r] = A.free[(size_t)n * R + r] - acc[r];
        A.nzr[2 * n] = A.nzr[2 * n] + acc_nz0;
        A.nzr[2 * n + 1] = A.nzr[2 * n + 1] + acc_nz1;
        *A.prog_out = 1;
    }
}

extern "C" int auction_accept_commit_launch(const CommitArgs* args,
                                            void* stream) {
    CommitArgs A = *args;
    if (A.R > MAX_R) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    int blocks = (A.N + THREADS - 1) / THREADS;
    auction_commit<<<blocks, THREADS, 0, s>>>(A);
    return (int)cudaGetLastError();
}

extern "C" int commit_args_size() { return (int)sizeof(CommitArgs); }

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
