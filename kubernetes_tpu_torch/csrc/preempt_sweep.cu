// K6a preempt_sweep: the minimal victim prefix per (preemptor, node).
//
// Replaces: kubernetes_tpu/ops/preempt.py `preempt_sweep` (:44, jitted at
// :109), the resource half of the reference's per-node preemption dry run
// (default_preemption.go:219 SelectVictimsOnNode) for every node at once.
// The twin is kubernetes_tpu_torch/ops/preempt.py:preempt_sweep (through
// kernels/preempt.py:preempt_sweep_ref); the static filters it folds in
// come from K1 (phase1_static.cu) with every feature active.
//
// One thread per (pod p, node n). The victims of node n, sorted from the
// least important up, free `cumsum[n, k, c]` of resource column
// `cols[c]` when the first k of them are evicted (k = 0 frees nothing).
// The thread computes
//
//   base[r]  = (free[n, r] - nom[n, r]) + (n == nominated_row[p] ? req[p, r]
//              : 0)                       the fit baseline of the pipeline
//   ok_rest  = for every column r that no victim frees (r not in cols):
//              req[p, r] <= base[r]
//   fit(k)   = ok_rest and for every c: req[p, cols[c]] <= base[cols[c]]
//              + cumsum[n, k, c]
//
// and writes the first k with fit(k), or NONE when K1's static_ok is false,
// when the request exceeds the node's allocatable in some column, or when
// no prefix fits. Padding entries of `cols` alias an active column and
// carry 3.0e38 in the cumsum, so they never bind; they never widen the set
// of columns ok_rest skips either, since that set is the set of values in
// `cols`, which the aliases repeat.
//
// Every comparison is an exact f32 compare of the twin's operands, added
// in the twin's order, and the output is an integer: card and twin agree
// exactly. base is recomputed where it is read (the same two operations on
// the same operands, so the same value), which keeps the thread's state in
// registers and lets R be any width.
//
// What bounds it on an H100: launch latency. At P = 1 over N = 8,192
// nodes with K + 1 = 9 prefixes of C = 4 columns it reads at most about
// 2 MB (the cumsum and three [N, R] matrices) and writes 32 KB; a thread
// stops at its first fitting prefix and a node that fails K1 reads one
// byte, so what a launch reads depends on its data.

#include <cuda_runtime.h>
#include <stdint.h>

#define NONE (-1)
#define THREADS 256

// Mirrored by kernels/preempt.py:_SweepArgs (same members, same order).
struct SweepArgs {
    int P, N, R, K1, C;
    const uint8_t* static_ok;   // [P, N]
    const float* free;          // [N, R]
    const float* nom;           // [N, R]
    const float* alloc;         // [N, R]
    const float* req;           // [P, R]
    const int* nominated_row;   // [P]
    const float* cumsum;        // [N, K1, C]
    const int* cols;            // [C]
    int* kmin;                  // [P, N]
};

__global__ void preempt_sweep(SweepArgs S) {
    long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long)S.P * S.N) return;
    int p = (int)(idx / S.N);
    int n = (int)(idx % S.N);
    int* out = S.kmin + idx;
    if (!S.static_ok[idx]) { *out = NONE; return; }
    const float* req = S.req + (long)p * S.R;
    const float* fr = S.free + (long)n * S.R;
    const float* nm = S.nom + (long)n * S.R;
    const float* al = S.alloc + (long)n * S.R;
    bool own = n == S.nominated_row[p];
    bool ok_rest = true;
    for (int r = 0; r < S.R; ++r) {
        if (req[r] > al[r]) { *out = NONE; return; }   // unresolvable
        bool freed = false;
        for (int c = 0; c < S.C; ++c) freed |= S.cols[c] == r;
        if (freed) continue;
        float b = fr[r] - nm[r];
        b = b + (own ? req[r] : 0.0f);
        if (!(req[r] <= b)) ok_rest = false;
    }
    if (!ok_rest) { *out = NONE; return; }
    const float* cs = S.cumsum + (long)n * S.K1 * S.C;
    for (int k = 0; k < S.K1; ++k) {
        bool fit = true;
        for (int c = 0; c < S.C && fit; ++c) {
            int col = S.cols[c];
            float b = fr[col] - nm[col];
            b = b + (own ? req[col] : 0.0f);
            float eff = b + cs[k * S.C + c];
            fit = req[col] <= eff;
        }
        if (fit) { *out = k; return; }
    }
    *out = NONE;
}

extern "C" int preempt_sweep_launch(const SweepArgs* args, void* stream) {
    SweepArgs S = *args;
    if (S.R < 1 || S.K1 < 1 || S.C < 1)
        return (int)cudaErrorInvalidValue;
    long total = (long)S.P * S.N;
    if (total > 0) {
        long blocks = (total + THREADS - 1) / THREADS;
        preempt_sweep<<<(unsigned)blocks, THREADS, 0,
                        (cudaStream_t)stream>>>(S);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
