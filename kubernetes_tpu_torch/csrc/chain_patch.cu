// K11 chain_patch: fold node-row patches into the device-resident usage
// chain, out of place, in one launch.
//
// Replaces: kubernetes_tpu/models/pipeline.py `_chain_set_rows_jit`
// (:1645) and `_chain_add_rows_jit` (:1650), as `patch_chain` (:1655)
// calls them. The twin is kubernetes_tpu_torch/ops/chain.py
// `patch_chain_ref` (through kernels/chain.py).
//
// Writes new out_free [N, R] and out_nzr [N, 2] (contiguous): the input
// rows (free and nzr may be row-strided views), with the S set rows
// replaced and then the A add rows added. The patches arrive as one
// [S + A, R + 3] f32 buffer, one row a patch: its node row's index (int
// bits), its R free values, its 2 nzr values; sets first. The wrapper
// has checked the contract on the host: set indices unique, add indices
// unique, no index both a set and an add, every index below N. So each
// output element is one copy or one f32 add, in the reference's order
// (set, then add), and card and twin agree bit for bit.
//
// One block a slice of ROWS node rows. The block first marks, in shared
// memory, which of its rows a patch names (each of its threads reads a
// share of the S + A indices; by the contract no row is named twice),
// then its threads walk the slice's elements, neighbouring threads on
// neighbouring columns.
//
// What bounds it on an H100: launch latency. At the 8,192-node bucket
// and R = 8 it moves 0.66 MB (every input row read once, every output
// row written once, the patches read once), 0.2 us at 3.35 TB/s, under
// the ~3 us floor of a launch; its redesign is not queued.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define ROWS 32

// Mirrored by kernels/chain.py:_ChainArgs (same members, same order).
struct ChainArgs {
    int N, R, S, A;
    int free_stride, nzr_stride;
    const float* free;      // [N, R], row stride free_stride
    const float* nzr;       // [N, 2], row stride nzr_stride
    const float* patches;   // [S + A, R + 3]: index bits, free, nzr
    float* out_free;        // [N, R]
    float* out_nzr;         // [N, 2]
};

__global__ void __launch_bounds__(THREADS) chain_patch(ChainArgs A) {
    __shared__ int slot[ROWS];
    const int tid = threadIdx.x;
    const int row0 = blockIdx.x * ROWS;
    const int rows = min(ROWS, A.N - row0);
    const int W = A.R + 3;
    if (tid < ROWS) slot[tid] = -1;
    __syncthreads();
    for (int p = tid; p < A.S + A.A; p += THREADS) {
        int r = __float_as_int(A.patches[(long)p * W]) - row0;
        if (r >= 0 && r < rows) slot[r] = p;
    }
    __syncthreads();
    for (int e = tid; e < rows * A.R; e += THREADS) {
        int lr = e / A.R;
        int c = e - lr * A.R;
        long n = row0 + lr;
        float v = A.free[n * A.free_stride + c];
        int p = slot[lr];
        if (p >= 0) {
            float q = A.patches[(long)p * W + 1 + c];
            v = p < A.S ? q : v + q;
        }
        A.out_free[n * A.R + c] = v;
    }
    for (int e = tid; e < rows * 2; e += THREADS) {
        int lr = e >> 1;
        int c = e & 1;
        long n = row0 + lr;
        float v = A.nzr[n * A.nzr_stride + c];
        int p = slot[lr];
        if (p >= 0) {
            float q = A.patches[(long)p * W + 1 + A.R + c];
            v = p < A.S ? q : v + q;
        }
        A.out_nzr[n * 2 + c] = v;
    }
}

extern "C" int chain_patch_launch(const ChainArgs* args, void* stream) {
    ChainArgs A = *args;
    if (A.N < 1 || A.R < 1 || A.S < 0 || A.A < 0 || A.free_stride < A.R
        || A.nzr_stride < 2 || (A.S + A.A > 0 && A.patches == nullptr))
        return (int)cudaErrorInvalidValue;
    const int blocks = (A.N + ROWS - 1) / ROWS;
    chain_patch<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(A);
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
