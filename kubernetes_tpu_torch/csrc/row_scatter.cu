// K12 row_scatter: dirty rows of pinned host buffers written in place into
// their device-resident copies, up to MAX_BUFS buffers in one launch.
//
// Replaces: kubernetes_tpu/backend/mirror.py `_scatter_rows_jit` (:128,
// called by `Mirror._push` at :991) and
// kubernetes_tpu/framework/preemption.py `_scatter_rows0_jit` (:51,
// called by `_update_victims` at :1148): `buf.at[idx].set(rows)` with the
// buffer donated, so the update happens in place. The twin is
// kubernetes_tpu_torch/ops/scatter.py `scatter_rows_ref` (through
// kernels/scatter.py).
//
// Buffer j is a [M_j, width_j] array of 4-byte words (f32 and i32 rows
// go through the same code bit for bit; the victim cumsum's [N, K+1, C]
// rows are (K+1) * C words). Its rows_j indices idx_j are unique and
// below M_j (the wrapper checks them on the host), so every destination
// word is written once and the order of the writes does not matter. The
// source is the host buffer itself (the Mirror's blobs and the victim
// state's cumsum are numpy views of pinned tensors), row idx_j[i] to row
// idx_j[i]. Sources and indices are pinned host memory that the kernel
// reads over PCIe through their mapped device addresses: no pageable
// staging copy and no separate device copy of the rows. The write is
// stream-ordered on the caller's stream, as `index_copy_` is, so a
// launch queued before it reads the old rows.
//
// One block a tile of ROWS rows of one buffer: its first threads read
// the tile's indices into shared memory, then all its threads walk the
// tile's words, neighbouring threads on neighbouring words, UNROLL loads
// in flight a thread before their stores.
//
// What bounds it on an H100: the host link. At the 8,192-node bucket a
// dirty node row is 74 + 275 words and a pod-table slot 717 words, so
// 2,048 node rows and 2,048 slots are 8.7 MB read from the host (at the
// PCIe 5.0 x16 rate of 64 GB/s, 0.14 ms) and written to HBM once.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define ROWS 8
#define UNROLL 4
#define MAX_BUFS 4

// Mirrored by kernels/scatter.py:_ScatterArgs (same members, same order).
struct ScatterArgs {
    int nbuf;
    int width[MAX_BUFS];       // words a row
    int rows[MAX_BUFS];        // dirty rows
    int block0[MAX_BUFS + 1];  // first block of each buffer, then the total
    long dst_stride[MAX_BUFS]; // words between destination rows
    long src_stride[MAX_BUFS]; // words between source rows
    void* dst[MAX_BUFS];       // device [M, width] (row stride dst_stride)
    const void* src[MAX_BUFS]; // pinned host rows (mapped address)
    const int* idx[MAX_BUFS];  // pinned host [rows] indices (mapped)
};

__global__ void __launch_bounds__(THREADS) row_scatter(ScatterArgs A) {
    __shared__ int s_idx[ROWS];
    int j = 0;
    while (j + 1 < A.nbuf && (int)blockIdx.x >= A.block0[j + 1]) ++j;
    const int i0 = ((int)blockIdx.x - A.block0[j]) * ROWS;
    const int rows = min(ROWS, A.rows[j] - i0);
    const int W = A.width[j];
    const int* idx = A.idx[j];
    if ((int)threadIdx.x < rows) s_idx[threadIdx.x] = idx[i0 + threadIdx.x];
    __syncthreads();
    const uint32_t* src = (const uint32_t*)A.src[j];
    uint32_t* dst = (uint32_t*)A.dst[j];
    const long ss = A.src_stride[j], ds = A.dst_stride[j];
    const int total = rows * W;
    for (int e0 = threadIdx.x; e0 < total; e0 += THREADS * UNROLL) {
        uint32_t v[UNROLL];
        long to[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            int e = e0 + u * THREADS;
            to[u] = -1;
            if (e < total) {
                int r = e / W;
                int c = e - r * W;
                long row = s_idx[r];
                v[u] = src[row * ss + c];
                to[u] = row * ds + c;
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
            if (to[u] >= 0) dst[to[u]] = v[u];
    }
}

extern "C" int row_scatter_launch(const ScatterArgs* args, void* stream) {
    ScatterArgs A = *args;
    if (A.nbuf < 1 || A.nbuf > MAX_BUFS) return (int)cudaErrorInvalidValue;
    int blocks = 0;
    for (int j = 0; j < A.nbuf; ++j) {
        if (A.width[j] < 1 || A.rows[j] < 1 || A.dst_stride[j] < A.width[j]
            || A.src_stride[j] < A.width[j] || !A.dst[j] || !A.src[j]
            || !A.idx[j])
            return (int)cudaErrorInvalidValue;
        // the pinned host pointers' device addresses (the same value
        // under unified addressing; an unpinned pointer is an error)
        void* p = nullptr;
        cudaError_t err = cudaHostGetDevicePointer(&p, (void*)A.src[j], 0);
        if (err != cudaSuccess) return (int)err;
        A.src[j] = p;
        err = cudaHostGetDevicePointer(&p, (void*)A.idx[j], 0);
        if (err != cudaSuccess) return (int)err;
        A.idx[j] = (const int*)p;
        A.block0[j] = blocks;
        blocks += (A.rows[j] + ROWS - 1) / ROWS;
    }
    A.block0[A.nbuf] = blocks;
    row_scatter<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(A);
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
