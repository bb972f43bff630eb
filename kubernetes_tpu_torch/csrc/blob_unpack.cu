// K13 blob_unpack: named fields of packed blobs materialised as
// contiguous typed arrays, every field of a list in one launch.
//
// Replaces: kubernetes_tpu/models/pipeline.py `extract_state_jit`
// (:1632: the usage chain's seed, the blob's `free` and
// `nonzero_requested`), kubernetes_tpu/backend/mirror.py
// `_unpack_cluster_jit` (:89, `Mirror.to_device`) and `_unpack_pods_jit`
// (:120, `Mirror.pack_batch`). The twin is `BlobCodec.field` made
// contiguous (kubernetes_tpu_torch/ops/blobs.py `fields_ref`, through
// kernels/unpack.py).
//
// A blob is a [rows, stride] array of 4-byte words (the f32 and the i32
// blob of a struct). Field f is the words [col_f, col_f + width_f) of
// every row of blob src_f; it is written at byte offset dst_f of one
// output allocation as [rows, width_f] words, or, for a bool field, as
// [rows, width_f] bytes, 1 where the word is not 0 (the reference's
// `arr != 0`). Only copies and that compare: card and twin agree bit for
// bit.
//
// Grid: blockIdx.y a field, blockIdx.x a share of its words; neighbouring
// threads read neighbouring words of a row and write neighbouring outputs.
//
// What bounds it on an H100: launch latency. The seed at the 8,192-node
// bucket reads 10 of a row's 74 words and writes 320 KB (0.2 us at
// 3.35 TB/s); `to_device` of an 8,192-node cluster with a 16,384-slot
// pod table reads 58.4 MB and writes at most as much (35 us).

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define MAX_SRC 4
#define MAX_FIELDS 96
#define MAX_BLOCKS 1024

// Mirrored by kernels/unpack.py:_UnpackArgs (same members, same order).
struct UnpackArgs {
    int nsrc, nfields;
    int src_rows[MAX_SRC];
    long src_stride[MAX_SRC];           // words between rows
    const unsigned int* src[MAX_SRC];   // device [rows, stride] words
    unsigned char* dst;                 // device, every field's output
    int f_src[MAX_FIELDS];
    int f_col[MAX_FIELDS];
    int f_width[MAX_FIELDS];
    int f_bool[MAX_FIELDS];
    long f_dst[MAX_FIELDS];             // byte offset of the field
};

__global__ void __launch_bounds__(THREADS) blob_unpack(UnpackArgs A) {
    const int f = blockIdx.y;
    const int s = A.f_src[f];
    const int W = A.f_width[f];
    const long total = (long)A.src_rows[s] * W;
    const unsigned int* src = A.src[s] + A.f_col[f];
    const long stride = A.src_stride[s];
    unsigned char* out = A.dst + A.f_dst[f];
    const bool as_bool = A.f_bool[f] != 0;
    for (long e = (long)blockIdx.x * THREADS + threadIdx.x; e < total;
         e += (long)gridDim.x * THREADS) {
        long r = e / W;
        unsigned int v = src[r * stride + (e - r * W)];
        if (as_bool)
            out[e] = v != 0u;
        else
            ((unsigned int*)out)[e] = v;
    }
}

extern "C" int blob_unpack_launch(const UnpackArgs* args, void* stream) {
    const UnpackArgs& A = *args;
    if (A.nsrc < 1 || A.nsrc > MAX_SRC || A.nfields < 1
        || A.nfields > MAX_FIELDS || !A.dst)
        return (int)cudaErrorInvalidValue;
    long most = 1;
    for (int f = 0; f < A.nfields; ++f) {
        int s = A.f_src[f];
        if (s < 0 || s >= A.nsrc || !A.src[s] || A.f_width[f] < 1
            || A.f_col[f] < 0 || A.f_col[f] + A.f_width[f] > A.src_stride[s]
            || (!A.f_bool[f] && A.f_dst[f] % 4))
            return (int)cudaErrorInvalidValue;
        long n = (long)A.src_rows[s] * A.f_width[f];
        if (n > most) most = n;
    }
    long bx = (most + THREADS - 1) / THREADS;
    dim3 grid((unsigned)(bx < MAX_BLOCKS ? bx : MAX_BLOCKS), A.nfields);
    blob_unpack<<<grid, THREADS, 0, (cudaStream_t)stream>>>(A);
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
