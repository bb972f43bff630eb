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
// Grid: one block a tile of rows of one field. A field of width W gets
// L lanes a row (W rounded up to a power of two, at most 32), so a tile
// is THREADS / L rows; a lane walks columns lane, lane + L, ... of its
// row. Row and column come from shifts and masks: no division. The
// launch entry lays the tiles out (f_lg, f_tile0), so the grid is the
// fields' tiles and nothing more; a block finds its field by a binary
// search of f_tile0.
//
// Two argument blocks: UnpackArgs holds up to 96 fields (every field of
// the cluster or of a pod batch); FewArgs up to 4 (the chain's seed, two
// fields of one blob). The wrapper binds each plan's entry and block
// once and rewrites only its pointers per call; the small block keeps
// the seed's launch parameters to a few hundred bytes.
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
#define MAX_FEW 4

// Mirrored by kernels/unpack.py:_UnpackArgs (same members, same order).
// f_lg and f_tile0 are the launch entry's: the wrapper leaves them 0.
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
    int f_lg[MAX_FIELDS];               // log2 of the lanes a row
    int f_tile0[MAX_FIELDS + 1];        // first tile of each field, total
};

// Mirrored by kernels/unpack.py:_FewArgs: UnpackArgs for at most MAX_FEW
// fields.
struct FewArgs {
    int nsrc, nfields;
    int src_rows[MAX_SRC];
    long src_stride[MAX_SRC];
    const unsigned int* src[MAX_SRC];
    unsigned char* dst;
    int f_src[MAX_FEW];
    int f_col[MAX_FEW];
    int f_width[MAX_FEW];
    int f_bool[MAX_FEW];
    long f_dst[MAX_FEW];
    int f_lg[MAX_FEW];
    int f_tile0[MAX_FEW + 1];
};

template <class Args>
__device__ __forceinline__ void unpack_tile(const Args& A) {
    const int b = (int)blockIdx.x;
    int lo = 0, hi = A.nfields - 1;     // the last field whose tile0 <= b
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (A.f_tile0[mid] <= b) lo = mid; else hi = mid - 1;
    }
    const int f = lo;
    const int s = A.f_src[f];
    const int W = A.f_width[f];
    const int lg = A.f_lg[f];
    const int row = (b - A.f_tile0[f]) * (THREADS >> lg)
                    + ((int)threadIdx.x >> lg);
    if (row >= A.src_rows[s]) return;
    const unsigned int* src =
        A.src[s] + (long)row * A.src_stride[s] + A.f_col[f];
    unsigned char* out = A.dst + A.f_dst[f];
    const long o = (long)row * W;
    if (A.f_bool[f]) {
        for (int c = (int)threadIdx.x & ((1 << lg) - 1); c < W; c += 1 << lg)
            out[o + c] = src[c] != 0u;
    } else {
        unsigned int* o32 = (unsigned int*)out + o;
        for (int c = (int)threadIdx.x & ((1 << lg) - 1); c < W; c += 1 << lg)
            o32[c] = src[c];
    }
}

__global__ void __launch_bounds__(THREADS) blob_unpack(UnpackArgs A) {
    unpack_tile(A);
}

__global__ void __launch_bounds__(THREADS) blob_unpack_few(FewArgs A) {
    unpack_tile(A);
}

// Checks the block, lays out the tiles and launches; 0 or a CUDA error.
template <class Args>
static int launch(Args A, int max_fields, void (*kernel)(Args),
                  void* stream) {
    if (A.nsrc < 1 || A.nsrc > MAX_SRC || A.nfields < 1
        || A.nfields > max_fields || !A.dst)
        return (int)cudaErrorInvalidValue;
    int tiles = 0;
    for (int f = 0; f < A.nfields; ++f) {
        int s = A.f_src[f];
        if (s < 0 || s >= A.nsrc || !A.src[s] || A.f_width[f] < 1
            || A.src_rows[s] < 1 || A.f_col[f] < 0
            || A.f_col[f] + A.f_width[f] > A.src_stride[s]
            || (!A.f_bool[f] && A.f_dst[f] % 4))
            return (int)cudaErrorInvalidValue;
        int lg = 0;
        while (lg < 5 && (1 << lg) < A.f_width[f]) ++lg;
        A.f_lg[f] = lg;
        A.f_tile0[f] = tiles;
        const int rows_a_tile = THREADS >> lg;
        tiles += (A.src_rows[s] + rows_a_tile - 1) / rows_a_tile;
    }
    A.f_tile0[A.nfields] = tiles;
    kernel<<<tiles, THREADS, 0, (cudaStream_t)stream>>>(A);
    return (int)cudaGetLastError();
}

extern "C" int blob_unpack_launch(const UnpackArgs* args, void* stream) {
    return launch(*args, MAX_FIELDS, blob_unpack, stream);
}

extern "C" int blob_unpack_few_launch(const FewArgs* args, void* stream) {
    return launch(*args, MAX_FEW, blob_unpack_few, stream);
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
