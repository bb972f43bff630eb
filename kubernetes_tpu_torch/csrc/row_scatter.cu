// K12 row_scatter: dirty rows of pinned host buffers written in place into
// their device-resident copies, every buffer of a call in one launch.
//
// Replaces: kubernetes_tpu/backend/mirror.py `_scatter_rows_jit` (:128,
// called by `Mirror._push` at :991) and
// kubernetes_tpu/framework/preemption.py `_scatter_rows0_jit` (:51,
// called by `_update_victims` at :1148): `buf.at[idx].set(rows)` with the
// buffer donated, so the update happens in place. The twin is
// kubernetes_tpu_torch/ops/scatter.py `scatter_rows_ref` (through
// kernels/scatter.py).
//
// The launch entry plans the work on the host, in C (row_scatter_plan;
// its plain statement is kernels/scatter.py plan_chunks, which numpy
// would take ~100 host us to run): each buffer's sorted, unique dirty
// rows become runs of consecutive rows; where rows are packed (the row
// stride is the width, as in the Mirror's blobs and the victim cumsum),
// a run is one span of run x width 4-byte words. Spans are cut into
// chunks of at most CHUNK_WORDS words, each a (source address,
// destination address, words) triple written into the wrapper's pinned
// descriptor slot. Sources and descriptors are pinned host memory that
// the kernel reads over PCIe through their mapped device addresses: no
// pageable staging copy and no separate device copy of the rows. The
// write is stream-ordered on the caller's stream, as `index_copy_` is,
// so a launch queued before it reads the old rows. Every destination
// word is written once: the order of the writes does not matter.
//
// One warp a chunk, a grid-stride loop over a grid of one block a chunk
// up to a full card (consecutive chunks on different SMs): three lanes
// read the descriptor, then the warp loads the 16-byte-aligned vectors
// that cover the chunk, VEC of them a lane (a chunk in one pass), before
// its first store. A row of 74, 275 or 717 words (296, 1,100, 2,868 B)
// is not a multiple of 16 B, so a span's first and last vectors are
// partial: their words are stored one by one, as are all where the
// destination's alignment differs from the source's; the rest are
// 16-byte stores. No division a word, and no 4-byte load: each load is
// one aligned 16-byte request over the link.
//
// What bounds it on an H100: the host link. At the 8,192-node bucket a
// dirty node row is 74 + 275 words and a pod-table slot 717 words, so
// 2,048 node rows and 2,048 slots are 8.7 MB read from the host (at the
// PCIe 5.0 x16 rate of 64 GB/s, 0.14 ms) and written to HBM once.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
// a chunk: at most 255 16-byte vectors of words, 256 with a source that
// is not 16-byte aligned: VEC loads a lane of a warp
#define CHUNK_WORDS 1020
#define VEC 8
#define FULL 0xffffffffu

#define MAX_BUFS 4
// row_scatter_plan's codes for a broken contract (CUDA's are positive)
#define ERR_ORDER (-1)
#define ERR_RANGE (-2)
#define ERR_ROOM (-3)
#define ERR_JOB (-4)

// Mirrored by kernels/scatter.py:_ScatterJob (same members, same order;
// the wrapper fills one int64 row of eight a job).
struct ScatterJob {
    const long* idx;     // host [rows] row indices, strictly increasing
    long rows;           // dirty rows
    long width;          // words a row
    long src_stride;     // words between source rows
    long dst_stride;     // words between destination rows
    long src;            // mapped address of the pinned source rows
    long dst;            // device address of the destination rows
    long m;              // rows of the buffers: the indices' bound
};

// Mirrored by kernels/scatter.py:_ScatterArgs: the kernel's arguments.
struct ScatterArgs {
    int nchunks;
    const long* chunks;  // mapped pinned [nchunks, 3]: src, dst, words
};

__device__ __forceinline__ uint32_t word(const uint4& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Chunk c runs on block c % grid, warp c / grid (mod WARPS): a launch of
// few chunks (a run of short rows) spreads over as many SMs as it has
// chunks. A chunk's words are read as the 16-byte-aligned vectors that
// cover them, edges included: an aligned vector never crosses a page,
// so one that holds a word of the span is mapped. Every load issues
// before the first store, so the warp waits on the host link once a
// chunk (its descriptor before that).
__global__ void __launch_bounds__(THREADS) row_scatter(ScatterArgs A) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (long c = blockIdx.x + (long)gridDim.x * warp; c < A.nchunks;
         c += (long)gridDim.x * WARPS) {
        long long d = 0;
        if (lane < 3) d = A.chunks[3 * c + lane];
        const uintptr_t s = (uintptr_t)__shfl_sync(FULL, d, 0);
        uint32_t* t32 = (uint32_t*)(uintptr_t)__shfl_sync(FULL, d, 1);
        const int n = (int)__shfl_sync(FULL, d, 2);
        // the covering vectors: at most 32 x VEC (n <= CHUNK_WORDS)
        const uintptr_t a0 = s & ~(uintptr_t)15;
        const int lead = (int)((s - a0) >> 2);  // words before the span
        const int nvec = (lead + n + 3) >> 2;
        const uint4* sv = (const uint4*)a0;
        uint4 r[VEC];
#pragma unroll
        for (int u = 0; u < VEC; ++u)
            if (u * 32 + lane < nvec) r[u] = sv[u * 32 + lane];
        // vector v holds span words 4v - lead .. 4v - lead + 3; where the
        // destination shares the source's alignment a whole one is one
        // 16-byte store
        const bool aligned = ((((uintptr_t)t32) - 4 * lead) & 15) == 0;
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
            const int v = u * 32 + lane;
            const int w0 = 4 * v - lead;
            if (v >= nvec) continue;
            if (aligned && w0 >= 0 && w0 + 4 <= n) {
                *(uint4*)(t32 + w0) = r[u];
            } else {
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    if (w0 + k >= 0 && w0 + k < n) t32[w0 + k] = word(r[u], k);
            }
        }
    }
}

// The mapped device address of a pinned host pointer (the same value
// under unified addressing; an unpinned pointer is an error).
extern "C" int row_scatter_mapped(const void* host, void** device) {
    return (int)cudaHostGetDevicePointer(device, (void*)host, 0);
}

// The work list of the jobs into out (int64 [cap, 3]): kernels/scatter.py
// plan_chunks in C, on the launch path. Returns the chunks, or
// ERR_ORDER where a job's rows are not strictly increasing, ERR_RANGE
// where a row is outside [0, m), ERR_ROOM where cap is too small,
// ERR_JOB where a job is malformed.
extern "C" long row_scatter_plan(const ScatterJob* jobs, int njobs,
                                 long* __restrict__ out, long cap) {
    long n = 0;
    for (int j = 0; j < njobs; ++j) {
        // the job in locals: a store to out cannot change them
        const long* __restrict__ idx = jobs[j].idx;
        const long rows = jobs[j].rows, width = jobs[j].width;
        const long ss = jobs[j].src_stride, ds = jobs[j].dst_stride;
        const long src = jobs[j].src, dst = jobs[j].dst, m = jobs[j].m;
        if (rows < 1 || width < 1 || ss < width || ds < width || !idx
            || !src || !dst)
            return ERR_JOB;
        const bool packed = ss == width && ds == width;
        long prev = -1;
        for (long i = 0; i < rows;) {
            const long r = idx[i];
            if (i > 0 && r <= prev) return ERR_ORDER;
            long len = 1;
            while (packed && i + len < rows && idx[i + len] == r + len)
                ++len;
            if (r < 0 || r + len > m) return ERR_RANGE;
            const long words = len * width;
            const long s = src + 4 * ss * r, d = dst + 4 * ds * r;
            for (long at = 0; at < words; at += CHUNK_WORDS, ++n) {
                if (n >= cap) return ERR_ROOM;
                out[3 * n] = s + 4 * at;
                out[3 * n + 1] = d + 4 * at;
                out[3 * n + 2] = words - at < CHUNK_WORDS ? words - at
                                                          : CHUNK_WORDS;
            }
            prev = r + len - 1;
            i += len;
        }
    }
    return n;
}

// Plans the jobs into the pinned slot (host address slot, mapped
// address slot_mapped, cap rows), launches, and records the slot's event
// after the launch; 0, a CUDA error, or one of row_scatter_plan's
// negative codes.
extern "C" int row_scatter_launch(const ScatterJob* jobs, int njobs,
                                  long* slot, const long* slot_mapped,
                                  long cap, void* stream, void* event) {
    static int grid_max = 0;     // blocks resident on the whole card
    if (njobs < 1 || njobs > MAX_BUFS || !slot || !slot_mapped)
        return (int)cudaErrorInvalidValue;
    const long n = row_scatter_plan(jobs, njobs, slot, cap);
    if (n < 0) return (int)n;
    if (!grid_max) {
        int dev = 0, sms = 0, per = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per, row_scatter, THREADS, 0);
        if (err != cudaSuccess) return (int)err;
        grid_max = sms * (per > 0 ? per : 1);
    }
    const ScatterArgs A = {(int)n, slot_mapped};
    const long blocks = n < grid_max ? n : grid_max;
    row_scatter<<<(int)blocks, THREADS, 0, (cudaStream_t)stream>>>(A);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)cudaEventRecord((cudaEvent_t)event, (cudaStream_t)stream);
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
