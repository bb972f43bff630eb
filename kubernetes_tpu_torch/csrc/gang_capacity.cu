// K7b gang_capacity: the host-fallback PreFilter's member-capacity bound,
// a [N, R] f32 x [R] f32 -> scalar i32 reduction.
//
// Replaces: kubernetes_tpu/ops/gang.py `_capacity` (:208), reached through
// `gang_capacity_device` (:222). The twin is
// kubernetes_tpu_torch/ops/gang.py:capacity (through
// kernels/gang.py:capacity_ref).
//
// One block of THREADS threads strides over the node rows of `free`,
// which may be a row-strided view (the mirror's device-resident cluster
// blob, read in place). A row's bound is the min over the request's
// active columns of floor(max(free, 0) / req), 2^30 for an inactive
// column, clipped to [0, 2^30]; the rows' bounds are integers below 2^30
// (or NaN), so their double sum is exact in any order, and thread 0
// rounds it to f32 once, takes 2^30 when no column is active, and
// converts as XLA does (NaN -> 0, saturating). Card and twin agree
// exactly. The scalar stays on the card: the caller folds its copy into
// the cycle's verdict pull.
//
// What bounds it on an H100: launch latency. N = 8,192 rows of R = 8
// columns are 256 KB of reads; one block at L2 speed takes microseconds.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 1024
#define NWARPS (THREADS / 32)
#define CAP_LIMIT 1073741824.0f

// Mirrored by kernels/gang.py:_CapArgs (same members, same order).
struct CapArgs {
    int N, R, free_stride;
    const float* free;      // [N, R], row stride free_stride
    const float* req;       // [R]
    int* out;               // []
};

__device__ __forceinline__ float min_nan(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return b < a ? b : a;
}

__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
    if (x != x) return x;
    return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int f2i(float x) {
    if (x != x) return 0;
    if (x >= 2147483648.0f) return 2147483647;
    if (x <= -2147483648.0f) return (int)0x80000000;
    return (int)x;
}

__global__ void __launch_bounds__(THREADS) gang_capacity(CapArgs A) {
    __shared__ double s_warp[NWARPS];
    const int tid = threadIdx.x;
    bool any_active = false;
    for (int r = 0; r < A.R; ++r) any_active |= A.req[r] > 0.0f;
    double local = 0.0;
    for (int n = tid; n < A.N; n += THREADS) {
        const float* fr = A.free + (long)n * A.free_stride;
        float pn = CAP_LIMIT;
        for (int r = 0; r < A.R; ++r) {
            float q = A.req[r];
            float pc = CAP_LIMIT;
            if (q > 0.0f) {
                float f = fr[r];
                f = (f != f) ? f : (f > 0.0f ? f : 0.0f);
                pc = floorf(f / q);
            }
            pn = (r == 0) ? pc : min_nan(pn, pc);
        }
        local += (double)clip_nan(pn, 0.0f, CAP_LIMIT);
    }
    const unsigned FULL = 0xffffffffu;
    for (int o = 16; o > 0; o >>= 1) local += __shfl_down_sync(FULL, local, o);
    if ((tid & 31) == 0) s_warp[tid >> 5] = local;
    __syncthreads();
    if (tid < 32) {
        double w = s_warp[tid];
        for (int o = 16; o > 0; o >>= 1) w += __shfl_down_sync(FULL, w, o);
        if (tid == 0) {
            float tot = any_active ? (float)w : CAP_LIMIT;
            *A.out = f2i(tot);
        }
    }
}

extern "C" int gang_capacity_launch(const CapArgs* args, void* stream) {
    CapArgs A = *args;
    if (A.N < 1 || A.R < 1 || A.free_stride < A.R)
        return (int)cudaErrorInvalidValue;
    gang_capacity<<<1, THREADS, 0, (cudaStream_t)stream>>>(A);
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
