// K7b gang_capacity: the host-fallback PreFilter's member-capacity bound,
// a [N, R] f32 x [R] f32 -> scalar i32 reduction.
//
// Replaces: kubernetes_tpu/ops/gang.py `_capacity` (:208), reached through
// `gang_capacity_device` (:222). The twin is
// kubernetes_tpu_torch/ops/gang.py:capacity (through
// kernels/gang.py:capacity_ref).
//
// A row's bound is the min over the request's active columns of
// floor(max(free, 0) / req), 2^30 for an inactive column, clipped to
// [0, 2^30]; the result is the rows' sum rounded to f32 once, 2^30 when no
// column is active, converted as XLA does (NaN -> 0, saturating).
//
// Design:
// - the request travels by value in the launch's argument block (at most
//   CAP_R_MAX columns): a call copies nothing to the card; each CTA stages
//   the row in shared memory, and whether any column is active comes with
//   that barrier (__syncthreads_or), at no cost to the host;
// - one thread a row (`free` may be a row-strided view: the mirror's
//   device-resident cluster blob, read in place), a thread's column loads
//   issued together;
// - a row's bound is an integer below 2^30 (or NaN), so partial sums are
//   exact u64 integers with a NaN flag, in any order: a CTA folds its
//   warps, and where the plan takes more than one CTA (N past CAP_ROWS a
//   CTA) each writes its partial and takes an integer ticket; the last
//   one folds the partials (integers: every order gives the same sum) and
//   writes the result, then resets the ticket for the next launch. No
//   float atomics: card and twin agree exactly, run after run. The scalar stays on the card: the
//   caller folds its copy into the cycle's verdict pull.
//
// What bounds it on an H100: launch latency. N = 8,192 rows of R = 8
// columns are 256 KB of reads (0.08 µs at 3.35 TB/s); at the Permit
// path's 512-node bucket one CTA of 512 threads takes one row each.

#include <cuda_runtime.h>
#include <stdint.h>

#define CAP_THREADS 512
#define CAP_ROWS CAP_THREADS
#define CAP_R_MAX 128
#define CAP_LIMIT 1073741824.0f

// Mirrored by kernels/gang.py:_CapArgs (same members, same order).
struct CapArgs {
    int N, R, free_stride;
    int ctas;                  // the plan: ceil(N / CAP_ROWS)
    const float* free;         // [N, R], row stride free_stride
    int* out;                  // []
    void* partials;            // [ctas] u64, then [ctas] u32 NaN flags and
                               // the u32 ticket (ctas > 1 only)
    float req[CAP_R_MAX];      // the request, R used
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

// the exact sum (or NaN) as the twin's f32 total, converted
__device__ __forceinline__ int cap_result(unsigned long long sum, bool nan,
                                          bool any_active) {
    float tot = nan ? __int_as_float(0x7fc00000)
                    : (float)(double)sum;
    return f2i(any_active ? tot : CAP_LIMIT);
}

__global__ void __launch_bounds__(CAP_THREADS)
gang_capacity(const __grid_constant__ CapArgs A) {
    __shared__ float s_req[CAP_R_MAX];
    __shared__ unsigned long long s_sum[CAP_THREADS / 32];
    __shared__ unsigned s_nan[CAP_THREADS / 32];
    __shared__ bool s_last;
    const int tid = threadIdx.x;
    float q0 = tid < A.R ? A.req[tid] : 0.0f;      // R <= CAP_THREADS
    if (tid < A.R) s_req[tid] = q0;
    const bool any_active = __syncthreads_or(q0 > 0.0f);

    unsigned long long v = 0;
    bool nan = false;
    const int n = blockIdx.x * CAP_ROWS + tid;
    if (n < A.N) {
        const float* fr = A.free + (long)n * A.free_stride;
        float pn = CAP_LIMIT;
        for (int r = 0; r < A.R; ++r) {
            float q = s_req[r];
            float pc = CAP_LIMIT;
            if (q > 0.0f) {
                float f = fr[r];
                f = (f != f) ? f : (f > 0.0f ? f : 0.0f);
                pc = floorf(f / q);
            }
            pn = (r == 0) ? pc : min_nan(pn, pc);
        }
        pn = clip_nan(pn, 0.0f, CAP_LIMIT);
        nan = pn != pn;
        v = nan ? 0ull : (unsigned long long)pn;
    }
    const unsigned FULL = 0xffffffffu;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
    nan = __any_sync(FULL, nan);
    if ((tid & 31) == 0) {
        s_sum[tid >> 5] = v;
        s_nan[tid >> 5] = nan;
    }
    __syncthreads();
    if (tid >= 32) return;
    const int warps = CAP_THREADS / 32;
    v = tid < warps ? s_sum[tid] : 0ull;
    nan = tid < warps ? s_nan[tid] != 0 : false;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
    nan = __any_sync(FULL, nan);
    if (A.ctas == 1) {
        if (tid == 0) *A.out = cap_result(v, nan, any_active);
        return;
    }
    unsigned long long* part = (unsigned long long*)A.partials;
    unsigned* flags = (unsigned*)(part + A.ctas);
    unsigned* ticket = flags + A.ctas;
    if (tid == 0) {
        part[blockIdx.x] = v;
        flags[blockIdx.x] = nan;
        __threadfence();
        s_last = atomicAdd(ticket, 1u) == (unsigned)A.ctas - 1u;
    }
    __syncwarp();
    if (!s_last) return;
    __threadfence();
    // the last CTA: every partial
    v = 0;
    nan = false;
    for (int b = tid; b < A.ctas; b += 32) {
        v += ((volatile unsigned long long*)part)[b];
        nan |= ((volatile unsigned*)flags)[b] != 0;
    }
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
    nan = __any_sync(FULL, nan);
    if (tid == 0) {
        *A.out = cap_result(v, nan, any_active);
        *ticket = 0u;
    }
}

// the plan: CTAs for N rows
extern "C" int gang_capacity_ctas(int N) {
    return N < 1 ? 0 : (N + CAP_ROWS - 1) / CAP_ROWS;
}

extern "C" int gang_capacity_launch(const CapArgs* args, void* stream) {
    const CapArgs& A = *args;
    if (A.N < 1 || A.R < 1 || A.R > CAP_R_MAX || A.free_stride < A.R
            || A.ctas != gang_capacity_ctas(A.N)
            || (A.ctas > 1 && A.partials == nullptr))
        return (int)cudaErrorInvalidValue;
    gang_capacity<<<A.ctas, CAP_THREADS, 0, (cudaStream_t)stream>>>(A);
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
