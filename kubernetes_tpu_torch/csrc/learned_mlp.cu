// K9 probe: the learned score term (learned_mlp.cuh) alone, over raw
// feature rows [M, 9] -> [M].
//
// Replaces: nothing on a scheduling path. K9 runs inside K2a and K3
// (learned_mlp.cuh); this entry exists so that the device function can be
// held against its twin (kubernetes_tpu_torch/kernels/learned.py
// learned_probe_ref, over ops/learned.py learned_term) and timed alone.
// Row columns: frac_cpu, frac_mem, fit, bal, taint, aff, img, spread, ipa
// on their pipeline scales (fractions in [0, 1], scores 0-100).
//
// Work: a grid-stride loop, one row a thread, every warp's lanes
// together (K9's wide path forms a warp's rows together); each block first
// stages the narrow path's stack, or holds the wide path's warp slabs, in
// dynamic shared memory (learned_smem_floats). The grid (`blocks`) comes
// from the wrapper, which sizes the wide path's global scratch by it.
// What bounds it on an H100: bytes for the served scorers, 36 B read and
// 4 B written a row (the default 9 -> 8 -> 1 scorer does ~170 flops a
// row, a third of the fp32 rate's share at 3.35 TB/s); operations for a
// wide one.

#include <cuda_runtime.h>

#include "learned_mlp.cuh"

#define THREADS 256

// one instantiation a narrow class (HMAX 8, 16, 32; 24 runs in 32's) and
// one for the wide path (HMAX 0), so each holds only its own registers
template <int HMAX, bool WIDE>
__global__ void __launch_bounds__(THREADS)
learned_mlp_probe(LearnedNet net, const float* rows, float* out, long m) {
    extern __shared__ __align__(16) float s_k9[];
    learned_stage(net, s_k9);
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const long slot = (long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
    for (long i0 = (long)blockIdx.x * THREADS + (threadIdx.x & ~31); i0 < m;
         i0 += (long)gridDim.x * THREADS) {
        const long i = i0 + lane;
        const bool live = i < m;
        float r[LEARNED_FEATURES];
#pragma unroll
        for (int k = 0; k < LEARNED_FEATURES; ++k)
            r[k] = live ? rows[i * LEARNED_FEATURES + k] : 0.0f;
        const float v = learned_term<HMAX, WIDE>(
            net, s_k9, slot, live, r[0], r[1], r[2], r[3], r[4], r[5], r[6],
            r[7], r[8]);
        if (live) out[i] = v;
    }
}

extern "C" int learned_mlp_launch(const LearnedNet* net_in, const float* rows,
                                  float* out, long m, int blocks,
                                  void* stream) {
    LearnedNet net = *net_in;
    if (net.n_layers < 1 || !learned_net_ok(net, LEARNED_NARROW_MAX)
            || blocks < 1)
        return (int)cudaErrorInvalidValue;
    void (*kernel)(LearnedNet, const float*, float*, long) =
        net.narrow == 8    ? learned_mlp_probe<8, false>
        : net.narrow == 16 ? learned_mlp_probe<16, false>
        : net.narrow       ? learned_mlp_probe<32, false>
                           : learned_mlp_probe<0, true>;
    size_t smem =
        (size_t)learned_smem_floats(net, THREADS / 32) * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(net, rows, out, m);
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
