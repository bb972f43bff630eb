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
// Work: a grid-stride loop, one row a thread; each block first stages the
// parameters into shared memory (dynamic, learned_smem_floats floats).
// What bounds it on an H100: bytes, 36 B read and 4 B written a row (the
// default 9 -> 8 -> 1 scorer does ~170 flops a row, a third of the
// fp32 rate's share at 3.35 TB/s).

#include <cuda_runtime.h>

#include "learned_mlp.cuh"

#define THREADS 256

__global__ void learned_mlp_probe(LearnedNet net, const float* rows,
                                  float* out, long m) {
    extern __shared__ __align__(16) float s_params[];
    learned_stage(net, s_params);
    __syncthreads();
    for (long i = (long)blockIdx.x * THREADS + threadIdx.x; i < m;
         i += (long)gridDim.x * THREADS) {
        const float* r = rows + i * LEARNED_FEATURES;
        out[i] = learned_term(s_params, net, r[0], r[1], r[2], r[3], r[4],
                              r[5], r[6], r[7], r[8]);
    }
}

extern "C" int learned_mlp_launch(const LearnedNet* net_in, const float* rows,
                                  float* out, long m, void* stream) {
    LearnedNet net = *net_in;
    if (net.n_layers < 1 || !learned_net_ok(net))
        return (int)cudaErrorInvalidValue;
    size_t smem = (size_t)learned_smem_floats(net) * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        learned_mlp_probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    long want = (m + THREADS - 1) / THREADS;
    long most = (long)sms * 16;
    int blocks = (int)(want < most ? (want < 1 ? 1 : want) : most);
    learned_mlp_probe<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        net, rows, out, m);
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
