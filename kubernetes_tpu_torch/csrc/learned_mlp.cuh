// K9 learned_term: the learned MLP score term of one (pod, node) pair, a
// device function that K2a (auction_score_argmax.cu) and K3
// (serial_scan.cu) call on every total they form.
//
// Replaces: kubernetes_tpu/ops/learned.py `feature_rows` (:74),
// `mlp_apply` (:90) and `learned_term` (:102), which the reference fuses
// into the auction's round totals (models/pipeline.py :634-636) and the
// serial scan's step total (:1466-1474). The twin is
// kubernetes_tpu_torch/ops/learned.py (learned_term).
//
// What it computes: the nine features (the two utilization fractions,
// then fit, balance, taint, node affinity, image locality, spread and ipa
// each divided by 100 -- a true division, never a multiply by 0.01), a
// ReLU MLP over them and a clip of the scalar output to [0, 100]. Each
// layer's product is summed left to right over the input index (acc =
// x0 * w0j, then acc = acc + xk * wkj, then + b_j), the twin's order; the
// sources are built with -fmad=false, so no multiply-add is contracted
// and kernel and twin agree bit for bit. ReLU and the clip are written as
// comparisons (x < 0 ? 0 : x) that pass a NaN through, as jax.nn.relu
// and jnp.clip do: fmaxf/fminf would return the other operand and hide a
// NaN checkpoint from the launch guard.
//
// Design: the caller stages the packed parameters (LearnedNet.params:
// W0 row-major [d0, d1], b0, W1, b1, ...) into shared memory once per
// block (learned_stage) and passes the shared copy here. Each thread
// keeps two activation rows of LEARNED_MAX_WIDTH floats; the layer loops
// have run-time bounds, so the rows live in the thread's local memory
// (L1). Caps: every width <= LEARNED_MAX_WIDTH, at most
// LEARNED_MAX_LAYERS layers (kernels/learned.py check_caps refuses
// a wider checkpoint at load).
//
// What bounds it on an H100: operations. A pair of the default scorer
// (9 -> 8 -> 1) costs ~170 flops (9 divisions, 80 multiplies, 80 adds)
// against 36 bytes of features, which the fused kernels already hold in
// registers; alone (the probe over [M, 9] rows) it reads 36 B and
// writes 4 B a row.

#pragma once

#include <stdint.h>

#define LEARNED_MAX_WIDTH 64
#define LEARNED_MAX_LAYERS 8
#define LEARNED_FEATURES 9

// Mirrored by kernels/learned.py:LearnedNet (same members, same order).
struct LearnedNet {
    const float* params;   // packed stack (device memory); null: no term
    int n_layers;          // 0: no learned term in this launch
    int n_params;          // floats in params
    int dims[LEARNED_MAX_LAYERS + 1];  // widths d0 = 9, ..., dL = 1
};

// a launch's host-side check of the description: no term, or 1 to
// LEARNED_MAX_LAYERS layers from 9 features to a scalar head, every width
// within the cap
inline bool learned_net_ok(const LearnedNet& net) {
    if (net.n_layers == 0) return true;
    if (net.n_layers < 0 || net.n_layers > LEARNED_MAX_LAYERS
            || net.params == nullptr || net.dims[0] != LEARNED_FEATURES
            || net.dims[net.n_layers] != 1)
        return false;
    int n = 0;
    for (int l = 0; l < net.n_layers; ++l) {
        int dout = net.dims[l + 1];
        if (dout < 1 || dout > LEARNED_MAX_WIDTH) return false;
        n += net.dims[l] * dout + dout;
    }
    return n == net.n_params;
}

// floats of shared memory the staged parameters take, rounded up to a
// multiple of 4 (16 bytes) so what follows them stays aligned
__host__ __device__ inline int learned_smem_floats(const LearnedNet& net) {
    return net.n_layers > 0 ? (net.n_params + 3) & ~3 : 0;
}

// block-cooperative copy of the parameters into shared memory; every
// thread of the block must call it, and a __syncthreads() must follow
// before the first learned_term
__device__ inline void learned_stage(const LearnedNet& net, float* s_params) {
    if (net.n_layers <= 0) return;
    for (int i = threadIdx.x; i < net.n_params; i += blockDim.x)
        s_params[i] = net.params[i];
}

__device__ inline float learned_relu(float x) { return x < 0.0f ? 0.0f : x; }

__device__ inline float learned_clip(float x) {
    return x < 0.0f ? 0.0f : (x > 100.0f ? 100.0f : x);
}

// the learned term of one pair from the pipeline's raw per-node signals
// (fractions in [0, 1], scores on their 0-100 scale); `params` is the
// block's shared copy
__device__ inline float learned_term(const float* params,
                                     const LearnedNet& net, float frac0,
                                     float frac1, float fit, float bal,
                                     float taint, float aff, float img,
                                     float spread, float ipa) {
    float xa[LEARNED_MAX_WIDTH], xb[LEARNED_MAX_WIDTH];
    float* x = xa;
    float* y = xb;
    x[0] = frac0;
    x[1] = frac1;
    x[2] = fit / 100.0f;
    x[3] = bal / 100.0f;
    x[4] = taint / 100.0f;
    x[5] = aff / 100.0f;
    x[6] = img / 100.0f;
    x[7] = spread / 100.0f;
    x[8] = ipa / 100.0f;
    const float* p = params;
    const int last = net.n_layers - 1;
    for (int l = 0; l <= last; ++l) {
        const int din = net.dims[l], dout = net.dims[l + 1];
        const float* w = p;
        const float* b = p + din * dout;
        for (int j = 0; j < dout; ++j) {
            float acc = x[0] * w[j];
            for (int k = 1; k < din; ++k) acc = acc + x[k] * w[k * dout + j];
            acc = acc + b[j];
            y[j] = l < last ? learned_relu(acc) : acc;
        }
        p = b + dout;
        float* t = x;
        x = y;
        y = t;
    }
    return learned_clip(x[0]);
}
