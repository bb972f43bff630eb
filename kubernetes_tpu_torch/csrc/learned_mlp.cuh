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
// NaN checkpoint from the launch guard. No path splits the sum of one
// output; no tensor core is used.
//
// Any width and any depth, on one of two paths (kernels/learned.py
// net_of picks it once a launch):
//
// - Narrow: every hidden layer at most LEARNED_NARROW_MAX wide and the
//   staged stack at most LEARNED_NARROW_FLOATS floats (the served
//   scorers: the default (8,), (16,), (16, 8)). The caller stages the
//   stack, each row of W padded to a multiple of 4 floats, and its widths
//   into shared memory once a block (learned_stage); each thread forms
//   its own pair's term with the activation rows in registers, reading
//   the rows four weights at a time (16-byte loads): the layer loops are
//   unrolled to the width class (8, 16, 24 or 32, the widest hidden
//   layer rounded up to a multiple of 8) and guarded by the run-time
//   widths, so every index is a constant and nothing goes to local
//   memory. A kernel instantiates the classes up to its HMAX: K2a,
//   at 64 registers a thread, stops at 16 (a wider narrow scorer takes
//   the wide path there), K3 and the probe at 32.
// - Wide: anything else. A warp forms its lanes' pairs together, up to
//   `pairs` of them at a time: a layer's output neurons are split over
//   the lanes, each lane reading its column of W straight from global
//   memory (L2; coalesced rows, each weight used for every pair in
//   flight), and the activations of the pairs in flight live in a
//   per-warp slab of 2 x pairs x widest floats: in the block's shared
//   memory where a block's slabs fit in LEARNED_SLAB_SHARED_MAX bytes,
//   else in the warp's slice of a global scratch buffer (`scratch`). The
//   parameters are not staged, so a wide stack costs the caller's
//   shared-memory plan only the slabs, and nothing caps width or depth
//   but device memory.
//
// Every lane of a warp calls learned_term together (converged), a lane
// with no pair with `live` false; the wide path exchanges through the
// slab between __syncwarp()s. Each path is a function of its own (not
// inlined), so K2a and K3 compile each path once and their registers do
// not carry K9's activations; both also have an instantiation without K9
// for the launches that carry no scorer, which pays nothing for it.
//
// What bounds it on an H100: operations. A pair of the default scorer
// (9 -> 8 -> 1) costs ~170 flops (9 divisions, 80 multiplies, 80 adds)
// against 36 bytes of features, which the fused kernels already hold in
// registers; alone (the probe over [M, 9] rows) it reads 36 B and
// writes 4 B a row. A wide scorer's pair costs 2 x its weights in flops
// (~137 K for 9 -> 256 -> 256 -> 1).

#pragma once

#include <stdint.h>

#define LEARNED_FEATURES 9
#define LEARNED_NARROW_MAX 32
#define LEARNED_NARROW_FLOATS 16384
#define LEARNED_PAIRS 8
#define LEARNED_SLAB_SHARED_MAX 65536

// Mirrored by kernels/learned.py:LearnedNet (same members, same order).
struct LearnedNet {
    const float* params;   // packed stack (device memory); null: no term
    const int* dims;       // [n_layers + 1] widths d0 = 9, ..., dL = 1
    float* scratch;        // wide path, slabs in global memory: a slab a
                           // warp of the launch; else null
    int n_layers;          // 0: no learned term in this launch
    int n_params;          // floats in params
    int narrow;            // the narrow path's width class; 0: wide path
    int n_staged;          // narrow path: floats of the staged stack
    int widest;            // widest layer (the 9 inputs too), a multiple
                           // of 4
    int pairs;             // wide path: pairs a warp carries together
    int slab_shared;       // wide path: 1 slabs in shared memory
};

__host__ __device__ inline int learned_a4(int x) { return (x + 3) & ~3; }

// a launch's host-side check of the description: no term, or a stack
// from 9 features with a known path (kernels/learned.py check_caps holds
// the widths to the buffer)
inline bool learned_net_ok(const LearnedNet& net, int hmax) {
    if (net.n_layers == 0) return true;
    if (net.n_layers < 0 || net.params == nullptr || net.dims == nullptr
            || net.n_params < LEARNED_FEATURES + 1 || net.widest < 12
            || (net.widest & 3) != 0)
        return false;
    if (net.narrow)
        return (net.narrow == 8 || net.narrow == 16 || net.narrow == 24
                || net.narrow == 32)
               && net.narrow <= hmax && net.n_staged > net.n_params
               && net.n_staged <= LEARNED_NARROW_FLOATS
               && (net.n_staged & 3) == 0;
    return net.pairs >= 1 && net.pairs <= LEARNED_PAIRS
           && (net.slab_shared || net.scratch != nullptr);
}

// floats of a wide-path warp's slab: the pairs in flight, in and out
__host__ __device__ inline int learned_slab_floats(const LearnedNet& net) {
    return 2 * net.pairs * net.widest;
}

// floats of shared memory K9 takes in a block of `warps` warps (a
// multiple of 4, so what follows stays 16-byte aligned): the staged
// stack and its widths on the narrow path, the warps' slabs on the wide
// path when they are in shared memory, else nothing
__host__ __device__ inline int learned_smem_floats(const LearnedNet& net,
                                                   int warps) {
    if (net.n_layers <= 0) return 0;
    if (net.narrow) return net.n_staged + learned_a4(net.n_layers + 1);
    return net.slab_shared ? warps * learned_slab_floats(net) : 0;
}

// block-cooperative copy of the narrow path's stack and widths into
// shared memory: each layer's W [din, a4(dout)] then its b [a4(dout)],
// the padding columns zero, every row 16-byte aligned (n_staged floats),
// then the widths; every thread of the block must call it, and a
// __syncthreads() must follow before the first learned_term
__device__ inline void learned_stage(const LearnedNet& net, float* s) {
    if (net.n_layers <= 0 || !net.narrow) return;
    const float* p = net.params;
    int o = 0, din = LEARNED_FEATURES;
    for (int l = 0; l < net.n_layers; ++l) {
        const int dout = net.dims[l + 1], dp = learned_a4(dout);
        // rows 0 .. din - 1 of W, then row din: b (it follows W)
        for (int i = threadIdx.x; i < (din + 1) * dp; i += blockDim.x) {
            const int r = i / dp, c = i - r * dp;
            s[o + i] = c < dout ? p[r * dout + c] : 0.0f;
        }
        o += (din + 1) * dp;
        p += (din + 1) * dout;
        din = dout;
    }
    int* sd = reinterpret_cast<int*>(s + net.n_staged);
    for (int i = threadIdx.x; i <= net.n_layers; i += blockDim.x)
        sd[i] = net.dims[i];
}

__device__ __forceinline__ float learned_relu(float x) {
    return x < 0.0f ? 0.0f : x;
}

__device__ __forceinline__ float learned_clip(float x) {
    return x < 0.0f ? 0.0f : (x > 100.0f ? 100.0f : x);
}

// one narrow layer: y = x W + b over the staged rows at `p` (row stride
// dp), each output summed over k in order, the rows read four columns at
// a time; inputs x[0 .. din), din <= KMAX; outputs y[0 .. dout) (the
// padding columns computed and never read)
template <int KMAX, int H>
__device__ __forceinline__ void learned_layer(const float* p, const float* x,
                                              int din, int dout, int dp,
                                              float* y, bool hidden) {
#pragma unroll
    for (int q = 0; q < H / 4; ++q) {
        if (4 * q < dout) {
            const float4 v = reinterpret_cast<const float4*>(p)[q];
            y[4 * q] = x[0] * v.x;
            y[4 * q + 1] = x[0] * v.y;
            y[4 * q + 2] = x[0] * v.z;
            y[4 * q + 3] = x[0] * v.w;
        }
    }
#pragma unroll
    for (int k = 1; k < KMAX; ++k) {
        if (k < din) {
            const float4* r = reinterpret_cast<const float4*>(p + k * dp);
#pragma unroll
            for (int q = 0; q < H / 4; ++q) {
                if (4 * q < dout) {
                    const float4 v = r[q];
                    y[4 * q] = y[4 * q] + x[k] * v.x;
                    y[4 * q + 1] = y[4 * q + 1] + x[k] * v.y;
                    y[4 * q + 2] = y[4 * q + 2] + x[k] * v.z;
                    y[4 * q + 3] = y[4 * q + 3] + x[k] * v.w;
                }
            }
        }
    }
    const float4* b = reinterpret_cast<const float4*>(p + din * dp);
#pragma unroll
    for (int q = 0; q < H / 4; ++q) {
        if (4 * q < dout) {
            const float4 v = b[q];
            const float o[4] = {y[4 * q] + v.x, y[4 * q + 1] + v.y,
                                y[4 * q + 2] + v.z, y[4 * q + 3] + v.w};
#pragma unroll
            for (int u = 0; u < 4; ++u)
                y[4 * q + u] = hidden ? learned_relu(o[u]) : o[u];
        }
    }
}

// the narrow path: one pair, activation rows of H floats in registers;
// `p` and `dims` the block's staged copies
template <int H>
__device__ __forceinline__ float learned_narrow(const float* p,
                                                const int* dims, int L,
                                                const float* f) {
    float x[H], y[H];
#pragma unroll
    for (int j = 0; j < H; ++j) y[j] = 0.0f;
    int din = dims[1], dp = learned_a4(din);
    learned_layer<LEARNED_FEATURES, H>(p, f, LEARNED_FEATURES, din, dp, y,
                                       L > 1);
    p += (LEARNED_FEATURES + 1) * dp;
    for (int l = 1; l < L; ++l) {
#pragma unroll
        for (int j = 0; j < H; ++j) x[j] = y[j];
        const int dout = dims[l + 1];
        dp = learned_a4(dout);
        learned_layer<H, H>(p, x, din, dout, dp, y, l < L - 1);
        p += (din + 1) * dp;
        din = dout;
    }
    return learned_clip(y[0]);
}

// x / 100 as a true division; a zero (of either sign) is its own
// quotient, and skips the division's slow path, which a zero dividend
// takes (many scores are 0: no image, no affinity, no spread)
__device__ __forceinline__ float learned_by100(float x) {
    return x == 0.0f ? x : x / 100.0f;
}

// the nine features from the raw signals: the fractions as they are, the
// scores divided by 100
__device__ __forceinline__ void learned_features(
        float* f, float frac0, float frac1, float fit, float bal,
        float taint, float aff, float img, float spread, float ipa) {
    f[0] = frac0;
    f[1] = frac1;
    f[2] = learned_by100(fit);
    f[3] = learned_by100(bal);
    f[4] = learned_by100(taint);
    f[5] = learned_by100(aff);
    f[6] = learned_by100(img);
    f[7] = learned_by100(spread);
    f[8] = learned_by100(ipa);
}

// the narrow path of one pair, a function of its own (not inlined: the
// caller's registers do not carry K9's activation rows, and a launch
// without K9 pays nothing for them); `p` is the block's staged stack,
// its widths `p4` floats after it
template <int HMAX>
__device__ __noinline__ float learned_narrow_fn(
        const float* p, int narrow, int L, int p4, float frac0,
        float frac1, float fit, float bal, float taint, float aff,
        float img, float spread, float ipa) {
    float f[LEARNED_FEATURES];
    learned_features(f, frac0, frac1, fit, bal, taint, aff, img, spread,
                     ipa);
    const int* dims = reinterpret_cast<const int*>(p + p4);
    if (narrow == 8 || HMAX < 16) return learned_narrow<8>(p, dims, L, f);
    if (narrow == 16 || HMAX < 24) return learned_narrow<16>(p, dims, L, f);
    if (narrow == 24 || HMAX < 32) return learned_narrow<24>(p, dims, L, f);
    return learned_narrow<32>(p, dims, L, f);
}

// the wide path: the warp's live lanes' pairs, `pairs` at a time through
// the layers; `slab` is the warp's 2 x pairs x W floats (W the widest
// layer); a function of its own, as the narrow path
__device__ __noinline__ float learned_wide_fn(
        const float* params, const int* dims, int L, int W, int pairs,
        float* slab, bool live, float frac0, float frac1, float fit,
        float bal, float taint, float aff, float img, float spread,
        float ipa) {
    const unsigned FULL_MASK = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    float f[LEARNED_FEATURES];
    learned_features(f, frac0, frac1, fit, bal, taint, aff, img, spread,
                     ipa);
    float* const xin = slab;
    float* const xout = slab + pairs * W;
    unsigned todo = __ballot_sync(FULL_MASK, live);
    float result = 0.0f;
    while (todo) {
        // the lowest `pairs` lanes still to do, in lane order
        unsigned grp = 0u, t = todo;
        for (int i = 0; i < pairs && t; ++i) {
            grp |= t & (0u - t);
            t &= t - 1u;
        }
        const int np = __popc(grp);
        const bool mine = (grp >> lane) & 1u;
        const int slot = __popc(grp & ((1u << lane) - 1u));
        if (mine) {
#pragma unroll
            for (int k = 0; k < LEARNED_FEATURES; ++k)
                xin[slot * W + k] = f[k];
        }
        __syncwarp();
        float* x = xin;
        float* y = xout;
        const float* p = params;
        int din = LEARNED_FEATURES;
        for (int l = 0; l < L; ++l) {
            const int dout = dims[l + 1];
            const float* w = p;
            const float* b = p + (long)din * dout;
            const bool hidden = l < L - 1;
            for (int j = lane; j < dout; j += 32) {
                float acc[LEARNED_PAIRS];
                const float w0 = __ldg(w + j);
#pragma unroll
                for (int q = 0; q < LEARNED_PAIRS; ++q)
                    if (q < np) acc[q] = x[q * W] * w0;
                int k = 1;
                // four rows of W in flight, then each sum in k order
                for (; k + 4 <= din; k += 4) {
                    float wk[4];
#pragma unroll
                    for (int u = 0; u < 4; ++u)
                        wk[u] = __ldg(w + (long)(k + u) * dout + j);
#pragma unroll
                    for (int q = 0; q < LEARNED_PAIRS; ++q) {
                        if (q < np) {
#pragma unroll
                            for (int u = 0; u < 4; ++u)
                                acc[q] = acc[q] + x[q * W + k + u] * wk[u];
                        }
                    }
                }
                for (; k < din; ++k) {
                    const float wk = __ldg(w + (long)k * dout + j);
#pragma unroll
                    for (int q = 0; q < LEARNED_PAIRS; ++q)
                        if (q < np) acc[q] = acc[q] + x[q * W + k] * wk;
                }
                const float bj = __ldg(b + j);
#pragma unroll
                for (int q = 0; q < LEARNED_PAIRS; ++q) {
                    if (q < np) {
                        const float v = acc[q] + bj;
                        y[q * W + j] = hidden ? learned_relu(v) : v;
                    }
                }
            }
            __syncwarp();
            p = b + dout;
            din = dout;
            float* nx = x;
            x = y;
            y = nx;
        }
        if (mine) result = learned_clip(x[slot * W]);
        __syncwarp();  // read before the next pairs overwrite the slab
        todo &= ~grp;
    }
    return result;
}

// the learned term of one pair from the pipeline's raw per-node signals
// (fractions in [0, 1], scores on their 0-100 scale). Every lane of the
// warp calls it together; `live` false: no pair, the result 0. `smem` is
// the block's K9 region (learned_smem_floats), `warp_slot` the warp's
// index among the launch's warps (its slab in net.scratch); HMAX the
// kernel's largest narrow class (learned_net_ok holds net.narrow to it; 0:
// no narrow path), WIDE false: no wide path (a kernel instantiated for one
// narrow class).
template <int HMAX, bool WIDE = true>
__device__ __forceinline__ float learned_term(const LearnedNet& net,
                                             float* smem, long warp_slot,
                                             bool live, float frac0,
                                             float frac1, float fit,
                                             float bal, float taint,
                                             float aff, float img,
                                             float spread, float ipa) {
    if constexpr (HMAX > 0) {
        if (net.narrow) {
            if (!live) return 0.0f;
            return learned_narrow_fn<HMAX>(
                smem, net.narrow, net.n_layers, net.n_staged, frac0, frac1,
                fit, bal, taint, aff, img, spread, ipa);
        }
    }
    if constexpr (!WIDE) {
        return 0.0f;
    } else {
        const int slab_n = learned_slab_floats(net);
        float* slab = net.slab_shared
                          ? smem + (threadIdx.x >> 5) * slab_n
                          : net.scratch + warp_slot * slab_n;
        return learned_wide_fn(net.params, net.dims, net.n_layers,
                               net.widest, net.pairs, slab, live, frac0,
                               frac1, fit, bal, taint, aff, img, spread,
                               ipa);
    }
}
