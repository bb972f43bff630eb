// K10 learned_train: the learned scorer trainer's step, the loss
// mean(w * (mlp(x) - y)^2) over a replay dataset and its gradient with
// respect to every weight and bias of the layer stack.
//
// Replaces: kubernetes_tpu/learn/train.py `_fit`'s
// `jax.jit(jax.value_and_grad(loss_fn))` (:101), over ops/learned.py
// mlp_apply (:90): a jitted program with a backward pass. The twin is
// kubernetes_tpu_torch/kernels/learned.py mlp_loss_ref (plain torch
// autograd of the same loss); MLPLoss (a torch.autograd.Function) binds
// the two entries below.
//
// Any layer stack K9 serves (9 inputs, any widths and depth, a scalar
// head), in the packed layout of kernels/learned.py LearnedParams: W0
// row-major [d0, d1], b0, W1, b1, ...; ReLU between layers. ReLU's
// derivative is 1 where the pre-activation is > 0 and 0 elsewhere, as
// jax.nn.relu's.
//
// Forward (k10_forward): one thread a row. Each layer's pre-activations
// are formed in chunks of 8 outputs held in registers, over the inputs in
// order (acc = a0 * W0j, then + ak * Wkj, then + bj), and SAVED to `z`
// [S, M] (S = the widths after the input, a unit's rows contiguous, so a
// warp's loads and stores coalesce); a hidden layer's inputs are read
// back from there through ReLU. The row's weighted squared error
// w * ((pred - y) * (pred - y)) is reduced over the block in a fixed
// halving tree (shared memory) to one partial a block.
//
// Backward (k10_backward): the block's rows first backpropagate one a
// thread: d = (2 * w * (pred - y)) / M at the head, then for each layer
// from the top the previous layer's deltas (sum over the outputs in
// order of W[k][j] * delta[j], times ReLU' of the saved z) into `dz`
// [S, M]. Then each thread takes parameters tid, tid + T, ... and sums
// its parameter's contributions over the block's rows in row order
// (a_prev[k] * delta[j] for a weight, delta[j] for a bias) into one
// partial a block. k10_fold then sums the loss partials and each
// parameter's partials over the blocks in block order: no float atomics,
// so the result does not depend on scheduling, and runs repeat bit for
// bit.
//
// What bounds it on an H100: for the default 9 -> 8 -> 1 scorer, bytes:
// a row reads 44 B (x, y, w) and the saved 36 B of z back, and writes
// 36 B of z and 36 B of dz, ~170 flops forward and ~350 backward, below
// the fp32 rate's share at 3.35 TB/s; a wide stack is bound by its
// operations.
//
// Built with -fmad=false, like every kernel here.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define IN_F 9          // the features a row (ops/learned.py)
#define CH 8            // outputs a thread forms at once
#define MAX_LAYERS 64   // widths read into shared memory (dims)

struct TrainArgs {
    long M;                  // rows
    int L;                   // layers
    int S;                   // sum of the widths d1 .. dL (units after x)
    int P;                   // parameters (floats of the packed buffer)
    const float* params;     // [P] packed stack
    const int* dims;         // [L + 1] widths d0 = 9 .. dL = 1
    const float* x;          // [M, 9]
    const float* y;          // [M]
    const float* w;          // [M]
    float* z;                // [S, M] saved pre-activations
    float* dz;               // [S, M] deltas (backward)
    float* loss_part;        // [blocks] forward partials
    float* grad_part;        // [blocks, P] backward partials
    float* loss;             // [1] mean weighted squared error
    float* grad;             // [P] gradient of the loss
};

// a block's view of the stack: each layer's widths, the offsets of its W
// and b in the packed buffer and of its units in z / dz
struct Stack {
    int din[MAX_LAYERS], dout[MAX_LAYERS], wo[MAX_LAYERS], bo[MAX_LAYERS],
        zo[MAX_LAYERS];
};

__device__ void load_stack(const TrainArgs& A, Stack* s) {
    if (threadIdx.x == 0) {
        int p = 0, zo = 0;
        for (int l = 0; l < A.L; ++l) {
            s->din[l] = A.dims[l];
            s->dout[l] = A.dims[l + 1];
            s->wo[l] = p;
            p += s->din[l] * s->dout[l];
            s->bo[l] = p;
            p += s->dout[l];
            s->zo[l] = zo;
            zo += s->dout[l];
        }
    }
    __syncthreads();
}

// input k of layer l for row i: the feature (l = 0) or the previous
// layer's ReLU output read back from the saved pre-activations
__device__ __forceinline__ float act_in(const TrainArgs& A, const Stack& s,
                                        int l, int k, long i) {
    if (l == 0) return A.x[i * IN_F + k];
    const float v = A.z[(long)(s.zo[l - 1] + k) * A.M + i];
    return v > 0.0f ? v : 0.0f;
}

// fixed halving tree over the block's THREADS values in sh; thread 0
// returns the sum
__device__ float block_sum(float v, float* sh) {
    sh[threadIdx.x] = v;
    __syncthreads();
    for (int h = THREADS / 2; h > 0; h >>= 1) {
        if ((int)threadIdx.x < h) sh[threadIdx.x] = sh[threadIdx.x]
                                                    + sh[threadIdx.x + h];
        __syncthreads();
    }
    return sh[0];
}

__global__ void __launch_bounds__(THREADS)
k10_forward(TrainArgs A) {
    __shared__ Stack s;
    __shared__ float sh[THREADS];
    load_stack(A, &s);
    const long i = (long)blockIdx.x * THREADS + threadIdx.x;
    float li = 0.0f;
    if (i < A.M) {
        for (int l = 0; l < A.L; ++l) {
            const float* W = A.params + s.wo[l];
            const float* b = A.params + s.bo[l];
            const int din = s.din[l], dout = s.dout[l];
            for (int j0 = 0; j0 < dout; j0 += CH) {
                float acc[CH];
                const float a0 = act_in(A, s, l, 0, i);
#pragma unroll
                for (int c = 0; c < CH; ++c)
                    acc[c] = j0 + c < dout ? a0 * W[j0 + c] : 0.0f;
                for (int k = 1; k < din; ++k) {
                    const float ak = act_in(A, s, l, k, i);
                    const float* wk = W + (long)k * dout;
#pragma unroll
                    for (int c = 0; c < CH; ++c)
                        if (j0 + c < dout) acc[c] = acc[c] + ak * wk[j0 + c];
                }
#pragma unroll
                for (int c = 0; c < CH; ++c)
                    if (j0 + c < dout)
                        A.z[(long)(s.zo[l] + j0 + c) * A.M + i] =
                            acc[c] + b[j0 + c];
            }
        }
        const float pred = A.z[(long)s.zo[A.L - 1] * A.M + i];
        const float e = pred - A.y[i];
        li = A.w[i] * (e * e);
    }
    const float t = block_sum(li, sh);
    if (threadIdx.x == 0) A.loss_part[blockIdx.x] = t;
}

__global__ void __launch_bounds__(THREADS)
k10_backward(TrainArgs A) {
    __shared__ Stack s;
    load_stack(A, &s);
    const long r0 = (long)blockIdx.x * THREADS;
    const long i = r0 + threadIdx.x;
    if (i < A.M) {
        const int top = A.L - 1;
        const float pred = A.z[(long)s.zo[top] * A.M + i];
        A.dz[(long)s.zo[top] * A.M + i] =
            ((2.0f * A.w[i]) * (pred - A.y[i])) / (float)A.M;
        for (int l = top; l > 0; --l) {
            const float* W = A.params + s.wo[l];
            const int din = s.din[l], dout = s.dout[l];
            for (int k = 0; k < din; ++k) {
                const float* wk = W + (long)k * dout;
                float g = wk[0] * A.dz[(long)s.zo[l] * A.M + i];
                for (int j = 1; j < dout; ++j)
                    g = g + wk[j] * A.dz[(long)(s.zo[l] + j) * A.M + i];
                const float zk = A.z[(long)(s.zo[l - 1] + k) * A.M + i];
                A.dz[(long)(s.zo[l - 1] + k) * A.M + i] =
                    zk > 0.0f ? g : 0.0f;
            }
        }
    }
    __syncthreads();  // the block's rows' deltas are written
    const long rows = A.M - r0 < THREADS ? A.M - r0 : THREADS;
    for (int p = threadIdx.x; p < A.P; p += THREADS) {
        int l = 0;
        while (l + 1 < A.L && p >= s.wo[l + 1]) ++l;
        float acc = 0.0f;
        if (p < s.bo[l]) {
            const int q = p - s.wo[l];
            const int k = q / s.dout[l], j = q - k * s.dout[l];
            const float* dj = A.dz + (long)(s.zo[l] + j) * A.M;
            for (long r = 0; r < rows; ++r)
                acc = acc + act_in(A, s, l, k, r0 + r) * dj[r0 + r];
        } else {
            const float* dj = A.dz + (long)(s.zo[l] + p - s.bo[l]) * A.M;
            for (long r = 0; r < rows; ++r) acc = acc + dj[r0 + r];
        }
        A.grad_part[(long)blockIdx.x * A.P + p] = acc;
    }
}

// the loss (blocks' partials, block order, over M) when `grads` is 0;
// each parameter's gradient (its blocks' partials in block order) else
__global__ void k10_fold(TrainArgs A, int blocks, int grads) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (!grads) {
        if (t == 0) {
            float acc = 0.0f;
            for (int b = 0; b < blocks; ++b) acc = acc + A.loss_part[b];
            A.loss[0] = acc / (float)A.M;
        }
        return;
    }
    if (t >= A.P) return;
    float acc = 0.0f;
    for (int b = 0; b < blocks; ++b)
        acc = acc + A.grad_part[(long)b * A.P + t];
    A.grad[t] = acc;
}

static int check_args(const TrainArgs& A) {
    return A.M >= 1 && A.L >= 1 && A.L <= MAX_LAYERS && A.S >= 1
           && A.P >= 1;
}

extern "C" int k10_blocks(long m) { return (int)((m + THREADS - 1) / THREADS); }

extern "C" int k10_forward_launch(const TrainArgs* args, void* stream) {
    TrainArgs A = *args;
    if (!check_args(A)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int blocks = k10_blocks(A.M);
    k10_forward<<<blocks, THREADS, 0, st>>>(A);
    k10_fold<<<1, 32, 0, st>>>(A, blocks, 0);
    return (int)cudaGetLastError();
}

extern "C" int k10_backward_launch(const TrainArgs* args, void* stream) {
    TrainArgs A = *args;
    if (!check_args(A)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int blocks = k10_blocks(A.M);
    k10_backward<<<blocks, THREADS, 0, st>>>(A);
    k10_fold<<<(A.P + THREADS - 1) / THREADS, THREADS, 0, st>>>(A, blocks,
                                                                1);
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
