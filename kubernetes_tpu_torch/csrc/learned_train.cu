// K10 learned_train: the learned scorer trainer's step, the loss
// mean(w * (mlp(x) - y)^2) over a replay dataset and its gradient with
// respect to every weight and bias of the layer stack, in ONE launch.
//
// Replaces: kubernetes_tpu/learn/train.py `_fit`'s
// `jax.jit(jax.value_and_grad(loss_fn))` (:101), over ops/learned.py
// mlp_apply (:90): a jitted program with a backward pass. The twin is
// kubernetes_tpu_torch/kernels/learned.py mlp_loss_ref (plain torch
// autograd of the same loss); kernels/learned.py TrainStep prepares the
// launch, and MLPLoss (a torch.autograd.Function) binds its two modes.
//
// Any layer stack of 9 inputs, widths d1 .. dL (L <= MAX_LAYERS) and a
// scalar head whose tile fits a block's shared memory (train_smem below;
// kernels/learned.py plan_train states the limit), in the packed layout
// of kernels/learned.py LearnedParams: W0 row-major [d0, d1], b0, W1, b1,
// ...; ReLU between layers. ReLU's derivative is 1 where the
// pre-activation is > 0 and 0 elsewhere, as jax.nn.relu's.
//
// Two paths of one step, picked by the stack's shape (kernels/learned.py
// plan_train). The narrow path (k10_small, below) serves 9 -> H -> 1 with
// H <= SMALL_H, the trainer's own shape: a thread takes rows and keeps
// every parameter's sum in registers. The tiled path serves every other
// stack:
//
// Design. A block owns `tiles` consecutive tiles of T rows (T = its
// threads, 64, or 32 / 16 for a stack whose 64-row tile does not fit);
// the grid is sized so the row tiles cover the SMs (172 blocks of one
// tile at the trainer's 11,000 rows), at most BLOCKS_PER_SM blocks an SM
// that stay resident (more tiles a block beyond that). For each tile:
//  1. forward, one thread a row: each layer's pre-activations, formed in
//     chunks of CH outputs in registers over the inputs in order
//     (a0 * W0j, then + ak * Wkj, then + bj), go to the tile's
//     activation rows in SHARED memory (a unit's T values contiguous,
//     rows padded to T + 1 floats against bank conflicts); the row's
//     weighted squared error w * ((pred - y) * (pred - y)) to a loss row;
//  2. backward (gradient mode), one thread a row: d = (2 * w * (pred -
//     y)) / M at the head, then for each layer from the top the previous
//     layer's deltas (the sum over outputs in order of W[k][j] * d[j],
//     times ReLU' of the saved pre-activation) into the tile's delta rows
//     in shared memory: nothing of the forward or the backward leaves the
//     block;
//  3. per-parameter sums, one thread a parameter: thread t sums
//     parameters t, t + T, ... (and the loss, counted as parameter P)
//     over the tile's rows in four chains (row r into chain r % 4, each
//     in row order; sum4) from the activations and deltas in shared
//     memory (a_prev[k] * d[j] for a weight, d[j] for a bias), and adds
//     that to the block's running sum in shared memory.
// The block writes its P + 1 sums to its partial row. The last block of
// each group of GROUP blocks to finish (an integer ticket, as
// auction_export's) folds the group's rows in block order, and the last
// of the groups' folders folds the groups' rows in group order: one
// thread a parameter, the rows in four chains, loads that coalesce
// across the threads. No float atomics, so the result does not depend on
// scheduling and runs repeat bit for bit. The loss mode (MLPLoss's
// forward) runs step 1 and folds the loss alone.
//
// What bounds it on an H100: bytes for the default 9 -> 8 -> 1 scorer: a
// row reads 44 B (x, y, w) once and writes nothing back (the partials are
// P + 1 floats a block); ~360 flops a row forward, backward and in the
// sums, below the fp32 rate's share at 3.35 TB/s. A wide stack is bound
// by its operations. The narrow path keeps the sums in registers (252 of
// them for H = 8), so 4 blocks of 64 stay on an SM.
//
// Built with -fmad=false, like every kernel here.

#include <cuda_runtime.h>
#include <stdint.h>

#define IN_F 9             // the features a row (ops/learned.py)
#define CH 8               // outputs a thread forms at once
#define MAX_LAYERS 64      // layers of a stack
#define BLOCKS_PER_SM 16   // blocks an SM at most (plan_train)
#define GROUP 32           // blocks a group of the two-level fold
#define SMALL_H 8          // the widest hidden layer of the narrow path
#define SMALL_THREADS 64   // its block
#define SMALL_BLOCKS_PER_SM 4   // its blocks an SM at most (registers)
#define SMEM_MAX 232448    // bytes of shared memory a block can use
#define SMEM_STATIC 1296   // of it the block's Stack and its ticket flag,
                           // to the 16-byte start of the dynamic part

#define K10_REFUSED 10001  // the entry's code for arguments it refuses

// the step's modes
#define MODE_LOSS 0        // the loss alone
#define MODE_GRAD 1        // the loss and the gradient

struct TrainArgs {
    long M;                   // rows
    int L;                    // layers
    int S;                    // sum of the widths d1 .. dL (units after x)
    int P;                    // parameters (floats of the packed buffer)
    int mode;                 // MODE_LOSS or MODE_GRAD
    int threads;              // rows a tile: the block's threads
    int tiles;                // tiles a block
    int blocks;               // the grid
    int dims[MAX_LAYERS + 1]; // widths d0 = 9 .. dL = 1
    const float* params;      // [P] packed stack
    const float* x;           // [M, 9]
    const float* y;           // [M]
    const float* w;           // [M]
    const float* gscale;      // [1] the gradient's scale, or null (1)
    float* part;              // [blocks, P + 1] the blocks' sums
    float* gpart;             // [groups, P + 1] the groups' sums
    unsigned int* ticket;     // [groups + 1] blocks of each group done,
                              // then groups done; 0 between launches
    float* loss;              // [1] mean weighted squared error
    float* grad;              // [P] gradient of the loss (MODE_GRAD)
};

// a block's view of the stack: each layer's widths, the offsets of its W
// and b in the packed buffer, and the unit of its first output (units
// 0 .. 8 are x; the deltas' unit is the same less IN_F)
struct Stack {
    int din[MAX_LAYERS], dout[MAX_LAYERS], wo[MAX_LAYERS + 1],
        bo[MAX_LAYERS], ao[MAX_LAYERS];
};

static_assert((sizeof(Stack) + sizeof(int) + 15) / 16 * 16 == SMEM_STATIC,
              "SMEM_STATIC is the kernel's static shared memory");

__device__ __forceinline__ float relu(float v) { return v > 0.0f ? v : 0.0f; }

// the terms of a parameter's sum over a tile's rows: x[r] (a bias or the
// loss), a[r] * d[r] (a first-layer weight), relu(a[r]) * d[r] (a weight
// above it)
struct Plain {
    const float* x;
    __device__ float operator()(int r) const { return x[r]; }
};
struct Prod {
    const float *a, *d;
    __device__ float operator()(int r) const { return a[r] * d[r]; }
};
struct ReluProd {
    const float *a, *d;
    __device__ float operator()(int r) const { return relu(a[r]) * d[r]; }
};

struct Strided {
    const float* x;
    long step;
    __device__ float operator()(int k) const { return __ldcg(x + k * step); }
};

// the sum of f(0 .. rows - 1) in four chains (row r into chain r % 4,
// each in row order) combined as (c0 + c1) + (c2 + c3): a fixed order
// with four adds in flight
template <typename F>
__device__ __forceinline__ float sum4(F f, int rows) {
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
    int r = 0;
    for (; r + 3 < rows; r += 4) {
        c0 = c0 + f(r);
        c1 = c1 + f(r + 1);
        c2 = c2 + f(r + 2);
        c3 = c3 + f(r + 3);
    }
    if (r < rows) c0 = c0 + f(r);
    if (r + 1 < rows) c1 = c1 + f(r + 1);
    if (r + 2 < rows) c2 = c2 + f(r + 2);
    return (c0 + c1) + (c2 + c3);
}

// parameter p's sum over the tile's `rows` rows (the loss at p == P)
__device__ float tile_sum(const TrainArgs& A, const Stack& s, int p,
                          const float* act, const float* dl,
                          const float* lrow, int ld, int rows) {
    if (p == A.P) return sum4(Plain{lrow}, rows);
    int l = 0;
    while (l + 1 < A.L && p >= s.wo[l + 1]) ++l;
    const int dout = s.dout[l];
    if (p >= s.bo[l])
        return sum4(Plain{dl + (s.ao[l] - IN_F + p - s.bo[l]) * ld}, rows);
    const int q = p - s.wo[l];
    const int k = q / dout, j = q - k * dout;
    const float* d = dl + (s.ao[l] - IN_F + j) * ld;
    if (l == 0) return sum4(Prod{act + k * ld, d}, rows);
    return sum4(ReluProd{act + (s.ao[l - 1] + k) * ld, d}, rows);
}

// The fold, after the block's sums are in its partial row: the last
// block of its group of GROUP blocks folds the group's rows, and the last
// group folder the groups' (integer tickets, no float atomics): each in
// order, one thread a parameter, the rows in four chains.
__device__ void group_fold(const TrainArgs& A, int first, int np,
                           int* last) {
    const int T = blockDim.x, tid = threadIdx.x;
    const int B = gridDim.x, G = (B + GROUP - 1) / GROUP;
    const int g = blockIdx.x / GROUP;
    const int in_g = B - g * GROUP < GROUP ? B - g * GROUP : GROUP;
    const long row = A.P + 1;
    __threadfence();
    __syncthreads();
    if (tid == 0) *last = atomicAdd(A.ticket + g, 1u) == in_g - 1;
    __syncthreads();
    if (!*last) return;
    __threadfence();
    for (int p = tid; p < np; p += T)
        A.gpart[g * row + first + p] = sum4(
            Strided{A.part + (long)g * GROUP * row + first + p, row}, in_g);
    if (tid == 0) A.ticket[g] = 0u;
    __threadfence();
    __syncthreads();
    if (tid == 0) *last = atomicAdd(A.ticket + G, 1u) == G - 1;
    __syncthreads();
    if (!*last) return;
    __threadfence();
    const float scale = A.gscale != nullptr ? __ldcg(A.gscale) : 1.0f;
    for (int p = tid; p < np; p += T) {
        const int q = first + p;
        const float v = sum4(Strided{A.gpart + q, row}, G);
        if (q == A.P)
            A.loss[0] = v / (float)A.M;
        else
            A.grad[q] = A.gscale != nullptr ? v * scale : v;
    }
    if (tid == 0) A.ticket[G] = 0u;
}

// The narrow path: 9 -> H -> 1 with H <= SMALL_H, the trainer's own
// shape. One thread a row at a time, rows i, i + the grid's threads, ...;
// the row's forward, backward and every parameter's contribution in
// registers, added to the thread's own sum of each parameter (a register
// each: the stack's shape is the template's); at the end a fixed xor tree
// over each warp's lanes, warp 0's sum plus warp 1's, one partial row a
// block, and the fold. Nothing goes to shared memory but the stack and
// the warps' sums.
template <int H>
__global__ void __launch_bounds__(SMALL_THREADS)
k10_small(TrainArgs A) {
    constexpr int P = IN_F * H + H + H + 1;   // W0, b0, W1, b1
    __shared__ float w[P];
    __shared__ float red[SMALL_THREADS / 32][P + 1];
    __shared__ int last;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    for (int p = tid; p < P; p += SMALL_THREADS) w[p] = A.params[p];
    __syncthreads();
    const float* W0 = w;
    const float* b0 = w + IN_F * H;
    const float* W1 = b0 + H;
    const float b1 = W1[H];
    const bool grad = A.mode == MODE_GRAD;
    float acc[P + 1];
#pragma unroll
    for (int p = 0; p <= P; ++p) acc[p] = 0.0f;
    const long step = (long)gridDim.x * SMALL_THREADS;
    for (long i = (long)blockIdx.x * SMALL_THREADS + tid; i < A.M;
         i += step) {
        float x[IN_F], z[H];
#pragma unroll
        for (int k = 0; k < IN_F; ++k) x[k] = A.x[i * IN_F + k];
#pragma unroll
        for (int j = 0; j < H; ++j) {
            float v = x[0] * W0[j];
#pragma unroll
            for (int k = 1; k < IN_F; ++k) v = v + x[k] * W0[k * H + j];
            z[j] = v + b0[j];
        }
        float pred = relu(z[0]) * W1[0];
#pragma unroll
        for (int j = 1; j < H; ++j) pred = pred + relu(z[j]) * W1[j];
        pred = pred + b1;
        const float e = pred - A.y[i];
        const float wi = A.w[i];
        acc[P] = acc[P] + wi * (e * e);
        if (grad) {
            const float dp = ((2.0f * wi) * e) / (float)A.M;
#pragma unroll
            for (int j = 0; j < H; ++j) {
                const float d = z[j] > 0.0f ? W1[j] * dp : 0.0f;
#pragma unroll
                for (int k = 0; k < IN_F; ++k)
                    acc[k * H + j] = acc[k * H + j] + x[k] * d;
                acc[IN_F * H + j] = acc[IN_F * H + j] + d;
                acc[IN_F * H + H + j] =
                    acc[IN_F * H + H + j] + relu(z[j]) * dp;
            }
            acc[P - 1] = acc[P - 1] + dp;
        }
    }
    const int first = grad ? 0 : P;
#pragma unroll
    for (int p = 0; p <= P; ++p) {
        if (p < first) continue;
        float v = acc[p];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            v = v + __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) red[warp][p] = v;
    }
    __syncthreads();
    const int np = P + 1 - first;
    for (int p = tid; p < np; p += SMALL_THREADS) {
        float v = red[0][first + p];
#pragma unroll
        for (int q = 1; q < SMALL_THREADS / 32; ++q)
            v = v + red[q][first + p];
        A.part[blockIdx.x * (P + 1L) + first + p] = v;
    }
    group_fold(A, first, np, &last);
}

__global__ void __launch_bounds__(64)
k10_step(TrainArgs A) {
    extern __shared__ float sm[];
    __shared__ Stack s;
    __shared__ int last;
    const int T = A.threads, tid = threadIdx.x, ld = T + 1;
    if (tid == 0) {
        int p = 0, a = IN_F;
        for (int l = 0; l < A.L; ++l) {
            s.din[l] = A.dims[l];
            s.dout[l] = A.dims[l + 1];
            s.wo[l] = p;
            p += s.din[l] * s.dout[l];
            s.bo[l] = p;
            p += s.dout[l];
            s.ao[l] = a;
            a += s.dout[l];
        }
        s.wo[A.L] = p;
    }
    __syncthreads();
    float* act = sm;                          // [IN_F + S][ld]
    float* dl = act + (IN_F + A.S) * ld;      // [S][ld]
    float* lrow = dl + A.S * ld;              // [ld]
    float* accs = lrow + ld;                  // [P + 1] the block's sums
    const int first = A.mode == MODE_GRAD ? 0 : A.P;
    const int np = A.P + 1 - first;           // sums this mode folds
    const float* __restrict__ prm = A.params;
    const long row0 = (long)blockIdx.x * A.tiles * T;
    const int top = A.L - 1;
    for (int t = 0; t < A.tiles; ++t) {
        const long r0 = row0 + (long)t * T;
        if (r0 >= A.M) break;
        const int rows = A.M - r0 < T ? (int)(A.M - r0) : T;
        if (tid < rows) {
            const long i = r0 + tid;
            for (int k = 0; k < IN_F; ++k)
                act[k * ld + tid] = A.x[i * IN_F + k];
            for (int l = 0; l < A.L; ++l) {
                const float* W = prm + s.wo[l];
                const float* b = prm + s.bo[l];
                const int din = s.din[l], dout = s.dout[l];
                const int in0 = l == 0 ? 0 : s.ao[l - 1];
                for (int j0 = 0; j0 < dout; j0 += CH) {
                    float acc[CH];
                    float a0 = act[in0 * ld + tid];
                    if (l) a0 = relu(a0);
#pragma unroll
                    for (int c = 0; c < CH; ++c)
                        acc[c] = j0 + c < dout ? a0 * __ldg(W + j0 + c)
                                               : 0.0f;
                    for (int k = 1; k < din; ++k) {
                        float ak = act[(in0 + k) * ld + tid];
                        if (l) ak = relu(ak);
                        const float* wk = W + (long)k * dout;
#pragma unroll
                        for (int c = 0; c < CH; ++c)
                            if (j0 + c < dout)
                                acc[c] = acc[c] + ak * __ldg(wk + j0 + c);
                    }
#pragma unroll
                    for (int c = 0; c < CH; ++c)
                        if (j0 + c < dout)
                            act[(s.ao[l] + j0 + c) * ld + tid] =
                                acc[c] + __ldg(b + j0 + c);
                }
            }
            const float pred = act[s.ao[top] * ld + tid];
            const float e = pred - A.y[i];
            lrow[tid] = A.w[i] * (e * e);
            if (A.mode == MODE_GRAD) {
                dl[(s.ao[top] - IN_F) * ld + tid] =
                    ((2.0f * A.w[i]) * e) / (float)A.M;
                for (int l = top; l > 0; --l) {
                    const float* W = prm + s.wo[l];
                    const int din = s.din[l], dout = s.dout[l];
                    const float* d = dl + (s.ao[l] - IN_F) * ld + tid;
                    for (int k = 0; k < din; ++k) {
                        const float* wk = W + (long)k * dout;
                        float g = __ldg(wk) * d[0];
                        for (int j = 1; j < dout; ++j)
                            g = g + __ldg(wk + j) * d[j * ld];
                        const int u = s.ao[l - 1] + k;
                        dl[(u - IN_F) * ld + tid] =
                            act[u * ld + tid] > 0.0f ? g : 0.0f;
                    }
                }
            }
        }
        __syncthreads();  // the tile's activations and deltas are written
        for (int p = tid; p < np; p += T) {
            const float v = tile_sum(A, s, first + p, act, dl, lrow, ld,
                                     rows);
            accs[p] = t == 0 ? v : accs[p] + v;
        }
        __syncthreads();  // the sums have read the tile
    }
    // the block's sums to its partial row, then the fold
    for (int p = tid; p < np; p += T)
        A.part[blockIdx.x * (A.P + 1L) + first + p] = accs[p];
    group_fold(A, first, np, &last);
}

// the dynamic shared memory of a tile of `threads` rows (plan_train):
// x, the pre-activations, the deltas and the rows' losses, a unit's row
// padded to threads + 1 floats, and the block's P + 1 sums
extern "C" long train_smem(int S, int P, int threads) {
    return 4L * ((2L * S + IN_F + 1) * (threads + 1) + P + 1);
}

// the narrow path's instantiations, by H
typedef void (*SmallFn)(TrainArgs);
static const SmallFn SMALL[SMALL_H + 1] = {
    nullptr, k10_small<1>, k10_small<2>, k10_small<3>, k10_small<4>,
    k10_small<5>, k10_small<6>, k10_small<7>, k10_small<8>};

// the narrow path takes a stack 9 -> H -> 1 with H <= SMALL_H (not in the
// -DK10_TILED_ONLY measurement build, which runs every stack tiled)
static int small_h(const TrainArgs& A) {
#ifdef K10_TILED_ONLY
    (void)A;
    return 0;
#else
    return A.L == 2 && A.dims[0] == IN_F && A.dims[1] <= SMALL_H
                   && A.dims[2] == 1
               ? A.dims[1] : 0;
#endif
}

extern "C" int k10_step_launch(const TrainArgs* args, void* stream) {
    const TrainArgs& A = *args;
    if (A.M < 1 || A.L < 1 || A.L > MAX_LAYERS || A.S < 1 || A.P < 1
        || (A.mode != MODE_LOSS && A.mode != MODE_GRAD)
        || A.tiles < 1 || A.blocks < 1
        || (long)A.blocks * A.tiles * A.threads < A.M
        || (long)(A.blocks - 1) * A.threads >= A.M)
        return K10_REFUSED;
    cudaStream_t st = (cudaStream_t)stream;
    const int h = small_h(A);
    if (h) {
        // the narrow path: its rows strided by the grid's threads
        if (A.threads != SMALL_THREADS) return K10_REFUSED;
        SMALL[h]<<<A.blocks, SMALL_THREADS, 0, st>>>(A);
        return (int)cudaGetLastError();
    }
    if ((A.threads != 64 && A.threads != 32 && A.threads != 16)
        || (long)(A.blocks - 1) * A.tiles * A.threads >= A.M)
        return K10_REFUSED;
    const long smem = train_smem(A.S, A.P, A.threads);
    if (smem > SMEM_MAX - SMEM_STATIC) return K10_REFUSED;
    static long raised = 48 * 1024 - SMEM_STATIC;
    if (smem > raised) {
        const cudaError_t e = cudaFuncSetAttribute(
            k10_step, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
        raised = smem;
    }
    k10_step<<<A.blocks, A.threads, smem, st>>>(A);
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    if (code == K10_REFUSED)
        return "k10_step_launch refused its arguments (plan_train's)";
    return cudaGetErrorString((cudaError_t)code);
}
