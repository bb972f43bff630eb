// K2a auction_score_argmax: one auction round's bid for every unplaced pod.
//
// Replaces: the scoring half of kubernetes_tpu/models/pipeline.py
// `_rounds_commit` (:535) round `body` (:649): eff_all/fit_all, the
// per-pod totals (ops/scores.py utilization_fractions :34,
// fit_score_from_fractions :68, balanced_allocation_from_fractions :81,
// normalize_inverse :166, normalize_max :159), `tie_perturb` (:296) and
// ops/common.py masked_argmax_random; plus, in final mode, the end-state
// feasible and fit-reject counts (:725-740). The twins are
// kubernetes_tpu_torch/kernels/auction.py:auction_score_argmax_ref and
// auction_final_ref.
//
// Work: one block per pod row b, looping over the N nodes. Pass 1 tests
// fit against the pod's effective free row (nominated reservations
// subtracted, its own nomination handed back) and takes the masked
// maxima of the raw taint and affinity scores; pass 2 forms the weighted
// total and reduces (total high, tie_perturb high, node index low) —
// jnp.argmax returns the first maximum. Placed and padding pods exit at
// once (their feasible set is empty), so rounds after the first cost
// only the pods still bidding.
//
// What bounds it on an H100: bytes, from L2. Each bidding pod reads the
// node state (free and nominated reservations, R floats each, nzr and
// allocatable 2 each) and its group's phase-1 rows (1 byte + 3 floats) for
// every node: ~80 B a pair, 2.7 GB for a full first round at B = 4096,
// N = 8192, which L2 serves (the node state is ~0.6 MB). The phase-1 rows
// are read as [G, N] through `gid` instead of gathered to [B, N] first,
// which saves writing and re-reading ~13 B a pair. The arithmetic is
// ~40 flops a pair, well under the fp32 rate.
//
// Built with -fmad=false: the totals round exactly as the twin's (and
// the reference's) separate multiplies and adds, so placements can be
// compared bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256
#define MAX_R 32
#define MAX_SHAPE 16
#define FIT_LEAST 0
#define FIT_MOST 1
#define FIT_RTCR 2

struct AuctionArgs {
    int N, B, R, G;
    const float* free;      // [N, R]  round-start chain state
    const float* nom;       // [N, R]  nominated reservations
    const float* alloc2;    // [N, 2]  cpu / memory allocatable
    const float* nzr;       // [N, 2]  non-zero requested
    const float* req;       // [B, R]
    const float* nzreq;     // [B, 2]
    const int* nominated_row;  // [B]
    const int* uid;         // [B]
    const int* gid;         // [B]
    const uint8_t* static_ok;  // [G, N]
    const float* taint_raw;    // [G, N]
    const float* aff_raw;      // [G, N]
    const float* img;          // [G, N]
    const int* placed;      // [B]
    float w_taint, w_aff, w_fit, w_bal, w_img;
    int fit_strategy;
    int shape_n;
    float shape_x[MAX_SHAPE], shape_y[MAX_SHAPE];
    unsigned int seed;
    const int* prog_in;
    int* prog_out;
    int* choice;            // [B]
    float* win_now;         // [B]
    int* feas_count;        // [B] final mode
    int* fit_rejects;       // [B] final mode
};

__device__ __forceinline__ bool fits(const AuctionArgs& A, int b, int n) {
    const float* rq = A.req + (size_t)b * A.R;
    const float* fr = A.free + (size_t)n * A.R;
    const float* nm = A.nom + (size_t)n * A.R;
    bool own = A.nominated_row[b] == n;
    for (int r = 0; r < A.R; ++r) {
        float eff = (fr[r] - nm[r]) + (own ? rq[r] : 0.0f);
        if (!(rq[r] <= eff)) return false;
    }
    return true;
}

// jnp.interp with constant extrapolation, same operations
__device__ float interp(const AuctionArgs& A, float x) {
    int k = A.shape_n;
    int i = 0;
    while (i < k && A.shape_x[i] <= x) ++i;  // searchsorted side='right'
    i = i < 1 ? 1 : (i > k - 1 ? k - 1 : i);
    float df = A.shape_y[i] - A.shape_y[i - 1];
    float dx = A.shape_x[i] - A.shape_x[i - 1];
    float delta = x - A.shape_x[i - 1];
    bool dx0 = fabsf(dx) <= 1.4210855e-14f;  // np.spacing(eps(float32))
    float f = dx0 ? A.shape_y[i - 1]
                  : A.shape_y[i - 1] + (delta / dx) * df;
    if (x < A.shape_x[0]) f = A.shape_y[0];
    if (x > A.shape_x[k - 1]) f = A.shape_y[k - 1];
    return f;
}

__device__ __forceinline__ float frac_of(float req, float a) {
    float f = a > 0.0f ? req / fmaxf(a, 1e-9f) : 1.0f;
    return fminf(fmaxf(f, 0.0f), 1.0f);
}

// weighted total of one (pod, node) pair, in the reference's order
__device__ float total_at(const AuctionArgs& A, int b, int g, int n,
                          float top_t, float scale_a) {
    float a0 = A.alloc2[2 * n], a1 = A.alloc2[2 * n + 1];
    float f0 = frac_of(A.nzr[2 * n] + A.nzreq[2 * b], a0);
    float f1 = frac_of(A.nzr[2 * n + 1] + A.nzreq[2 * b + 1], a1);
    float fit;
    if (A.fit_strategy == FIT_MOST) {
        fit = ((f0 + f1) / 2.0f) * 100.0f;
    } else if (A.fit_strategy == FIT_RTCR) {
        fit = (interp(A, f0) + interp(A, f1)) / 2.0f;
    } else {
        fit = (((1.0f - f0) + (1.0f - f1)) / 2.0f) * 100.0f;
    }
    float mean = (f0 + f1) / 2.0f;
    float d0 = f0 - mean, d1 = f1 - mean;
    float bal = (1.0f - sqrtf((d0 * d0 + d1 * d1) / 2.0f)) * 100.0f;
    size_t o = (size_t)g * A.N + n;
    float taint = (1.0f - A.taint_raw[o] / top_t) * 100.0f;
    float aff = A.aff_raw[o] * scale_a;
    float t = A.w_taint * taint;
    t = t + A.w_aff * aff;
    t = t + A.w_fit * fit;
    t = t + A.w_bal * bal;
    t = t + A.w_img * A.img[o];
    return t;
}

// pipeline.tie_perturb in native uint32
__device__ __forceinline__ float tie_perturb(unsigned int uid, int n,
                                             unsigned int seed) {
    unsigned int x = (unsigned int)n * 2654435761u;
    x = x ^ (uid * 40503u);
    x = x ^ (seed * 2654435761u);
    x = (x ^ (x >> 15)) * 2246822519u;
    x = x ^ (x >> 13);
    return (float)(x >> 8) / 16777216.0f;
}

__device__ __forceinline__ bool better(float s, float p, int i, float bs,
                                       float bp, int bi) {
    if (s != bs) return s > bs;
    if (p != bp) return p > bp;
    return i < bi;
}

__global__ void auction_bid(AuctionArgs A) {
    __shared__ float s_t[THREADS], s_a[THREADS], s_p[THREADS];
    __shared__ int s_i[THREADS], s_nan[THREADS];
    int b = blockIdx.x, tid = threadIdx.x;
    if (*A.prog_in == 0) {
        // the previous round converged: this round is a no-op
        if (b == 0 && tid == 0) *A.prog_out = 0;
        return;
    }
    if (b == 0 && tid == 0) *A.prog_out = 0;
    if (A.placed[b] >= 0) {
        if (tid == 0) A.choice[b] = -1;
        return;
    }
    int g = A.gid[b];
    const uint8_t* ok = A.static_ok + (size_t)g * A.N;
    // pass 1: masked maxima of the raw taint / affinity scores
    float mt = -INFINITY, ma = -INFINITY;
    for (int n = tid; n < A.N; n += THREADS) {
        if (!ok[n] || !fits(A, b, n)) continue;
        size_t o = (size_t)g * A.N + n;
        mt = fmaxf(mt, A.taint_raw[o]);
        ma = fmaxf(ma, A.aff_raw[o]);
    }
    s_t[tid] = mt;
    s_a[tid] = ma;
    __syncthreads();
    for (int w = THREADS / 2; w > 0; w >>= 1) {
        if (tid < w) {
            s_t[tid] = fmaxf(s_t[tid], s_t[tid + w]);
            s_a[tid] = fmaxf(s_a[tid], s_a[tid + w]);
        }
        __syncthreads();
    }
    float tt = s_t[0], ta = s_a[0];
    __syncthreads();
    float top_t = (isfinite(tt) && tt > 0.0f) ? tt : 1.0f;
    float top_a = (isfinite(ta) && ta > 0.0f) ? ta : 1.0f;
    float scale_a = 100.0f / top_a;
    // pass 2: weighted totals and the tie-broken argmax
    unsigned int u = (unsigned int)A.uid[b];
    float bs = -INFINITY, bp = -1.0f;
    int bi = 0x7fffffff, has_nan = 0;
    for (int n = tid; n < A.N; n += THREADS) {
        if (!ok[n] || !fits(A, b, n)) continue;
        float s = total_at(A, b, g, n, top_t, scale_a);
        if (isnan(s)) {
            has_nan = 1;
            continue;
        }
        float p = tie_perturb(u, n, A.seed);
        if (bi == 0x7fffffff || better(s, p, n, bs, bp, bi)) {
            bs = s;
            bp = p;
            bi = n;
        }
    }
    s_t[tid] = bs;
    s_p[tid] = bp;
    s_i[tid] = bi;
    s_nan[tid] = has_nan;
    __syncthreads();
    for (int w = THREADS / 2; w > 0; w >>= 1) {
        if (tid < w) {
            int j = tid + w;
            if (s_i[j] != 0x7fffffff
                    && (s_i[tid] == 0x7fffffff
                        || better(s_t[j], s_p[j], s_i[j], s_t[tid],
                                  s_p[tid], s_i[tid]))) {
                s_t[tid] = s_t[j];
                s_p[tid] = s_p[j];
                s_i[tid] = s_i[j];
            }
            s_nan[tid] |= s_nan[j];
        }
        __syncthreads();
    }
    if (tid == 0) {
        if (s_nan[0]) {
            // a NaN total makes the reference's top NaN: no node ties it
            // and its argmax falls to index 0
            A.choice[b] = 0;
            A.win_now[b] = total_at(A, b, g, 0, top_t, scale_a);
        } else if (s_i[0] == 0x7fffffff) {
            A.choice[b] = -1;
        } else {
            A.choice[b] = s_i[0];
            A.win_now[b] = s_t[0];
        }
    }
}

// end state: per pod, nodes passing statics + fit, and statics but not fit
__global__ void auction_final(AuctionArgs A) {
    int b = blockIdx.x, tid = threadIdx.x;
    int g = A.gid[b];
    const uint8_t* ok = A.static_ok + (size_t)g * A.N;
    int feas = 0, rej = 0;
    for (int n = tid; n < A.N; n += THREADS) {
        if (!ok[n]) continue;
        if (fits(A, b, n)) feas += 1;
        else rej += 1;
    }
    // warp shuffle then shared reduction: integer sums, exact
    for (int o = 16; o > 0; o >>= 1) {
        feas += __shfl_down_sync(0xffffffffu, feas, o);
        rej += __shfl_down_sync(0xffffffffu, rej, o);
    }
    __shared__ int s_f[THREADS / 32], s_r[THREADS / 32];
    if ((tid & 31) == 0) {
        s_f[tid >> 5] = feas;
        s_r[tid >> 5] = rej;
    }
    __syncthreads();
    if (tid == 0) {
        int tf = 0, tr = 0;
        for (int k = 0; k < THREADS / 32; ++k) {
            tf += s_f[k];
            tr += s_r[k];
        }
        A.feas_count[b] = tf;
        A.fit_rejects[b] = tr;
    }
}

extern "C" int auction_score_argmax_launch(const AuctionArgs* args,
                                           int final_mode, void* stream) {
    AuctionArgs A = *args;
    if (A.R > MAX_R || A.shape_n > MAX_SHAPE) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (final_mode)
        auction_final<<<A.B, THREADS, 0, s>>>(A);
    else
        auction_bid<<<A.B, THREADS, 0, s>>>(A);
    return (int)cudaGetLastError();
}

extern "C" int auction_args_size() { return (int)sizeof(AuctionArgs); }

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
