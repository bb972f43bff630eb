// K7a gang_pack: the fused gang packer — for G gangs in order, member
// capacity per node, the all-or-nothing verdict, the domain-major greedy
// fill, and the commit into the carried usage.
//
// Replaces: kubernetes_tpu/ops/gang.py `pack_gangs` (:77, jitted at
// :189-191), the `lax.scan` body at :133-178. The twin is
// kubernetes_tpu_torch/ops/gang.py:pack_core (through
// kernels/gang.py:pack_core_ref); the static filter mask it reads comes
// from K1 (phase1_static.cu) on the gangs' representative rows.
//
// One thread block carries the whole launch and walks the gangs in order
// with __syncthreads() between the steps, so gang g+1 reads g's commit in
// the carried free/nzr (updated in place) and no grid barrier is needed;
// any node count runs, since every per-node array lives in device memory
// (the wrapper's scratch) and the block strides over it. Per gang:
//
//   1. cap[n] = static_ok ? clip(min over active columns r of
//      floor(max((free - nom) + onom * req, 0) / req), 0, 2^20) : 0 (2^20
//      for every column when NodeResourcesFit is off), the twin's f32
//      operations in its order (-fmad=false), true division;
//   2. dcap[d] = the int64 sum of cap over each packing domain, the exact
//      total, and the verdict: cap = min(f32(total), 2^30), ok = cap >= m
//      and m > 0;
//   3. the fill order without a sort. A domain's rank counts the
//      non-empty domains of larger capacity (lower id first at equal
//      capacity); within a domain nodes fill by min(cap, 4095)
//      descending, then by index. Thread 0 walks the ranks to the domain
//      d* where the cumulative capacity first reaches m; a 4,096-bin
//      histogram of d*'s capacity by min(cap, 4095), scanned in fill
//      order, gives the threshold density cc*; one block-wide scan over
//      the nodes of d* at density cc*, in index order, gives each its
//      prefix. Every node before the threshold takes its whole capacity,
//      every node after it nothing, a threshold node
//      clip(m - prefix, 0, cap): the twin's stable double argsort and
//      cumulative take, node for node;
//   4. alloc, the commit (free -= take * req, nzr += take * nzreq, the
//      twin's product then difference) and spans, the number of domains
//      where some node took members.
//
// The guard (bit 1: a NaN in the post-batch free) closes the launch.
// Sums are int64, so they are exact in any atomic order; the outputs are
// integers, bools and the twin's f32 operations: card and twin agree
// exactly. (The reference's int32 prefix wraps past 2^31 member slots;
// see ops/gang.py.)
//
// What bounds it on an H100: the one block's latency, not bytes. A launch
// of G = 16 gangs over N = 8,192 nodes of R = 8 columns reads each gang's
// free and nominated matrices (2 x 256 KB, from L2 after the first gang)
// and writes alloc (32 KB) per gang; the steps are separated by some
// twenty block barriers per gang, and one SM does all of it.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 1024
#define NWARPS (THREADS / 32)
#define KEY_STRIDE 4096
#define UNBOUNDED 1048576.0f
#define CAP_LIMIT 1073741824.0f

static_assert(THREADS * 4 == KEY_STRIDE, "4 histogram bins a thread");

// Mirrored by kernels/gang.py:_PackArgs (same members, same order).
struct PackArgs {
    int G, N, R, d_cap, tk, fit_on, dom_stride;
    float* free;                // [N, R] in/out: the carried free
    float* nzr;                 // [N, 2] in/out: the carried nzr
    const float* nom;           // [N, R] nominated reservations
    const uint8_t* static_ok;   // [G, N] K1's mask
    const int* topo;            // topo_dom[:, max(tk, 0)], row stride dom_stride
    const float* req;           // [G, R]
    const float* nzreq;         // [G, 2]
    const int* need;            // [G]
    const int* own_nom;         // [G, N] or null (all zero)
    uint8_t* ok;                // [G]
    int* alloc;                 // [G, N]
    int* cap;                   // [G]
    int* spans;                 // [G]
    int* guard;                 // []
    int* capn;                  // [N] scratch: this gang's capacity per node
    int* dom;                   // [N] scratch: packing domain per node
    long long* dcap;            // [d_cap] scratch
    int* rank;                  // [d_cap] scratch
    int* by_rank;               // [d_cap] scratch
    int* used;                  // [d_cap] scratch
    long long* hist;            // [KEY_STRIDE] scratch
};

// jnp.maximum(x, 0) / torch.maximum: a NaN propagates
__device__ __forceinline__ float max0_nan(float x) {
    return (x != x) ? x : (x > 0.0f ? x : 0.0f);
}

// jnp.min / torch.amin over a row: a NaN wins
__device__ __forceinline__ float min_nan(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return b < a ? b : a;
}

// jnp.clip / torch.clamp: a NaN propagates
__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
    if (x != x) return x;
    return x < lo ? lo : (x > hi ? hi : x);
}

// XLA's f32 -> i32: NaN -> 0, saturating (ops/gang.py:f32_to_i32)
__device__ __forceinline__ int f2i(float x) {
    if (x != x) return 0;
    if (x >= 2147483648.0f) return 2147483647;
    if (x <= -2147483648.0f) return (int)0x80000000;
    return (int)x;
}

// Block-wide exclusive scan of one int64 a thread (THREADS threads); the
// block total in *total when given. Every thread must call it.
__device__ long long block_excl_scan(long long v, long long* s_warp,
                                     long long* total) {
    const unsigned FULL = 0xffffffffu;
    int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    long long x = v;
    for (int o = 1; o < 32; o <<= 1) {
        long long y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[wid] = x;
    __syncthreads();
    if (wid == 0) {
        long long w = s_warp[lane];
        for (int o = 1; o < 32; o <<= 1) {
            long long y = __shfl_up_sync(FULL, w, o);
            if (lane >= o) w += y;
        }
        s_warp[lane] = w;
    }
    __syncthreads();
    long long excl = (wid > 0 ? s_warp[wid - 1] : 0) + x - v;
    if (total) *total = s_warp[NWARPS - 1];
    __syncthreads();
    return excl;
}

__global__ void __launch_bounds__(THREADS) gang_pack(PackArgs A) {
    __shared__ long long s_warp[NWARPS];
    __shared__ long long s_need_in, s_above;
    __shared__ int s_feas, s_rstar, s_dstar, s_ccstar, s_k;
    const int tid = threadIdx.x;
    const int N = A.N, R = A.R, D = A.d_cap;
    // node -> packing domain (once a launch): the tk column, NONE labels,
    // tk = -1 and ids past the bucket in the last slot
    for (int n = tid; n < N; n += THREADS) {
        int d = D - 1;
        if (A.tk >= 0) {
            int raw = A.topo[(long)n * A.dom_stride];
            if (raw >= 0 && raw < D - 1) d = raw;
        }
        A.dom[n] = d;
    }
    const int chunk = (N + THREADS - 1) / THREADS;
    const int lo = min(tid * chunk, N), hi = min(lo + chunk, N);
    for (int g = 0; g < A.G; ++g) {
        const float* rq = A.req + (long)g * R;
        const float* nzq = A.nzreq + (long)g * 2;
        const int m = A.need[g];
        if (tid == 0) s_k = 0;
        for (int d = tid; d < D; d += THREADS) A.dcap[d] = 0;
        __syncthreads();
        // 1-2. capacity per node, domain sums, the exact total
        long long local = 0;
        for (int n = tid; n < N; n += THREADS) {
            int c = 0;
            if (A.static_ok[(long)g * N + n]) {
                float cf = UNBOUNDED;
                if (A.fit_on) {
                    float onom = A.own_nom
                        ? (float)A.own_nom[(long)g * N + n] : 0.0f;
                    const float* fr = A.free + (long)n * R;
                    const float* nm = A.nom + (long)n * R;
                    for (int r = 0; r < R; ++r) {
                        float q = rq[r];
                        float pc = UNBOUNDED;
                        if (q > 0.0f) {
                            float e = fr[r] - nm[r];
                            float prod = onom * q;
                            e = e + prod;
                            pc = floorf(max0_nan(e) / q);
                        }
                        cf = (r == 0) ? pc : min_nan(cf, pc);
                    }
                }
                c = f2i(clip_nan(cf, 0.0f, UNBOUNDED));
            }
            A.capn[n] = c;
            if (c > 0)
                atomicAdd((unsigned long long*)&A.dcap[A.dom[n]],
                          (unsigned long long)c);
            local += c;
        }
        long long total;
        block_excl_scan(local, s_warp, &total);
        // 3a. ranks of the non-empty domains
        for (int d = tid; d < D; d += THREADS) {
            A.used[d] = 0;
            long long v = A.dcap[d];
            if (v > 0) {
                int rk = 0;
                for (int e = 0; e < D; ++e) {
                    long long w = A.dcap[e];
                    rk += (w > v) || (w == v && e < d);
                }
                A.rank[d] = rk;
                A.by_rank[rk] = d;
                atomicAdd(&s_k, 1);
            }
        }
        __syncthreads();
        // the verdict, and the domain where the fill reaches m
        if (tid == 0) {
            float tf = (float)total;
            float tot = tf < CAP_LIMIT ? tf : CAP_LIMIT;
            int cap_total = f2i(tot);
            int feas = (cap_total >= m) && (m > 0);
            A.cap[g] = cap_total;
            A.ok[g] = (uint8_t)feas;
            int rstar = s_k, dstar = -1;
            long long before = 0;
            if (feas) {
                long long acc = 0;
                for (int r = 0; r < s_k; ++r) {
                    long long v = A.dcap[A.by_rank[r]];
                    if (acc + v >= m) {
                        rstar = r;
                        dstar = A.by_rank[r];
                        before = acc;
                        break;
                    }
                    acc += v;
                }
            }
            s_feas = feas;
            s_rstar = rstar;
            s_dstar = dstar;
            s_need_in = (long long)m - before;
        }
        __syncthreads();
        const int feas = s_feas, rstar = s_rstar, dstar = s_dstar;
        const bool split = feas && dstar >= 0;
        // 3b. the threshold density inside d*
        if (split) {
            for (int b = tid; b < KEY_STRIDE; b += THREADS) A.hist[b] = 0;
            __syncthreads();
            for (int n = tid; n < N; n += THREADS) {
                int c = A.capn[n];
                if (c > 0 && A.dom[n] == dstar)
                    atomicAdd((unsigned long long*)
                              &A.hist[min(c, KEY_STRIDE - 1)],
                              (unsigned long long)c);
            }
            __syncthreads();
            long long loc = 0;
            for (int j = 0; j < 4; ++j)
                loc += A.hist[KEY_STRIDE - 1 - (4 * tid + j)];
            long long ex = block_excl_scan(loc, s_warp, nullptr);
            long long need_in = s_need_in;
            if (ex < need_in && ex + loc >= need_in) {
                long long acc = ex;
                for (int j = 0; j < 4; ++j) {
                    int b = KEY_STRIDE - 1 - (4 * tid + j);
                    long long h = A.hist[b];
                    if (acc + h >= need_in) {
                        s_ccstar = b;
                        s_above = acc;
                        break;
                    }
                    acc += h;
                }
            }
            __syncthreads();
        }
        const int ccstar = split ? s_ccstar : -1;
        const long long rem0 = split ? s_need_in - s_above : 0;
        // 3c. prefixes of the threshold nodes, in index order
        long long tie_local = 0;
        if (split) {
            for (int n = lo; n < hi; ++n) {
                int c = A.capn[n];
                if (c > 0 && A.dom[n] == dstar
                        && min(c, KEY_STRIDE - 1) == ccstar)
                    tie_local += c;
            }
        }
        long long tie = block_excl_scan(tie_local, s_warp, nullptr);
        // 4. take, alloc, commit
        for (int n = lo; n < hi; ++n) {
            int c = A.capn[n];
            long long take = 0;
            if (feas && c > 0) {
                int rk = A.rank[A.dom[n]];
                if (rk < rstar) {
                    take = c;
                } else if (rk == rstar) {
                    int cc = min(c, KEY_STRIDE - 1);
                    if (cc > ccstar) {
                        take = c;
                    } else if (cc == ccstar) {
                        long long left = rem0 - tie;
                        take = left <= 0 ? 0 : (left < c ? left : c);
                        tie += c;
                    }
                }
            }
            A.alloc[(long)g * N + n] = (int)take;
            float tf = (float)take;
            float* fr = A.free + (long)n * R;
            for (int r = 0; r < R; ++r) {
                float prod = tf * rq[r];
                fr[r] = fr[r] - prod;
            }
            float* nz = A.nzr + (long)n * 2;
            for (int k = 0; k < 2; ++k) {
                float prod = tf * nzq[k];
                nz[k] = nz[k] + prod;
            }
            if (take > 0) A.used[A.dom[n]] = 1;
        }
        __syncthreads();
        int cnt = 0;
        for (int d = tid; d < D; d += THREADS) cnt += A.used[d] != 0;
        long long n_used;
        block_excl_scan(cnt, s_warp, &n_used);
        if (tid == 0) A.spans[g] = (int)n_used;
    }
    __syncthreads();
    int nan_local = 0;
    for (long i = tid; i < (long)N * R; i += THREADS) {
        float v = A.free[i];
        nan_local |= (v != v);
    }
    long long any_nan;
    block_excl_scan(nan_local, s_warp, &any_nan);
    if (tid == 0) *A.guard = (any_nan > 0 ? 1 : 0) << 1;
}

extern "C" int gang_pack_launch(const PackArgs* args, void* stream) {
    PackArgs A = *args;
    if (A.G < 0 || A.N < 1 || A.R < 1 || A.d_cap < 1)
        return (int)cudaErrorInvalidValue;
    gang_pack<<<1, THREADS, 0, (cudaStream_t)stream>>>(A);
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
