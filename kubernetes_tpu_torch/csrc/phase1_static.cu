// K1 phase1_static: the static Filter/Score phase of one batched launch.
//
// Replaces: kubernetes_tpu/models/pipeline.py schedule_batch phase 1,
// `per_pod` (:968) over `static_filters` (:268) -> ops/filters.py
// (node_unschedulable, node_name, taint_toleration, node_affinity +
// _selector_match, node_ports), ops/scores.py (taint_toleration_score,
// node_affinity_score, image_locality) and ops/common.py. The twin is
// kubernetes_tpu_torch/kernels/phase1.py:phase1_static_ref.
//
// Work: for each (group row g, node n) the five static masks in
// FILTER_PLUGINS order (a disabled or inactive plugin passes everything,
// as the reference's dead-code elimination does), the first-fail reject
// counts over valid nodes, the three raw scores and the unresolvable
// count. The TaintToleration and NodeAffinity masks are also written on
// their own: the topology statics (K5, topo_statics.cu) read them for
// spread eligibility instead of evaluating the two filters again.
//
// What bounds it on an H100: at the main paths' shapes, neither bytes nor
// operations but latency: a pair's work is a chain of dependent loads and
// compares (the resource row and the unschedulable toleration test on
// every launch; taints x tolerations, host ports x pod ports, images x
// pod images, selector expressions x values when those features are
// active), the node columns read at most ~1.3 KB a node, the outputs
// 15 B a pair. The previous design gave a pair one thread on a grid
// (N/256, G): at G = 1 with every feature (each PostFilter dry run) that
// is 8,192 threads, each walking every inner loop alone, and it counted
// image presence with a global atomic per (node, image) hit.
//
// This design:
// - A pair is `lanes` neighbouring lanes of a warp (1, 2, 4 or 8, chosen
//   by the wrapper from G x N and the active features: kernels/phase1.py
//   plan_phase1), pairs node-major, so a warp's lanes read one pod row
//   (broadcast) and write neighbouring nodes' outputs. A pair's lanes
//   split each inner loop (tolerations, taints, node selectors, terms,
//   host ports, images, resources) and merge it with shuffles inside
//   the group; the image score folds the lanes' terms in image order and
//   the affinity score adds integer weights, so the sums are the twin's.
//   At G = 1 with every feature that is 8 lanes a pair: 65,536 threads
//   (16 and 32 read no faster there, and spilled).
// - Counts (first-fail, unresolvable): per block in shared memory, a
//   warp's bits added once where its lanes share a group row, then one
//   atomic per (group row, count) a block; exact in any order.
// - ImageLocality needs, per pod image, the number of valid nodes that
//   hold it before any node's score: with images active a first launch
//   (p1_presence, a thread a pair) counts them per block in shared memory
//   and adds one atomic per (group row, image) a block.
// - The launch is built once per key by the wrapper (P1Launch: the
//   layout, the plan, the entry point); every output is a view of one
//   allocation, whose counts this entry zeroes with one memset.
//
// Host Filter verdicts (``host_ok``, [G, N] bool, optional: GangScheduling's
// PreFilter today) AND into static_ok after the five filters, as at the
// reference's pipeline.py:1035-1038; they never enter the reject counts
// (the scheduler attributes host rejects itself).
//
// Built with -fmad=false: no multiply-add contraction, so the image score
// rounds exactly as the twin does.

#include <cuda_runtime.h>
#include <stdint.h>

#define NONE (-1)
#define EFFECT_NO_SCHEDULE 0
#define EFFECT_PREFER_NO_SCHEDULE 1
#define EFFECT_NO_EXECUTE 2
#define OP_IN 0
#define OP_NOT_IN 1
#define OP_EXISTS 2
#define OP_DOES_NOT_EXIST 3
#define OP_GT 4
#define OP_LT 5
#define TOL_EXISTS 1
#define NUM_STATIC 5
#define NUM_COUNTS 6     // the five first-fail counts, then unresolvable
#define THREADS 256
#define FULL 0xffffffffu

// Field offsets into the blob rows, the launch flags, the plan and the
// outputs' places in their one allocation. The order of the members is
// mirrored by kernels/phase1.py:_Layout.
struct P1Layout {
    int N, G, NF, NI, PF, PI;
    int R, K, T, P, I;
    int TO, PL, ST, SE, SV, PW, HP, IM;
    // node f32
    int n_alloc, n_label_nums, n_image_sizes;
    // node i32
    int n_valid, n_unsched, n_name, n_label_vals, n_taint_keys,
        n_taint_vals, n_taint_effects, n_port_ips, n_port_protos,
        n_port_nums, n_image_ids;
    // pod f32
    int p_req, p_num_containers, p_sel_num, p_pref_num;
    // pod i32
    int p_valid, p_node_name, p_tol_key, p_tol_op, p_tol_val, p_tol_effect,
        p_tol_valid, p_aff_pin, p_nodesel_cols, p_nodesel_vals,
        p_sel_term_valid, p_sel_col, p_sel_op, p_sel_is_field, p_sel_vals,
        p_pref_weight, p_pref_col, p_pref_op, p_pref_is_field, p_pref_vals,
        p_hp_ip, p_hp_proto, p_hp_port, p_image_ids;
    int unsched_key, wildcard_ip;
    int en0, en1, en2, en3, en4;
    int act_taints, act_aff_full, act_aff_pin, act_ports, act_images;
    // the plan: lanes a pair, blocks of THREADS threads, the group rows a
    // block's pairs span (its count rows), the same for the presence
    // launch (a thread a pair), and the two launches' shared bytes
    int lanes, blocks, rows, p_blocks, p_rows, smem, p_smem;
    // byte offsets of the outputs in their one allocation; the counts
    // (rejects, unres, have, num_valid) are one int32 run of count_bytes
    long o_taint_raw, o_aff_raw, o_img, o_rejects, o_unres, o_have,
        o_num_valid, o_static_ok, o_taint_ok, o_nodeaff_ok, count_bytes;
};

struct P1Out {
    float *taint_raw, *aff_raw, *img;
    int *rejects, *unres, *have, *num_valid;
    uint8_t *static_ok, *taint_ok, *nodeaff_ok;
};

__device__ __forceinline__ P1Out outputs(const P1Layout& L, uint8_t* base) {
    P1Out o;
    o.taint_raw = reinterpret_cast<float*>(base + L.o_taint_raw);
    o.aff_raw = reinterpret_cast<float*>(base + L.o_aff_raw);
    o.img = reinterpret_cast<float*>(base + L.o_img);
    o.rejects = reinterpret_cast<int*>(base + L.o_rejects);
    o.unres = reinterpret_cast<int*>(base + L.o_unres);
    o.have = reinterpret_cast<int*>(base + L.o_have);
    o.num_valid = reinterpret_cast<int*>(base + L.o_num_valid);
    o.static_ok = base + L.o_static_ok;
    o.taint_ok = base + L.o_taint_ok;
    o.nodeaff_ok = base + L.o_nodeaff_ok;
    return o;
}

// a pair's place: pairs node-major, `S` lanes each; `li` the lane in the
// pair's group, `gb` the group's first lane
struct Pair {
    long p0;        // the block's first pair
    int g0;         // its group row
    int g, n, li, gb;
    bool live;
};

template <int S>
__device__ __forceinline__ Pair pair_of(const P1Layout& L) {
    Pair q;
    q.p0 = (long)blockIdx.x * (THREADS / S);
    q.g0 = (int)(q.p0 / L.N);
    const int lane = threadIdx.x & 31;
    q.li = lane & (S - 1);
    q.gb = lane - q.li;
    const long pair = q.p0 + threadIdx.x / S;
    q.live = pair < (long)L.G * L.N;
    q.g = q.live ? (int)(pair / L.N) : q.g0;
    q.n = q.live ? (int)(pair - (long)q.g * L.N) : 0;
    return q;
}

// OR / sum over a pair's S lanes (every lane of the warp calls them)
template <int S>
__device__ __forceinline__ bool grp_any(bool x) {
    unsigned v = x ? 1u : 0u;
#pragma unroll
    for (int o = 1; o < S; o <<= 1) v |= __shfl_xor_sync(FULL, v, o);
    return v != 0u;
}

template <int S>
__device__ __forceinline__ int grp_sum(int x) {
#pragma unroll
    for (int o = 1; o < S; o <<= 1) x += __shfl_xor_sync(FULL, x, o);
    return x;
}

// toleration t against one taint (key, val, effect)
__device__ __forceinline__ bool tol_match(const P1Layout& L, const int* pi,
                                          int t, int key, int val,
                                          int effect) {
    if (!__ldg(pi + L.p_tol_valid + t)) return false;
    int te = __ldg(pi + L.p_tol_effect + t);
    int tk = __ldg(pi + L.p_tol_key + t);
    return ((te == NONE) || (te == effect)) && ((tk == NONE) || (tk == key))
           && ((__ldg(pi + L.p_tol_op + t) == TOL_EXISTS)
               || (__ldg(pi + L.p_tol_val + t) == val));
}

// does the pod tolerate one taint (key, val, effect)?
__device__ bool tolerates(const P1Layout& L, const int* pi, int key, int val,
                          int effect) {
    for (int t = 0; t < L.TO; ++t)
        if (tol_match(L, pi, t, key, val, effect)) return true;
    return false;
}

// one node-selector expression (ops/filters.py:_selector_match)
__device__ bool expr_match(const P1Layout& L, const int* ni, const float* nf,
                           int col, int op, int is_field, const int* vals,
                           float rhs) {
    int val;
    bool present;
    if (is_field) {
        val = __ldg(ni + L.n_name);
        present = true;
    } else {
        val = col >= 0 ? __ldg(ni + L.n_label_vals + col) : NONE;
        present = val != NONE;
    }
    bool in_vals = false;
    for (int v = 0; v < L.SV; ++v) {
        int c = __ldg(vals + v);
        if (c != NONE && c == val) in_vals = true;
    }
    float num = col >= 0 ? __ldg(nf + L.n_label_nums + col)
                         : __int_as_float(0x7fc00000);
    bool num_ok = !isnan(num) && !isnan(rhs) && !is_field;
    bool gt = num_ok && (num > rhs);
    bool lt = num_ok && (num < rhs);
    switch (op) {
        case OP_IN: return present && in_vals;
        case OP_NOT_IN: return !(present && in_vals);
        case OP_EXISTS: return present;
        case OP_DOES_NOT_EXIST: return !present;
        case OP_GT: return present && gt;
        case OP_LT: return present && lt;
        default: return false;
    }
}

// all used expressions of term t match (and the term has at least one)
__device__ bool term_ok(const P1Layout& L, const int* ni, const float* nf,
                        const int* pi, const float* pf, int col_off,
                        int op_off, int field_off, int vals_off, int num_off,
                        int t) {
    bool all_ok = true, any_used = false;
    for (int e = 0; e < L.SE; ++e) {
        int k = t * L.SE + e;
        int op = __ldg(pi + op_off + k);
        if (op == NONE) continue;
        any_used = true;
        if (!expr_match(L, ni, nf, __ldg(pi + col_off + k), op,
                        __ldg(pi + field_off + k), pi + vals_off + k * L.SV,
                        __ldg(pf + num_off + k)))
            all_ok = false;
    }
    return all_ok && any_used;
}

// does the node hold pod image pim?
__device__ __forceinline__ bool holds_image(const P1Layout& L, const int* ni,
                                            int pim) {
    if (pim == NONE) return false;
    for (int i = 0; i < L.I; ++i)
        if (__ldg(ni + L.n_image_ids + i) == pim) return true;
    return false;
}

// one pair's verdicts and raw scores (every lane of the pair holds them)
struct Eval {
    unsigned fail;      // bit i: filter i (FILTER_PLUGINS order) fails
    bool unres;
    float taint, aff, img;
};

template <int S>
__device__ void eval_pair(const P1Layout& L, const int* ni, const float* nf,
                          const int* pi, const float* pf, const int* have,
                          float denom, int g, int li, int gb, Eval& r) {
    r.fail = 0u;
    // NodeUnschedulable
    if (L.en0) {
        bool tol = false;
        for (int t = li; t < L.TO; t += S)
            if (tol_match(L, pi, t, L.unsched_key, 0, EFFECT_NO_SCHEDULE))
                tol = true;
        tol = grp_any<S>(tol);
        if (!(!__ldg(ni + L.n_unsched) || tol)) r.fail |= 1u;
    }
    // NodeName
    if (L.en1) {
        int want = __ldg(pi + L.p_node_name);
        if (!((want == NONE) || (__ldg(ni + L.n_name) == want)))
            r.fail |= 2u;
    }
    // TaintToleration filter + score share the per-taint toleration test
    r.taint = 0.0f;
    if (L.act_taints) {
        bool hard_bad = false;
        int soft_bad = 0;
        for (int t = li; t < L.T; t += S) {
            int key = __ldg(ni + L.n_taint_keys + t);
            if (key == NONE) continue;
            int eff = __ldg(ni + L.n_taint_effects + t);
            bool hard = eff == EFFECT_NO_SCHEDULE || eff == EFFECT_NO_EXECUTE;
            bool soft = eff == EFFECT_PREFER_NO_SCHEDULE;
            if (!hard && !soft) continue;
            bool tol = tolerates(L, pi, key, __ldg(ni + L.n_taint_vals + t),
                                 eff);
            if (hard && !tol) hard_bad = true;
            if (soft && !tol) soft_bad += 1;
        }
        hard_bad = grp_any<S>(hard_bad);
        soft_bad = grp_sum<S>(soft_bad);
        if (L.en2 && hard_bad) r.fail |= 4u;
        r.taint = (float)soft_bad;
    }
    // NodeAffinity
    if (L.en3 && (L.act_aff_full || L.act_aff_pin)) {
        int pin = __ldg(pi + L.p_aff_pin);
        bool pin_ok = (pin == NONE) || (__ldg(ni + L.n_name) == pin);
        bool ok = pin_ok;
        if (L.act_aff_full) {
            bool bad = false;
            for (int p = li; p < L.PL; p += S) {
                int want = __ldg(pi + L.p_nodesel_vals + p);
                if (want == NONE) continue;
                int col = __ldg(pi + L.p_nodesel_cols + p);
                int have_v = col >= 0 ? __ldg(ni + L.n_label_vals + col)
                                      : NONE;
                if (have_v != want) bad = true;
            }
            bool any_term = false, any_ok = false;
            for (int t = li; t < L.ST; t += S) {
                if (!__ldg(pi + L.p_sel_term_valid + t)) continue;
                any_term = true;
                if (term_ok(L, ni, nf, pi, pf, L.p_sel_col, L.p_sel_op,
                            L.p_sel_is_field, L.p_sel_vals, L.p_sel_num, t))
                    any_ok = true;
            }
            bad = grp_any<S>(bad);
            any_term = grp_any<S>(any_term);
            any_ok = grp_any<S>(any_ok);
            bool affinity_ok = any_term ? any_ok : true;
            ok = !bad && affinity_ok && pin_ok;
        }
        if (!ok) r.fail |= 8u;
    }
    // NodeAffinity preferred-term score (only with the full kernels):
    // integer weights, so the group's sum is the serial sum
    r.aff = 0.0f;
    if (L.act_aff_full) {
        int w_sum = 0;
        for (int t = li; t < L.PW; t += S) {
            int w = __ldg(pi + L.p_pref_weight + t);
            if (w != 0 && term_ok(L, ni, nf, pi, pf, L.p_pref_col,
                                  L.p_pref_op, L.p_pref_is_field,
                                  L.p_pref_vals, L.p_pref_num, t))
                w_sum += w;
        }
        r.aff = (float)grp_sum<S>(w_sum);
    }
    // NodePorts
    if (L.en4 && L.act_ports) {
        bool conflict = false;
        for (int q = li; q < L.P && !conflict; q += S) {
            int np = __ldg(ni + L.n_port_nums + q);
            int nproto = __ldg(ni + L.n_port_protos + q);
            int nip = __ldg(ni + L.n_port_ips + q);
            for (int h = 0; h < L.HP; ++h) {
                int pp = __ldg(pi + L.p_hp_port + h);
                if (pp == NONE || np != pp) continue;
                if (nproto != __ldg(pi + L.p_hp_proto + h)) continue;
                int pip = __ldg(pi + L.p_hp_ip + h);
                if (nip == pip || nip == L.wildcard_ip
                        || pip == L.wildcard_ip) {
                    conflict = true;
                    break;
                }
            }
        }
        if (grp_any<S>(conflict)) r.fail |= 16u;
    }
    // ImageLocality: each lane its images' terms, folded in image order
    r.img = 0.0f;
    if (L.act_images) {
        float summed = 0.0f;
        for (int im0 = 0; im0 < L.IM; im0 += S) {
            const int im = im0 + li;
            float term = 0.0f;
            if (im < L.IM) {
                int pim = __ldg(pi + L.p_image_ids + im);
                bool present = false;
                float size = 0.0f;
                for (int i = 0; i < L.I; ++i) {
                    if (__ldg(ni + L.n_image_ids + i) == pim) {
                        size = fmaxf(size, __ldg(nf + L.n_image_sizes + i));
                        if (pim != NONE) present = true;
                    }
                }
                float spread = (float)__ldg(have + g * L.IM + im) / denom;
                term = (present ? 1.0f : 0.0f) * size * spread;
            }
#pragma unroll
            for (int j = 0; j < S; ++j) {
                float tj = S == 1 ? term : __shfl_sync(FULL, term, gb + j);
                if (im0 + j < L.IM)
                    summed = im0 + j == 0 ? tj : summed + tj;
            }
        }
        float max_t = 1000.0f * fmaxf(__ldg(pf + L.p_num_containers), 1.0f);
        float x = (summed - 23.0f) / (max_t - 23.0f);
        r.img = fminf(fmaxf(x, 0.0f), 1.0f) * 100.0f;
    }
    // unresolvable: the request exceeds allocatable
    bool unres = false;
    for (int q = li; q < L.R; q += S)
        if (__ldg(pf + L.p_req + q) > __ldg(nf + L.n_alloc + q)) unres = true;
    r.unres = grp_any<S>(unres);
}

// a block's counts, rows [g0, g0 + rows) x width, into `dst` with one
// atomic per non-zero count
__device__ __forceinline__ void flush_counts(const int* s, int rows,
                                             int width, int g0, int G,
                                             int* dst) {
    __syncthreads();
    for (int i = threadIdx.x; i < rows * width; i += blockDim.x) {
        const int c = s[i];
        if (c && g0 + i / width < G) atomicAdd(dst + (long)g0 * width + i, c);
    }
}

// add `bit` of each lane to s[row * width], a warp's lanes at once where
// they share a group row
__device__ __forceinline__ void count_bit(int* s, bool bit, int row,
                                          int width) {
    const int lane = threadIdx.x & 31;
    const bool one_row = __shfl_sync(FULL, row, 0) == __shfl_sync(FULL, row,
                                                                  31);
    if (one_row) {
        const int c = __popc(__ballot_sync(FULL, bit));
        if (lane == 0 && c) atomicAdd(s + row * width, c);
    } else if (bit) {
        atomicAdd(s + row * width, 1);
    }
}

// with images active, the first launch: valid nodes holding each pod
// image (a thread a pair), and the valid nodes
extern "C" __global__ void __launch_bounds__(THREADS)
p1_presence(P1Layout L, const int* node_i32, const int* pod_i32,
            uint8_t* out) {
    extern __shared__ int s_have[];                 // [p_rows, IM], then nv
    const P1Out o = outputs(L, out);
    const Pair q = pair_of<1>(L);
    for (int i = threadIdx.x; i < L.p_rows * L.IM + 1; i += blockDim.x)
        s_have[i] = 0;
    __syncthreads();
    const int* ni = node_i32 + (size_t)q.n * L.NI;
    const int* pi = pod_i32 + (size_t)q.g * L.PI;
    const bool valid = q.live && __ldg(ni + L.n_valid) != 0;
    const int row = q.g - q.g0;
    count_bit(s_have + L.p_rows * L.IM, valid && q.g == 0, 0, 0);
    for (int im = 0; im < L.IM; ++im)
        count_bit(s_have + im,
                  valid && holds_image(L, ni, __ldg(pi + L.p_image_ids + im)),
                  row, L.IM);
    flush_counts(s_have, L.p_rows, L.IM, q.g0, L.G, o.have);
    if (threadIdx.x == 0 && s_have[L.p_rows * L.IM])
        atomicAdd(o.num_valid, s_have[L.p_rows * L.IM]);
}

template <int S>
__global__ void __launch_bounds__(THREADS)
p1_pairs(P1Layout L, const float* node_f32, const int* node_i32,
         const float* pod_f32, const int* pod_i32, uint8_t* out,
         const uint8_t* host_ok) {
    extern __shared__ int s_cnt[];                  // [rows, NUM_COUNTS]
    const P1Out o = outputs(L, out);
    const Pair q = pair_of<S>(L);
    for (int i = threadIdx.x; i < L.rows * NUM_COUNTS; i += blockDim.x)
        s_cnt[i] = 0;
    __syncthreads();
    const int* ni = node_i32 + (size_t)q.n * L.NI;
    const float* nf = node_f32 + (size_t)q.n * L.NF;
    const int* pi = pod_i32 + (size_t)q.g * L.PI;
    const float* pf = pod_f32 + (size_t)q.g * L.PF;
    const float denom = L.act_images
        ? fmaxf((float)__ldg(o.num_valid), 1.0f) : 1.0f;
    Eval r;
    eval_pair<S>(L, ni, nf, pi, pf, o.have, denom, q.g, q.li, q.gb, r);
    const bool valid = q.live && __ldg(ni + L.n_valid) != 0;
    const bool all_ok = r.fail == 0u;
    if (q.live && q.li == 0) {
        const size_t at = (size_t)q.g * L.N + q.n;
        o.static_ok[at] = (all_ok && valid && __ldg(pi + L.p_valid) != 0
                           && (host_ok == nullptr || host_ok[at])) ? 1 : 0;
        o.taint_raw[at] = r.taint;
        o.aff_raw[at] = r.aff;
        o.img[at] = r.img;
        o.taint_ok[at] = (r.fail & 4u) ? 0 : 1;
        o.nodeaff_ok[at] = (r.fail & 8u) ? 0 : 1;
    }
    // first-fail attribution over valid nodes, then unresolvable
    const bool lead = q.live && q.li == 0 && valid;
    const int row = q.g - q.g0;
    // the first failing filter: the lowest set bit
    const unsigned first = r.fail & (0u - r.fail);
#pragma unroll
    for (int i = 0; i < NUM_STATIC; ++i)
        count_bit(s_cnt + i, lead && first == (1u << i), row, NUM_COUNTS);
    count_bit(s_cnt + NUM_STATIC, lead && r.unres, row, NUM_COUNTS);
    __syncthreads();
    for (int i = threadIdx.x; i < L.rows * NUM_COUNTS; i += blockDim.x) {
        const int c = s_cnt[i];
        if (!c) continue;
        const int g = q.g0 + i / NUM_COUNTS, k = i % NUM_COUNTS;
        if (k < NUM_STATIC) atomicAdd(o.rejects + g * NUM_STATIC + k, c);
        else atomicAdd(o.unres + g, c);
    }
}

// zero the counts, then the presence launch (images active) and the
// pairs' launch
extern "C" int phase1_static_launch(const P1Layout* layout,
                                    const float* node_f32,
                                    const int* node_i32,
                                    const float* pod_f32, const int* pod_i32,
                                    uint8_t* out, const uint8_t* host_ok,
                                    void* stream) {
    const P1Layout& L = *layout;
    cudaStream_t s = (cudaStream_t)stream;
    if (L.N < 1 || L.G < 1 || L.blocks < 1
            || (L.act_images && L.p_blocks < 1))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaMemsetAsync(out + L.o_rejects, 0,
                                    (size_t)L.count_bytes, s);
    if (e != cudaSuccess) return (int)e;
    if (L.act_images) {
        p1_presence<<<L.p_blocks, THREADS, L.p_smem, s>>>(L, node_i32,
                                                          pod_i32, out);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    switch (L.lanes) {
        case 1:
            p1_pairs<1><<<L.blocks, THREADS, L.smem, s>>>(
                L, node_f32, node_i32, pod_f32, pod_i32, out, host_ok);
            break;
        case 2:
            p1_pairs<2><<<L.blocks, THREADS, L.smem, s>>>(
                L, node_f32, node_i32, pod_f32, pod_i32, out, host_ok);
            break;
        case 4:
            p1_pairs<4><<<L.blocks, THREADS, L.smem, s>>>(
                L, node_f32, node_i32, pod_f32, pod_i32, out, host_ok);
            break;
        case 8:
            p1_pairs<8><<<L.blocks, THREADS, L.smem, s>>>(
                L, node_f32, node_i32, pod_f32, pod_i32, out, host_ok);
            break;

        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
