// K1 phase1_static: the static Filter/Score phase of one batched launch.
//
// Replaces: kubernetes_tpu/models/pipeline.py schedule_batch phase 1,
// `per_pod` (:968) over `static_filters` (:268) -> ops/filters.py
// (node_unschedulable, node_name, taint_toleration, node_affinity +
// _selector_match, node_ports), ops/scores.py (taint_toleration_score,
// node_affinity_score, image_locality) and ops/common.py. The twin is
// kubernetes_tpu_torch/kernels/phase1.py:phase1_static_ref.
//
// Work: one thread per (group row g, node n), grid (ceil(N/256), G). Per
// pair it evaluates the five static masks in FILTER_PLUGINS order (a
// disabled or inactive plugin passes everything, as the reference's
// dead-code elimination does), the first-fail reject counts over valid
// nodes, the three raw scores and the unresolvable count. The
// TaintToleration and NodeAffinity masks are also written on their own:
// the topology statics (K5, topo_statics.cu) read them for spread
// eligibility instead of evaluating the two filters again.
//
// What bounds it on an H100: bytes. Each node row is read once per group
// (taints 3x8, label columns 2x32, ports 3x64, images 2x16 and
// allocatable 8 words: ~1.3 KB), and the pod row once per block; the
// selector/port compares are a few hundred integer operations per pair,
// far below the integer rate. The design keeps the pod row in shared
// memory (every thread of a block serves the same pod), reads node rows
// straight out of the resident mirror blobs (no unpack copies), and
// aggregates the reject and unresolvable counts per block with
// __syncthreads_count before one atomicAdd, so counter contention is one
// atomic per block. The counts are integers, exact in any order.
//
// image_locality needs, per pod image, the number of valid nodes holding
// it before any node's score: p1_image_presence counts them (and the
// valid nodes) with atomics in a first pass.
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
#define THREADS 256

// Field offsets into the blob rows and the launch flags. The order of the
// members is mirrored by kernels/phase1.py:_Layout.
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
};

// does the pod tolerate one taint (key, val, effect)?
__device__ bool tolerates(const P1Layout& L, const int* pi, int key, int val,
                          int effect) {
    for (int t = 0; t < L.TO; ++t) {
        if (!pi[L.p_tol_valid + t]) continue;
        int te = pi[L.p_tol_effect + t];
        int tk = pi[L.p_tol_key + t];
        bool m_effect = (te == NONE) || (te == effect);
        bool m_key = (tk == NONE) || (tk == key);
        bool m_op = (pi[L.p_tol_op + t] == TOL_EXISTS)
                    || (pi[L.p_tol_val + t] == val);
        if (m_effect && m_key && m_op) return true;
    }
    return false;
}

// one node-selector expression (ops/filters.py:_selector_match)
__device__ bool expr_match(const P1Layout& L, const int* ni, const float* nf,
                           int col, int op, int is_field, const int* vals,
                           float rhs) {
    int val;
    bool present;
    if (is_field) {
        val = ni[L.n_name];
        present = true;
    } else {
        val = col >= 0 ? ni[L.n_label_vals + col] : NONE;
        present = val != NONE;
    }
    bool in_vals = false;
    for (int v = 0; v < L.SV; ++v) {
        int c = vals[v];
        if (c != NONE && c == val) in_vals = true;
    }
    float num = col >= 0 ? nf[L.n_label_nums + col] : __int_as_float(0x7fc00000);
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
__device__ void term_eval(const P1Layout& L, const int* ni, const float* nf,
                          const int* cols, const int* ops, const int* is_field,
                          const int* vals, const float* nums, int t,
                          bool* ok, bool* nonempty) {
    bool all_ok = true, any_used = false;
    for (int e = 0; e < L.SE; ++e) {
        int k = t * L.SE + e;
        int op = ops[k];
        if (op == NONE) continue;
        any_used = true;
        if (!expr_match(L, ni, nf, cols[k], op, is_field[k],
                        vals + k * L.SV, nums[k]))
            all_ok = false;
    }
    *ok = all_ok;
    *nonempty = any_used;
}

extern "C" __global__ void p1_image_presence(P1Layout L,
                                             const float* node_f32,
                                             const int* node_i32,
                                             const int* pod_i32,
                                             int* have, int* num_valid) {
    int g = blockIdx.y;
    int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= L.N) return;
    const int* ni = node_i32 + (size_t)n * L.NI;
    if (!ni[L.n_valid]) return;
    if (g == 0) atomicAdd(num_valid, 1);
    const int* pi = pod_i32 + (size_t)g * L.PI;
    for (int im = 0; im < L.IM; ++im) {
        int pim = pi[L.p_image_ids + im];
        if (pim == NONE) continue;
        for (int i = 0; i < L.I; ++i) {
            if (ni[L.n_image_ids + i] == pim) {
                atomicAdd(&have[g * L.IM + im], 1);
                break;
            }
        }
    }
}

extern "C" __global__ void p1_main(P1Layout L, const float* node_f32,
                                   const int* node_i32,
                                   const float* pod_f32, const int* pod_i32,
                                   const int* have, const int* num_valid,
                                   uint8_t* static_ok, int* rejects,
                                   float* taint_raw, float* aff_raw,
                                   float* img, int* unres,
                                   uint8_t* taint_ok, uint8_t* nodeaff_ok) {
    extern __shared__ int smem[];
    int g = blockIdx.y;
    // stage the pod row: every thread of the block serves pod g
    float* pf = reinterpret_cast<float*>(smem);
    int* pi = smem + L.PF;
    for (int k = threadIdx.x; k < L.PF; k += blockDim.x)
        pf[k] = pod_f32[(size_t)g * L.PF + k];
    for (int k = threadIdx.x; k < L.PI; k += blockDim.x)
        pi[k] = pod_i32[(size_t)g * L.PI + k];
    __syncthreads();

    int n = blockIdx.x * blockDim.x + threadIdx.x;
    bool live = n < L.N;
    int nn = live ? n : 0;
    const float* nf = node_f32 + (size_t)nn * L.NF;
    const int* ni = node_i32 + (size_t)nn * L.NI;
    bool valid = live && ni[L.n_valid] != 0;
    bool pod_valid = pi[L.p_valid] != 0;

    bool m[NUM_STATIC] = {true, true, true, true, true};
    // NodeUnschedulable
    if (L.en0) {
        bool tol = tolerates(L, pi, L.unsched_key, 0, EFFECT_NO_SCHEDULE);
        m[0] = !ni[L.n_unsched] || tol;
    }
    // NodeName
    if (L.en1) {
        int want = pi[L.p_node_name];
        m[1] = (want == NONE) || (ni[L.n_name] == want);
    }
    // TaintToleration filter + score share the per-taint toleration test
    float taint_score = 0.0f;
    if (L.act_taints) {
        bool hard_bad = false;
        int soft_bad = 0;
        for (int t = 0; t < L.T; ++t) {
            int key = ni[L.n_taint_keys + t];
            if (key == NONE) continue;
            int eff = ni[L.n_taint_effects + t];
            bool hard = eff == EFFECT_NO_SCHEDULE || eff == EFFECT_NO_EXECUTE;
            bool soft = eff == EFFECT_PREFER_NO_SCHEDULE;
            if (!hard && !soft) continue;
            bool tol = tolerates(L, pi, key, ni[L.n_taint_vals + t], eff);
            if (hard && !tol) hard_bad = true;
            if (soft && !tol) soft_bad += 1;
        }
        if (L.en2) m[2] = !hard_bad;
        taint_score = (float)soft_bad;
    }
    // NodeAffinity
    if (L.en3 && (L.act_aff_full || L.act_aff_pin)) {
        int pin = pi[L.p_aff_pin];
        bool pin_ok = (pin == NONE) || (ni[L.n_name] == pin);
        bool ok = pin_ok;
        if (L.act_aff_full) {
            bool sel_ok = true;
            for (int p = 0; p < L.PL; ++p) {
                int want = pi[L.p_nodesel_vals + p];
                if (want == NONE) continue;
                int col = pi[L.p_nodesel_cols + p];
                int have_v = col >= 0 ? ni[L.n_label_vals + col] : NONE;
                if (have_v != want) sel_ok = false;
            }
            bool any_term = false, any_ok = false;
            for (int t = 0; t < L.ST; ++t) {
                if (!pi[L.p_sel_term_valid + t]) continue;
                any_term = true;
                bool tok, nonempty;
                term_eval(L, ni, nf, pi + L.p_sel_col, pi + L.p_sel_op,
                          pi + L.p_sel_is_field, pi + L.p_sel_vals,
                          pf + L.p_sel_num, t, &tok, &nonempty);
                if (tok && nonempty) any_ok = true;
            }
            bool affinity_ok = any_term ? any_ok : true;
            ok = sel_ok && affinity_ok && pin_ok;
        }
        m[3] = ok;
    }
    // NodeAffinity preferred-term score (only with the full kernels)
    float aff_score = 0.0f;
    if (L.act_aff_full) {
        for (int t = 0; t < L.PW; ++t) {
            int w = pi[L.p_pref_weight + t];
            bool tok, nonempty;
            term_eval(L, ni, nf, pi + L.p_pref_col, pi + L.p_pref_op,
                      pi + L.p_pref_is_field, pi + L.p_pref_vals,
                      pf + L.p_pref_num, t, &tok, &nonempty);
            if (tok && nonempty && w != 0) aff_score = aff_score + (float)w;
        }
    }
    // NodePorts
    if (L.en4 && L.act_ports) {
        bool conflict = false;
        for (int h = 0; h < L.HP && !conflict; ++h) {
            int pp = pi[L.p_hp_port + h];
            if (pp == NONE) continue;
            int pproto = pi[L.p_hp_proto + h];
            int pip = pi[L.p_hp_ip + h];
            for (int q = 0; q < L.P; ++q) {
                if (ni[L.n_port_nums + q] != pp) continue;
                if (ni[L.n_port_protos + q] != pproto) continue;
                int nip = ni[L.n_port_ips + q];
                if (nip == pip || nip == L.wildcard_ip
                        || pip == L.wildcard_ip) {
                    conflict = true;
                    break;
                }
            }
        }
        m[4] = !conflict;
    }
    // ImageLocality
    float img_score = 0.0f;
    if (L.act_images) {
        float nv = (float)(*num_valid);
        float denom = fmaxf(nv, 1.0f);
        float summed = 0.0f;
        for (int im = 0; im < L.IM; ++im) {
            int pim = pi[L.p_image_ids + im];
            bool present = false;
            float size = 0.0f;
            for (int i = 0; i < L.I; ++i) {
                if (ni[L.n_image_ids + i] == pim) {
                    size = fmaxf(size, nf[L.n_image_sizes + i]);
                    if (pim != NONE) present = true;
                }
            }
            float spread = (float)have[g * L.IM + im] / denom;
            float term = (present ? 1.0f : 0.0f) * size * spread;
            summed = im == 0 ? term : summed + term;
        }
        float max_t = 1000.0f * fmaxf(pf[L.p_num_containers], 1.0f);
        float x = (summed - 23.0f) / (max_t - 23.0f);
        img_score = fminf(fmaxf(x, 0.0f), 1.0f) * 100.0f;
    }
    // unresolvable: the request exceeds allocatable
    bool unresolvable = false;
    for (int r = 0; r < L.R; ++r)
        if (pf[L.p_req + r] > nf[L.n_alloc + r]) unresolvable = true;

    bool all_ok = m[0] && m[1] && m[2] && m[3] && m[4];
    if (live) {
        size_t o = (size_t)g * L.N + n;
        static_ok[o] = (all_ok && valid && pod_valid) ? 1 : 0;
        taint_raw[o] = taint_score;
        aff_raw[o] = aff_score;
        img[o] = img_score;
        taint_ok[o] = m[2] ? 1 : 0;
        nodeaff_ok[o] = m[3] ? 1 : 0;
    }
    // first-fail attribution over valid nodes, one atomic per block
    bool prev = true;
    for (int i = 0; i < NUM_STATIC; ++i) {
        int c = __syncthreads_count(prev && !m[i] && valid);
        if (threadIdx.x == 0 && c) atomicAdd(&rejects[g * NUM_STATIC + i], c);
        prev = prev && m[i];
    }
    int cu = __syncthreads_count(unresolvable && valid);
    if (threadIdx.x == 0 && cu) atomicAdd(&unres[g], cu);
}

extern "C" int phase1_static_launch(const P1Layout* layout,
                                    const float* node_f32,
                                    const int* node_i32,
                                    const float* pod_f32, const int* pod_i32,
                                    int* have, int* num_valid,
                                    uint8_t* static_ok, int* rejects,
                                    float* taint_raw, float* aff_raw,
                                    float* img, int* unres,
                                    uint8_t* taint_ok, uint8_t* nodeaff_ok,
                                    void* stream) {
    P1Layout L = *layout;
    cudaStream_t s = (cudaStream_t)stream;
    dim3 grid((L.N + THREADS - 1) / THREADS, L.G);
    if (L.act_images) {
        p1_image_presence<<<grid, THREADS, 0, s>>>(L, node_f32, node_i32,
                                                    pod_i32, have, num_valid);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    size_t smem = (size_t)(L.PF + L.PI) * sizeof(int);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            p1_main, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    p1_main<<<grid, THREADS, smem, s>>>(L, node_f32, node_i32, pod_f32,
                                        pod_i32, have, num_valid, static_ok,
                                        rejects, taint_raw, aff_raw, img,
                                        unres, taint_ok, nodeaff_ok);
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
