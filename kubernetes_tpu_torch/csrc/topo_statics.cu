// K5 topo_statics: the per-group topology statics of one topology launch.
//
// Replaces: kubernetes_tpu/models/pipeline.py schedule_batch phase 1b,
// `per_group` (:1078-1145) over ops/topology.py (take_cols :46,
// slot_topo_dom :55, sel_match :62, table_mask :84, incoming_terms_vs_table
// :97, table_terms_vs_incoming :111, scatter_or :127, gather_rows :137,
// inter_pod_affinity_static :202, inter_pod_affinity_score :250,
// _tsc_self_match :303, _tsc_matches :311, spread_eligible :322,
// spread_cnt :342, spread_exists :360), and the pairwise group matches
// `M_*_gg` (:1153-1173, pair_term_match :159, pair_tsc_match :181). The
// twins are kubernetes_tpu_torch/kernels/topology.py:topo_table_ref,
// topo_nodes_ref and topo_pairs_ref.
//
// One cooperative launch (topo_statics_kernel) of three stages with a grid
// barrier between them; each stage's work items are virtual blocks of
// THREADS threads that the launch's blocks walk (the grid holds what the
// card holds at once). Before it, one memset zeroes the maps and the two
// presence maps, which lie side by side at the front of the outputs' one
// allocation (kernels/topology.py out_layout).
//
// 1. table: one thread per (group g, table slot s). It evaluates
//    every term that relates slot s and the group's representative pod —
//    namespace and selector match with sel_match semantics (In / NotIn /
//    Exists / DoesNotExist; an unknown op matches nothing; unused
//    expression slots pass) — and scatters into the group's domain maps:
//    a byte store of 1 for the anti-affinity forbid map and the affinity
//    presence map (the same value from every writer, so the race is
//    benign), atomicAdd for the weighted score map and the spread counts.
//    The sums are exact in any order: the counts are integers and the
//    weights are integers <= 100 (hardPodAffinityWeight 1), so every
//    float32 sum stays below 2^24. Slots follow table_mask: a slot never
//    counts for its own uid; nominated slots count for anti-affinity only.
//    Spread eligibility of the slot's node (the node-inclusion policies)
//    reads K1's TaintToleration / NodeAffinity masks of the group, which
//    phase1_static.cu writes beside static_ok; nothing is evaluated twice.
// 2. nodes: one thread per (group g, node n). It gathers the maps at
//    the node's domains (NONE -> false / 0; an index past the map's end
//    clamps to its last entry, as the reference's gather does) into the
//    node-space statics, and marks the spread domains present among the
//    eligible nodes (exists_hard) and among the statically feasible,
//    non-ignored nodes (exists_score).
// 3. pairs: one block per (group, constraint) counts the domains of
//    both presence maps — num_domains, and tpw = log(count + 2) read from
//    the host-built LOG2P table (the kernel calls no logf, so it agrees
//    with its twin exactly) — and the remaining threads, one per
//    (group x, term, group y), evaluate the pairwise term and constraint
//    matches.
//
// The previous design launched the stages as three kernels after seven
// memsets (a PostFilter dry run pays all of them: 258 of the 354 launches
// of a chip_smoke.py call), each kernel's grid sized by its own stage, and
// refused G > 65,535 (grid.y).
//
// What bounds it on an H100: bytes. Stage 1 reads the used fields of each
// table row once per group (the term kinds a row does not use are skipped
// after one word; a TopologySpreading row reads ~40 words) and its node's
// topology row; stage 2 reads the node's topology row and the domain maps
// (L2 resident: [TK, D] bytes and floats per group) and writes ~30 bytes
// per (group, node); stage 3 reads the presence maps once. The integer
// compares of the selector matches are far below the integer rate.
//
// Built with -fmad=false (no float multiply-adds are formed anyway).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define NONE (-1)
#define OP_IN 0
#define OP_NOT_IN 1
#define OP_EXISTS 2
#define OP_DOES_NOT_EXIST 3
#define THREADS 256
#define K_ANTI 0
#define K_AFF 1
#define K_PAFF 2
#define K_PANTI 3

// Dimensions and field offsets into the table and pod i32 rows. Mirrored
// by kernels/topology.py:_Layout (same members, same order).
struct TopoLayout {
    int N, G, PT, TK, D, A, C, NS, MS, V, KP, TI, PI;
    int t_valid, t_node, t_ns, t_uid, t_nominated, t_labels;
    int t_tk[4], t_nsid[4], t_nsall[4], t_cols[4], t_ops[4], t_vals[4],
        t_w[4];
    int p_valid, p_ns, p_uid, p_labels;
    int p_tk[4], p_nsid[4], p_nsall[4], p_cols[4], p_ops[4], p_vals[4],
        p_w[4];
    int p_tsc_tk, p_tsc_hard, p_tsc_cols, p_tsc_ops, p_tsc_vals,
        p_tsc_honor_aff, p_tsc_honor_taints;
    long zero_bytes;           // the zeroed front of the outputs
};

// Tensors. Mirrored by kernels/topology.py:_Args.
struct TopoArgs {
    const int* table;          // [PT, TI] the pod table blob
    const int* pods;           // [G, PI] the groups' full-schema rows
    const int* topo_dom;       // [N, TK]
    const uint8_t* node_valid;  // [N]
    const uint8_t* static_ok;   // [G, N] (K1)
    const uint8_t* taint_ok;    // [G, N] (K1)
    const uint8_t* nodeaff_ok;  // [G, N] (K1)
    const float* log2p;        // [D + 1]
    // stage 1
    uint8_t* forbid;           // [G, TK, D]
    uint8_t* present;          // [G, A, D]
    uint8_t* any_match;        // [G]
    float* score;              // [G, TK, D]
    float* cnt;                // [G, C, D]
    // stage 2
    uint8_t* anti_ok;          // [G, N]
    float* ipa_raw;            // [G, N]
    uint8_t* term_static;      // [G, N, A]
    uint8_t* has_lbl;          // [G, N, A]
    uint8_t* ign;              // [G, N]
    uint8_t* el_node;          // [G, N, C]
    float* match_static;       // [G, N, C]
    uint8_t* dom_ok;           // [G, N, C]
    uint8_t* exists_hard;      // [G, C, D]
    uint8_t* exists_score;     // [G, C, D]
    // stage 3
    uint8_t* m_terms;          // [4, G, A, G]
    uint8_t* m_tsc;            // [G, C, G]
    float* tpw;                // [G, C]
    float* self_match;         // [G, C]
    int* num_domains;          // [G, C]
    uint8_t* has_soft;         // [G]
    uint8_t* zero;             // the outputs' allocation (its front zeroed)
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// LabelSelector match of one op-coded selector (cols/ops [MS], vals
// [MS, V]) over a target's pod-label row (labels [KP]).
__device__ bool sel_match(const TopoLayout& L, const int* cols,
                          const int* ops, const int* vals,
                          const int* labels) {
    for (int e = 0; e < L.MS; ++e) {
        int op = ops[e];
        if (op == NONE) continue;
        int col = cols[e];
        int tv = col >= 0 ? labels[clampi(col, 0, L.KP - 1)] : NONE;
        bool present = tv != NONE;
        bool inin = false;
        if (present) {
            for (int v = 0; v < L.V; ++v) {
                int c = vals[e * L.V + v];
                if (c != NONE && c == tv) {
                    inin = true;
                    break;
                }
            }
        }
        bool m;
        if (op == OP_IN) m = inin;
        else if (op == OP_NOT_IN) m = !inin;
        else if (op == OP_EXISTS) m = present;
        else if (op == OP_DOES_NOT_EXIST) m = !present;
        else m = false;
        if (!m) return false;
    }
    return true;
}

// namespaces [NS] (NONE padded) + all-namespaces flag vs one namespace
__device__ bool ns_match(const TopoLayout& L, const int* ns, int ns_all,
                         int target) {
    if (ns_all) return true;
    for (int i = 0; i < L.NS; ++i)
        if (ns[i] != NONE && ns[i] == target) return true;
    return false;
}

// does the pod row `x`'s term (kind k, slot a) select the target with
// namespace `tns` and label row `labels`? (AffinityTerm.Matches)
__device__ bool pod_term_selects(const TopoLayout& L, const int* x, int k,
                                 int a, int tns, const int* labels) {
    if (x[L.p_tk[k] + a] == NONE) return false;
    if (!ns_match(L, x + L.p_nsid[k] + a * L.NS, x[L.p_nsall[k] + a], tns))
        return false;
    return sel_match(L, x + L.p_cols[k] + a * L.MS,
                     x + L.p_ops[k] + a * L.MS,
                     x + L.p_vals[k] + a * L.MS * L.V, labels);
}

// does table row `t`'s term (kind k, slot a) select the pod row `x`?
__device__ bool table_term_selects(const TopoLayout& L, const int* t, int k,
                                   int a, const int* x) {
    if (t[L.t_tk[k] + a] == NONE) return false;
    if (!ns_match(L, t + L.t_nsid[k] + a * L.NS, t[L.t_nsall[k] + a],
                  x[L.p_ns]))
        return false;
    return sel_match(L, t + L.t_cols[k] + a * L.MS,
                     t + L.t_ops[k] + a * L.MS,
                     t + L.t_vals[k] + a * L.MS * L.V, x + L.p_labels);
}

// the domain of node n under constraint c's key (NONE if unused / absent)
__device__ __forceinline__ int tsc_dom(const TopoLayout& L, const int* x,
                                       const int* dn, int c) {
    int tk = x[L.p_tsc_tk + c];
    return tk == NONE ? NONE : dn[clampi(tk, 0, L.TK - 1)];
}

// spread_eligible(consider = constraints of hardness `hard`)[n, c]
__device__ bool spread_eligible(const TopoLayout& L, const TopoArgs& P,
                                const int* x, int g, int n, int c,
                                bool hard) {
    const int* dn = P.topo_dom + (size_t)n * L.TK;
    bool all_topo = true;
    for (int k = 0; k < L.C; ++k) {
        bool consider = x[L.p_tsc_tk + k] != NONE
                        && ((x[L.p_tsc_hard + k] != 0) == hard);
        if (consider && tsc_dom(L, x, dn, k) == NONE) all_topo = false;
    }
    bool consider_c = x[L.p_tsc_tk + c] != NONE
                      && ((x[L.p_tsc_hard + c] != 0) == hard);
    size_t o = (size_t)g * L.N + n;
    bool ok = (x[L.p_tsc_honor_aff + c] ? P.nodeaff_ok[o] != 0 : true)
              && (x[L.p_tsc_honor_taints + c] ? P.taint_ok[o] != 0 : true);
    return P.node_valid[n] && all_topo && ok && consider_c;
}

__device__ __forceinline__ void set_flat(uint8_t* map, int row, int dom,
                                         int rows, int d) {
    // scatter_or: the flat index row * D + dom, dropped past the end
    long flat = (long)row * d + dom;
    if (flat < (long)rows * d) map[flat] = 1;
}

__device__ __forceinline__ void add_flat(float* map, int row, int dom,
                                         int rows, int d, float v) {
    long flat = (long)row * d + dom;
    if (flat < (long)rows * d) atomicAdd(map + flat, v);
}

// stage 1, virtual block (bx, g)
__device__ void table_item(const TopoLayout& L, const TopoArgs& P, int bx,
                           int g) {
    int s = bx * THREADS + threadIdx.x;
    if (s >= L.PT) return;
    const int* t = P.table + (size_t)s * L.TI;
    const int* x = P.pods + (size_t)g * L.PI;
    // table_mask: valid slots other than the pod's own entry
    if (!t[L.t_valid] || t[L.t_uid] == x[L.p_uid]) return;
    bool nominated = t[L.t_nominated] != 0;
    int node = t[L.t_node] < 0 ? 0 : t[L.t_node];
    const int* td = P.topo_dom + (size_t)node * L.TK;  // slot_topo_dom
    int tns = t[L.t_ns];
    const int* tlab = t + L.t_labels;
    uint8_t* forbid = P.forbid + (size_t)g * L.TK * L.D;
    float* score = P.score + (size_t)g * L.TK * L.D;
    // rule 1: the slot's required anti-affinity terms select the pod
    for (int a = 0; a < L.A; ++a) {
        int tk = t[L.t_tk[K_ANTI] + a];
        if (tk == NONE || !table_term_selects(L, t, K_ANTI, a, x)) continue;
        int dom = td[clampi(tk, 0, L.TK - 1)];
        if (dom != NONE) set_flat(forbid, tk, dom, L.TK, L.D);
    }
    // rule 2: the pod's required anti-affinity terms select the slot
    for (int a = 0; a < L.A; ++a) {
        int tk = x[L.p_tk[K_ANTI] + a];
        if (tk == NONE || !pod_term_selects(L, x, K_ANTI, a, tns, tlab))
            continue;
        int dom = td[clampi(tk, 0, L.TK - 1)];
        if (dom != NONE) set_flat(forbid, tk, dom, L.TK, L.D);
    }
    if (nominated) return;  // the rest counts bound pods only
    // rule 3: the pod's required affinity terms find the slot
    for (int a = 0; a < L.A; ++a) {
        int tk = x[L.p_tk[K_AFF] + a];
        if (tk == NONE || !pod_term_selects(L, x, K_AFF, a, tns, tlab))
            continue;
        int dom = td[clampi(tk, 0, L.TK - 1)];
        if (dom == NONE) continue;
        set_flat(P.present + (size_t)g * L.A * L.D, a, dom, L.A, L.D);
        P.any_match[g] = 1;
    }
    // score: the pod's preferred terms over the slot ...
    for (int k = K_PAFF; k <= K_PANTI; ++k) {
        float sign = k == K_PAFF ? 1.0f : -1.0f;
        for (int a = 0; a < L.A; ++a) {
            int tk = x[L.p_tk[k] + a];
            if (tk == NONE || !pod_term_selects(L, x, k, a, tns, tlab))
                continue;
            int dom = td[clampi(tk, 0, L.TK - 1)];
            if (dom == NONE) continue;
            add_flat(score, tk, dom, L.TK, L.D,
                     sign * (float)x[L.p_w[k] + a]);
        }
    }
    // ... and the slot's required (hardPodAffinityWeight 1) and preferred
    // terms over the pod
    for (int k = K_AFF; k <= K_PANTI; ++k) {
        float sign = k == K_PANTI ? -1.0f : 1.0f;
        for (int a = 0; a < L.A; ++a) {
            int tk = t[L.t_tk[k] + a];
            if (tk == NONE || !table_term_selects(L, t, k, a, x)) continue;
            int dom = td[clampi(tk, 0, L.TK - 1)];
            if (dom == NONE) continue;
            float w = k == K_AFF ? 1.0f : (float)t[L.t_w[k] + a];
            add_flat(score, tk, dom, L.TK, L.D, sign * w);
        }
    }
    // spread counts: the slot matches constraint c in the pod's namespace
    // and sits on a node eligible for c
    for (int c = 0; c < L.C; ++c) {
        int tk = x[L.p_tsc_tk + c];
        if (tk == NONE || tns != x[L.p_ns]) continue;
        if (!sel_match(L, x + L.p_tsc_cols + c * L.MS,
                       x + L.p_tsc_ops + c * L.MS,
                       x + L.p_tsc_vals + c * L.MS * L.V, tlab))
            continue;
        bool hard = x[L.p_tsc_hard + c] != 0;
        if (!spread_eligible(L, P, x, g, node, c, hard)) continue;
        int dom = td[clampi(tk, 0, L.TK - 1)];
        if (dom == NONE) continue;
        add_flat(P.cnt + (size_t)g * L.C * L.D, c, dom, L.C, L.D, 1.0f);
    }
}

// stage 2, virtual block (bx, g)
__device__ void nodes_item(const TopoLayout& L, const TopoArgs& P, int bx,
                           int g) {
    int n = bx * THREADS + threadIdx.x;
    if (n >= L.N) return;
    const int* x = P.pods + (size_t)g * L.PI;
    const int* dn = P.topo_dom + (size_t)n * L.TK;
    size_t gn = (size_t)g * L.N + n;
    bool valid = P.node_valid[n] != 0;
    int dmax = L.D - 1;
    // anti-affinity: any of the node's domains forbidden
    const uint8_t* forbid = P.forbid + (size_t)g * L.TK * L.D;
    const float* score = P.score + (size_t)g * L.TK * L.D;
    bool fail = false;
    float ipa = 0.0f;
    for (int t = 0; t < L.TK; ++t) {
        int d = dn[t];
        float v = 0.0f;
        if (d != NONE) {
            int dd = clampi(d, 0, dmax);
            if (forbid[t * L.D + dd]) fail = true;
            v = score[t * L.D + dd];
        }
        ipa = t == 0 ? v : ipa + v;
    }
    P.anti_ok[gn] = fail ? 0 : 1;
    P.ipa_raw[gn] = ipa;
    // required affinity from the table, per term
    const uint8_t* present = P.present + (size_t)g * L.A * L.D;
    for (int a = 0; a < L.A; ++a) {
        int tk = x[L.p_tk[K_AFF] + a];
        int nd = tk == NONE ? NONE : dn[clampi(tk, 0, L.TK - 1)];
        bool hl = nd != NONE;
        P.has_lbl[gn * L.A + a] = hl ? 1 : 0;
        P.term_static[gn * L.A + a] =
            (hl && present[a * L.D + clampi(nd, 0, dmax)]) ? 1 : 0;
    }
    // spread (each constraint's domain is looked up again in the second
    // pass: no per-thread array, so any number of constraints)
    bool all_h = true, all_s = true, ign = false;
    for (int c = 0; c < L.C; ++c) {
        const int ndc = tsc_dom(L, x, dn, c);
        bool used = x[L.p_tsc_tk + c] != NONE;
        bool hard = x[L.p_tsc_hard + c] != 0;
        if (used && hard && ndc == NONE) all_h = false;
        if (used && !hard && ndc == NONE) {
            all_s = false;
            ign = true;
        }
    }
    P.ign[gn] = ign ? 1 : 0;
    bool score_live = P.static_ok[gn] && !ign;
    bool aff_ok = P.nodeaff_ok[gn] != 0, taint_ok = P.taint_ok[gn] != 0;
    const float* cnt = P.cnt + (size_t)g * L.C * L.D;
    for (int c = 0; c < L.C; ++c) {
        const int ndc = tsc_dom(L, x, dn, c);
        bool used = x[L.p_tsc_tk + c] != NONE;
        bool hard = x[L.p_tsc_hard + c] != 0;
        bool honor_aff = x[L.p_tsc_honor_aff + c] != 0;
        bool honor_taints = x[L.p_tsc_honor_taints + c] != 0;
        bool pol_raw = (honor_aff ? aff_ok : true)
                       && (honor_taints ? taint_ok : true);
        bool el_hard = valid && all_h && pol_raw && used && hard;
        if (el_hard && ndc != NONE)
            set_flat(P.exists_hard + (size_t)g * L.C * L.D, c, ndc, L.C,
                     L.D);
        if (score_live && used && !hard && ndc != NONE)
            set_flat(P.exists_score + (size_t)g * L.C * L.D, c, ndc, L.C,
                     L.D);
        bool pol = (honor_aff ? aff_ok && valid : true)
                   && (honor_taints ? taint_ok && valid : true);
        bool all_k = (used && hard) ? all_h : all_s;
        size_t o = gn * L.C + c;
        P.el_node[o] = (pol && all_k && used) ? 1 : 0;
        P.dom_ok[o] = ndc != NONE ? 1 : 0;
        P.match_static[o] =
            ndc != NONE ? cnt[c * L.D + clampi(ndc, 0, dmax)] : 0.0f;
    }
}

// stage 3, virtual block vb: the block of every thread runs it
__device__ void pairs_item(const TopoLayout& L, const TopoArgs& P, long vb,
                           int* s_h) {
    int tid = threadIdx.x;
    int counts = L.G * L.C;
    if (vb < counts) {
        // one block per (group, constraint): the two domain counts
        int g = (int)(vb / L.C), c = (int)(vb % L.C);
        int* s_s = s_h + THREADS;
        __syncthreads();  // the previous item's reads of s_h / s_s
        size_t base = ((size_t)g * L.C + c) * L.D;
        int h = 0, sc = 0;
        for (int d = tid; d < L.D; d += THREADS) {
            h += P.exists_hard[base + d];
            sc += P.exists_score[base + d];
        }
        s_h[tid] = h;
        s_s[tid] = sc;
        __syncthreads();
        for (int w = THREADS / 2; w > 0; w >>= 1) {
            if (tid < w) {
                s_h[tid] += s_h[tid + w];
                s_s[tid] += s_s[tid + w];
            }
            __syncthreads();
        }
        if (tid == 0) {
            const int* x = P.pods + (size_t)g * L.PI;
            int o = g * L.C + c;
            P.num_domains[o] = s_h[0];
            P.tpw[o] = P.log2p[s_s[0]];
            P.self_match[o] =
                sel_match(L, x + L.p_tsc_cols + c * L.MS,
                          x + L.p_tsc_ops + c * L.MS,
                          x + L.p_tsc_vals + c * L.MS * L.V,
                          x + L.p_labels) ? 1.0f : 0.0f;
            if (c == 0) {
                bool soft = false;
                for (int k = 0; k < L.C; ++k)
                    if (x[L.p_tsc_tk + k] != NONE && !x[L.p_tsc_hard + k])
                        soft = true;
                P.has_soft[g] = soft ? 1 : 0;
            }
        }
        return;
    }
    // pairwise matches: m_terms [4, G, A, G], then m_tsc [G, C, G]
    long p = (vb - counts) * THREADS + tid;
    long n_terms = 4L * L.G * L.A * L.G;
    long n_tsc = (long)L.G * L.C * L.G;
    if (p < n_terms) {
        int y = (int)(p % L.G);
        int a = (int)((p / L.G) % L.A);
        int xg = (int)((p / ((long)L.G * L.A)) % L.G);
        int k = (int)(p / ((long)L.G * L.A * L.G));
        const int* x = P.pods + (size_t)xg * L.PI;
        const int* yr = P.pods + (size_t)y * L.PI;
        bool m = yr[L.p_valid] != 0
                 && pod_term_selects(L, x, k, a, yr[L.p_ns],
                                     yr + L.p_labels);
        P.m_terms[p] = m ? 1 : 0;
    } else if (p < n_terms + n_tsc) {
        long q = p - n_terms;
        int y = (int)(q % L.G);
        int c = (int)((q / L.G) % L.C);
        int xg = (int)(q / ((long)L.G * L.C));
        const int* x = P.pods + (size_t)xg * L.PI;
        const int* yr = P.pods + (size_t)y * L.PI;
        bool m = x[L.p_tsc_tk + c] != NONE && yr[L.p_valid] != 0
                 && x[L.p_ns] == yr[L.p_ns]
                 && sel_match(L, x + L.p_tsc_cols + c * L.MS,
                              x + L.p_tsc_ops + c * L.MS,
                              x + L.p_tsc_vals + c * L.MS * L.V,
                              yr + L.p_labels);
        P.m_tsc[q] = m ? 1 : 0;
    }
}

// the stages' virtual blocks
__device__ __forceinline__ long table_blocks(const TopoLayout& L) {
    return (long)((L.PT + THREADS - 1) / THREADS) * L.G;
}

__device__ __forceinline__ long node_blocks(const TopoLayout& L) {
    return (long)((L.N + THREADS - 1) / THREADS) * L.G;
}

__host__ __device__ __forceinline__ long pair_blocks(const TopoLayout& L) {
    long pairs = 4L * L.G * L.A * L.G + (long)L.G * L.C * L.G;
    return (long)L.G * L.C + (pairs + THREADS - 1) / THREADS;
}

__global__ void __launch_bounds__(THREADS)
topo_statics_kernel(TopoLayout L, TopoArgs P) {
    __shared__ int s_sum[2 * THREADS];
    cg::grid_group grid = cg::this_grid();
    const int bt = (L.PT + THREADS - 1) / THREADS;
    for (long vb = blockIdx.x; vb < table_blocks(L); vb += gridDim.x)
        table_item(L, P, (int)(vb % bt), (int)(vb / bt));
    grid.sync();
    const int bn = (L.N + THREADS - 1) / THREADS;
    for (long vb = blockIdx.x; vb < node_blocks(L); vb += gridDim.x)
        nodes_item(L, P, (int)(vb % bn), (int)(vb / bn));
    grid.sync();
    for (long vb = blockIdx.x; vb < pair_blocks(L); vb += gridDim.x)
        pairs_item(L, P, vb, s_sum);
}

// blocks of THREADS threads the card holds at once (the cooperative
// launch's largest grid)
extern "C" int topo_statics_grid(int* blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, topo_statics_kernel, THREADS, 0);
    *blocks = sms * per_sm;
    return (int)e;
}

// zero the maps, then the one cooperative launch over `blocks` blocks
extern "C" int topo_statics_launch(const TopoLayout* layout,
                                   const TopoArgs* args, int blocks,
                                   void* stream) {
    const TopoLayout& L = *layout;
    if (L.D < 1 || L.G < 1 || blocks < 1 || args->zero == nullptr)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = cudaMemsetAsync(args->zero, 0, (size_t)L.zero_bytes, s);
    if (e != cudaSuccess) return (int)e;
    void* params[] = {(void*)layout, (void*)args};
    e = cudaLaunchCooperativeKernel((void*)topo_statics_kernel, dim3(blocks),
                                    dim3(THREADS), params, 0, s);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
