"""Score extension point with reference-parity normalization (port of the
JAX package's ops/scores.py).

Pod batch axis leading, node axis next: raw scores are [G, N] float32.
The arithmetic keeps the reference's operation order (small sums are
written out left to right) so the CPU results are bit-identical and the
kernels in ``kubernetes_tpu_torch/csrc`` can repeat them exactly.

Reference algorithms:
- least/most allocated:   noderesources/least_allocated.go:30, most_allocated.go:30
- balanced allocation:    noderesources/balanced_allocation.go (std of fractions)
- node affinity score:    nodeaffinity (sum of matched preferred weights)
- taint toleration score: tainttoleration:146 (intolerable PreferNoSchedule count)
- image locality:         imagelocality (scaled sum of present image sizes)
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_tpu_torch.ops import common as C
from kubernetes_tpu_torch.ops.features import (
    COL_CPU,
    COL_MEM,
    EFFECT_PREFER_NO_SCHEDULE,
    ClusterTensors,
    PodFeatures,
)
from kubernetes_tpu_torch.ops.filters import _selector_match
from kubernetes_tpu_torch.utils.interner import NONE

MAX_NODE_SCORE = 100.0

# jnp.interp's "dx is zero" threshold: np.spacing(finfo(float32).eps)
INTERP_EPS = float(np.spacing(np.finfo(np.float32).eps))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def utilization_fractions(alloc2: torch.Tensor,
                          nonzero_requested: torch.Tensor,
                          pod_nonzero_req: torch.Tensor) -> torch.Tensor:
    """(NonZeroRequested + pod nonzero request) / allocatable for cpu,
    memory: [B, N, 2] from alloc2/nzr [N, 2] and the pods' [B, 2],
    clamped to [0, 1]; allocatable 0 -> fraction 1."""
    req = nonzero_requested[None] + pod_nonzero_req[:, None, :]
    a = alloc2[None]
    frac = torch.where(a > 0, req / torch.clamp(a, min=_f32(1e-9, a)),
                       _f32(1.0, a))
    return torch.clamp(frac, 0.0, 1.0)


def _mean2(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    return (x0 + x1) / 2.0


def least_allocated_from_fractions(frac: torch.Tensor) -> torch.Tensor:
    """mean over {cpu, mem} of (1 - utilization) * 100."""
    return _mean2(1.0 - frac[..., 0], 1.0 - frac[..., 1]) * MAX_NODE_SCORE


def most_allocated_from_fractions(frac: torch.Tensor) -> torch.Tensor:
    """mean utilization * 100: bin-packing bias."""
    return _mean2(frac[..., 0], frac[..., 1]) * MAX_NODE_SCORE


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
           ) -> torch.Tensor:
    """jnp.interp (constant extrapolation), same arithmetic."""
    k = xp.shape[0]
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, k - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= INTERP_EPS
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, _f32(1.0, dx), dx))
                    * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def requested_to_capacity_ratio_from_fractions(
        frac: torch.Tensor, shape_x: torch.Tensor,
        shape_y: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear utilization -> score per resource, averaged
    (requested_to_capacity_ratio.go:60)."""
    per_res = interp(frac, shape_x, shape_y)
    return _mean2(per_res[..., 0], per_res[..., 1])


def fit_score_from_fractions(frac: torch.Tensor, strategy: str,
                             shape) -> torch.Tensor:
    """NodeResourcesFit score under the configured ScoringStrategy."""
    if strategy == "MostAllocated":
        return most_allocated_from_fractions(frac)
    if strategy == "RequestedToCapacityRatio":
        return requested_to_capacity_ratio_from_fractions(
            frac, shape[0], shape[1])
    return least_allocated_from_fractions(frac)


def balanced_allocation_from_fractions(frac: torch.Tensor) -> torch.Tensor:
    """(1 - std(fractions)) * 100 (balanced_allocation.go)."""
    f0, f1 = frac[..., 0], frac[..., 1]
    mean = _mean2(f0, f1)
    d0, d1 = f0 - mean, f1 - mean
    std = torch.sqrt(_mean2(d0 * d0, d1 * d1))
    return (1.0 - std) * MAX_NODE_SCORE


def alloc_cpu_mem(ct: ClusterTensors) -> torch.Tensor:
    return torch.stack([ct.allocatable[:, COL_CPU],
                        ct.allocatable[:, COL_MEM]], dim=-1)


def node_affinity_score(ct: ClusterTensors, pod: PodFeatures
                        ) -> torch.Tensor:
    """Sum of weights of matching PreferredSchedulingTerms (raw; normalized
    by max across nodes at aggregation)."""
    match = _selector_match(ct, pod.pref_col, pod.pref_op, pod.pref_is_field,
                            pod.pref_vals, pod.pref_num)      # [G, N, PW, E]
    used = pod.pref_op != NONE                                 # [G, PW, E]
    term_ok = torch.all(match | ~used[:, None], dim=-1)        # [G, N, PW]
    term_nonempty = torch.any(used, dim=-1)                    # [G, PW]
    active = (term_nonempty & (pod.pref_weight != 0))[:, None]
    w = pod.pref_weight.to(torch.float32)[:, None]
    per = torch.where(term_ok & active, w, _f32(0.0, w))
    return _sum_last(per)


def taint_toleration_score(ct: ClusterTensors, pod: PodFeatures
                           ) -> torch.Tensor:
    """Raw = count of intolerable PreferNoSchedule taints (lower is better;
    inverted by normalize_inverse)."""
    tolerated = C.tolerations_tolerate(
        pod.tol_valid, pod.tol_key, pod.tol_op, pod.tol_val, pod.tol_effect,
        ct.taint_keys, ct.taint_vals, ct.taint_effects)      # [G, N, T]
    soft = ((ct.taint_effects == EFFECT_PREFER_NO_SCHEDULE)
            & (ct.taint_keys != NONE))[None]
    return torch.sum(soft & ~tolerated, dim=-1).to(torch.float32)


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right sum over the (small) last axis: the order the kernels
    use, fixed here instead of left to torch's vectorized reduction."""
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def image_locality(ct: ClusterTensors, pod: PodFeatures,
                   num_nodes: torch.Tensor) -> torch.Tensor:
    """Scaled sum of sizes of requested images already present
    (imagelocality.go): each image's size is scaled by the fraction of
    nodes having it (spread), then mapped through [23Mi, 1000Mi] ->
    [0, 100]."""
    pim = pod.image_ids[:, None, :, None]          # [G, 1, IM, 1]
    nim = ct.image_ids[None, :, None, :]           # [1, N, 1, I]
    eq = nim == pim
    present = torch.any(eq & (pim != NONE), dim=-1)            # [G, N, IM]
    sizes = torch.amax(torch.where(eq, ct.image_sizes[None, :, None, :],
                                   _f32(0.0, ct.image_sizes)), dim=-1)
    have = torch.sum(present & ct.node_valid[None, :, None], dim=1)
    spread = (have.to(torch.float32)
              / torch.clamp(num_nodes.to(torch.float32), min=1.0))
    summed = _sum_last(present.to(torch.float32) * sizes
                       * spread[:, None, :])                    # [G, N]
    min_t = 23.0
    max_t = (1000.0 * torch.clamp(pod.num_containers, min=1.0))[:, None]
    return torch.clamp((summed - min_t) / (max_t - min_t), 0.0, 1.0) \
        * MAX_NODE_SCORE


# ---------------- normalization (per-plugin NormalizeScore) ----------------


def _top(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    top = C.masked_max(scores, mask, dim=-1)[..., None]
    return torch.where(torch.isfinite(top) & (top > 0), top,
                       _f32(1.0, top))


def normalize_max(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """DefaultNormalizeScore: score * 100 / max, per row. The quotient is
    a true float32 division (torch evaluates ``scalar / tensor`` as a
    reciprocal times the scalar, which rounds differently)."""
    top = _top(scores, mask)
    return scores * (_f32(MAX_NODE_SCORE, top) / top)


def normalize_inverse(scores: torch.Tensor, mask: torch.Tensor
                      ) -> torch.Tensor:
    """Reverse normalize (taint toleration): 100 * (1 - score/max)."""
    return (1.0 - scores / _top(scores, mask)) * MAX_NODE_SCORE
