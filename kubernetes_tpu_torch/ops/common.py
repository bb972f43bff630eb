"""Shared primitives for the plugin twins (port of the JAX package's
ops/common.py).

The JAX functions evaluate ONE pod against all nodes and are vmapped over
the batch; these take the pod axis written out as the leading dimension
([G] or [B]) and broadcast it against the node axis [N]. Everything is
masked arithmetic in the same operation order as the reference, so the
twins reproduce its float results bit for bit on the CPU.
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.utils.interner import NONE


def isin(value: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    """value: [...]; candidates: [..., V] padded with NONE. True if value
    equals any non-NONE candidate."""
    v = value[..., None]
    return torch.any((candidates == v) & (candidates != NONE), dim=-1)


def tolerations_tolerate(
    tol_valid: torch.Tensor, tol_key: torch.Tensor, tol_op: torch.Tensor,
    tol_val: torch.Tensor, tol_effect: torch.Tensor,
    taint_key: torch.Tensor, taint_val: torch.Tensor,
    taint_effect: torch.Tensor,
) -> torch.Tensor:
    """For each (pod, node, taint slot): is it tolerated by any toleration?

    tol_*: [G, TO] (pod side); taint_*: [N, T] (node side). Returns
    [G, N, T] bool. Semantics: v1.Toleration.ToleratesTaint."""
    from kubernetes_tpu_torch.ops.features import TOL_EXISTS

    tk = taint_key[None, :, :, None]       # [1, N, T, 1]
    tv = taint_val[None, :, :, None]
    te = taint_effect[None, :, :, None]
    tol = lambda x: x[:, None, None, :]    # noqa: E731  [G, 1, 1, TO]
    m_effect = (tol(tol_effect) == NONE) | (tol(tol_effect) == te)
    m_key = (tol(tol_key) == NONE) | (tol(tol_key) == tk)
    m_op = (tol(tol_op) == TOL_EXISTS) | (tol(tol_val) == tv)
    m = tol(tol_valid) & m_effect & m_key & m_op
    return torch.any(m, dim=-1)


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim: int = -1
               ) -> torch.Tensor:
    neg = torch.tensor(-torch.inf, dtype=x.dtype, device=x.device)
    return torch.amax(torch.where(mask, x, neg), dim=dim)


def masked_argmax_random(score: torch.Tensor, mask: torch.Tensor,
                         perturb: torch.Tensor) -> torch.Tensor:
    """Row-wise tie-broken argmax over the last axis: equal top scores pick
    the highest pre-drawn perturbation in [0, 1), then the lowest index
    (jnp.argmax returns the first maximum); -1 for a row with no
    candidate. A NaN among the candidates makes the top NaN, no entry
    ties it, and the row picks index 0 — the reference's behavior, which
    the launch guard then reports."""
    neg = torch.tensor(-torch.inf, dtype=score.dtype, device=score.device)
    s = torch.where(mask, score, neg)
    top = torch.amax(s, dim=-1, keepdim=True)    # NaN propagates
    tie = mask & (s == top)
    # torch.argmax's tie order is unspecified; the lowest index among the
    # maxima is taken explicitly
    keyed = torch.where(tie, perturb,
                        torch.tensor(-1.0, dtype=perturb.dtype,
                                     device=perturb.device))
    best = torch.amax(keyed, dim=-1, keepdim=True)
    n = score.shape[-1]
    idx = torch.arange(n, device=score.device).expand_as(keyed)
    pick = torch.where(keyed == best, idx,
                       torch.tensor(n, device=score.device)).amin(dim=-1)
    return torch.where(mask.any(dim=-1), pick.to(torch.int32),
                       torch.tensor(-1, dtype=torch.int32,
                                    device=score.device))
