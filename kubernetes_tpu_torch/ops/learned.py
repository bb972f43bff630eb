"""The learned score term: a small ReLU MLP over per-node score features
(port of the JAX package's ops/learned.py).

This module is the plain-torch twin of kernel K9 (``csrc/learned_mlp.cuh``,
a device function that K2a and K3 call on every (pod, node) total they
form). The feature vector is the per-node signals the hand-tuned
weighted sum already computes, in LEARNED_FEATURES order:

    0 frac_cpu        cpu utilization fraction including this pod
    1 frac_mem        memory utilization fraction including this pod
    2 fit             NodeResourcesFit strategy score / 100
    3 balance         balanced-allocation score / 100
    4 taint           normalized taint-toleration score / 100
    5 node_affinity   normalized preferred-node-affinity score / 100
    6 image_locality  image-locality score / 100
    7 spread          normalized PodTopologySpread score / 100
    8 ipa             normalized InterPodAffinity score / 100

The output is clipped to [0, 100] and weighted into the aggregate by
``ScoreWeights.learned`` like a hand-tuned term. A NaN anywhere in the
params propagates through the ReLUs and the clip into the aggregate,
where the launch guard (models/pipeline.py ``_guard_reduction``) trips.

Exactness against the kernel: each feature is a true division by 100
(tensor by tensor: torch divides a CUDA tensor by a Python scalar as a
multiply by its reciprocal); each layer's product is a left-to-right sum
over the input index (``acc = x0 * w0j``, then ``acc = acc + xk * wkj``,
then ``+ b_j``), never ``torch.matmul``, so the kernel, built with
-fmad=false, repeats it bit for bit; ReLU and the clip are comparisons
that pass NaN through (``x < 0 ? 0 : x``), as ``jax.nn.relu`` and
``jnp.clip`` do.

Params are a layer stack ``((W, b), ...)`` of float32 tensors, W of shape
[in, out] and b of [out], ReLU between layers and a scalar head
(kernels/learned.py ``LearnedParams.layers`` gives the views of its
packed device buffer).
"""

from __future__ import annotations

import torch

LEARNED_FEATURES = (
    "frac_cpu",
    "frac_mem",
    "fit",
    "balance",
    "taint",
    "node_affinity",
    "image_locality",
    "spread",
    "ipa",
)
NUM_FEATURES = len(LEARNED_FEATURES)

# bumped whenever the feature layout changes; checkpoints record the
# version they were trained against and the loader rejects a mismatch.
# 3 = the topology/IPA columns (the JAX package's FEATURE_VERSION)
FEATURE_VERSION = 3

MAX_SCORE = 100.0


def _by_max(x: torch.Tensor) -> torch.Tensor:
    """x / 100 as a true division (tensor by tensor)."""
    return x / torch.full((), MAX_SCORE, dtype=torch.float32,
                          device=x.device)


def feature_rows(frac: torch.Tensor, fit: torch.Tensor, bal: torch.Tensor,
                 taint: torch.Tensor, aff: torch.Tensor, img: torch.Tensor,
                 spread: torch.Tensor | None = None,
                 ipa: torch.Tensor | None = None) -> torch.Tensor:
    """[..., NUM_FEATURES] feature rows from the per-node arrays the
    pipeline computed for the hand-tuned aggregate (``frac`` [..., 2],
    the rest [...]). ``spread``/``ipa`` default to zero columns
    (no-topology launches)."""
    zeros = torch.zeros_like(fit)
    spread = zeros if spread is None else spread
    ipa = zeros if ipa is None else ipa
    return torch.stack(
        [frac[..., 0], frac[..., 1], _by_max(fit), _by_max(bal),
         _by_max(taint), _by_max(aff), _by_max(img), _by_max(spread),
         _by_max(ipa)], dim=-1)


def relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with NaN passed through (K9's ``x < 0 ? 0 : x``)."""
    return torch.where(x < 0, torch.zeros((), dtype=x.dtype,
                                          device=x.device), x)


def clip_score(x: torch.Tensor) -> torch.Tensor:
    """clip(x, 0, 100) with NaN passed through."""
    lo = torch.zeros((), dtype=x.dtype, device=x.device)
    hi = torch.full((), MAX_SCORE, dtype=x.dtype, device=x.device)
    return torch.where(x < 0, lo, torch.where(x > MAX_SCORE, hi, x))


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
          ) -> torch.Tensor:
    """[..., in] @ [in, out] + [out] as a left-to-right sum over the
    input index, then the bias: K9's operation order."""
    acc = x[..., 0:1] * w[0]
    for k in range(1, w.shape[0]):
        acc = acc + x[..., k:k + 1] * w[k]
    return acc + b


def mlp_apply(params, feats: torch.Tensor) -> torch.Tensor:
    """[..., F] -> [...]: the MLP forward pass (ReLU hidden layers,
    linear scalar head)."""
    x = feats
    last = len(params) - 1
    for i, (w, b) in enumerate(params):
        x = dense(x, w, b)
        if i < last:
            x = relu(x)
    return x[..., 0]


def learned_term(params, frac: torch.Tensor, fit: torch.Tensor,
                 bal: torch.Tensor, taint: torch.Tensor, aff: torch.Tensor,
                 img: torch.Tensor, spread: torch.Tensor | None = None,
                 ipa: torch.Tensor | None = None) -> torch.Tensor:
    """[...] learned score in [0, 100]; NaN params stay NaN through the
    clip so the launch guard owns the containment."""
    raw = mlp_apply(params, feature_rows(frac, fit, bal, taint, aff, img,
                                         spread, ipa))
    return clip_score(raw)


def hand_weight_vector():
    """The default hand-tuned score weights aligned to LEARNED_FEATURES
    order (the frac features carry weight 0), from the port's live
    models/pipeline.py default_weights. Lazy import: the pipeline's
    kernels import this module."""
    import numpy as np

    from kubernetes_tpu_torch.models.pipeline import default_weights

    w = default_weights()
    return np.array([0.0, 0.0, float(w.resources_fit),
                     float(w.balanced_allocation),
                     float(w.taint_toleration),
                     float(w.node_affinity),
                     float(w.image_locality),
                     float(w.pod_topology_spread),
                     float(w.inter_pod_affinity)], np.float32)


def feature_row_at(row, frac: torch.Tensor, fit: torch.Tensor,
                   bal: torch.Tensor, taint: torch.Tensor,
                   aff: torch.Tensor, img: torch.Tensor,
                   spread: torch.Tensor | None = None,
                   ipa: torch.Tensor | None = None) -> torch.Tensor:
    """[NUM_FEATURES] feature vector of ONE node row (frac [N, 2], the
    rest [N])."""
    zero = torch.zeros((), dtype=torch.float32, device=fit.device)
    sp = zero if spread is None else spread[row]
    ip = zero if ipa is None else ipa[row]
    return torch.stack(
        [frac[row, 0], frac[row, 1], _by_max(fit[row]), _by_max(bal[row]),
         _by_max(taint[row]), _by_max(aff[row]), _by_max(img[row]),
         _by_max(sp), _by_max(ip)])
