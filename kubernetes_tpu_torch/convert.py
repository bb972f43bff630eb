"""Carry a packed launch across from numpy arrays.

The scheduler's state is the packed cluster and pod blobs plus the score
weights and, with LearnedScore, the learned scorer's few dozen trained
floats. These helpers build the port's objects from plain numpy arrays —
for example the JAX package's arrays, which a caller obtains with
``np.asarray`` — so one packed launch and one scorer can be fed to both
packages. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_tpu_torch.backend.mirror import LaunchSpec
from kubernetes_tpu_torch.kernels.learned import LearnedParams
from kubernetes_tpu_torch.models.pipeline import ScoreWeights
from kubernetes_tpu_torch.ops.dra import DraBatch
from kubernetes_tpu_torch.ops.features import ClusterBlobs, PodBlobs


def _t(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=device)


def blobs_from_numpy(f32, i32, device="cuda") -> PodBlobs:
    """A (f32, i32) blob pair (pod batch or pod template) on ``device``."""
    return PodBlobs(f32=_t(np.asarray(f32, np.float32), device),
                    i32=_t(np.asarray(i32, np.int32), device))


def cluster_blobs_from_numpy(node_f32, node_i32, pods_i32,
                             device="cuda") -> ClusterBlobs:
    """The resident cluster blobs on ``device``."""
    return ClusterBlobs(node_f32=_t(np.asarray(node_f32, np.float32), device),
                        node_i32=_t(np.asarray(node_i32, np.int32), device),
                        pods_i32=_t(np.asarray(pods_i32, np.int32), device))


def launch_from_numpy(cblobs: dict, pblobs: dict, gid, rep, *,
                      ptmpl: dict, active, pfields,
                      enable_topology: bool = False, d_cap: int = 0,
                      g_cap: int = 0, topo_soft: bool = False,
                      device="cuda") -> LaunchSpec:
    """A LaunchSpec from numpy arrays: ``cblobs`` maps node_f32 / node_i32
    / pods_i32, ``pblobs`` and ``ptmpl`` map f32 / i32; ``gid``/``rep`` are
    the launch's groups (topology or phase-1) or None. A topology launch
    also carries its domain bucket ``d_cap`` and ``topo_soft``."""
    return LaunchSpec(
        cblobs=cluster_blobs_from_numpy(cblobs["node_f32"],
                                        cblobs["node_i32"],
                                        cblobs["pods_i32"], device),
        pblobs=blobs_from_numpy(pblobs["f32"], pblobs["i32"], device),
        enable_topology=enable_topology, d_cap=int(d_cap),
        active=tuple(active),
        pfields=tuple(pfields),
        ptmpl=blobs_from_numpy(ptmpl["f32"], ptmpl["i32"], device),
        gid=None if gid is None else _t(np.asarray(gid, np.int32), device),
        rep=None if rep is None else _t(np.asarray(rep, np.int32), device),
        g_cap=g_cap, topo_soft=bool(topo_soft))


def preempt_inputs_from_numpy(vic_cumsum=None, vic_cols=None, free=None,
                              table_valid=None, device="cuda") -> dict:
    """The preemption kernels' (K6) extra inputs on ``device``, each one
    given: the victim-prefix cumsum [N, K+1, C] f32 and its column list
    [C] i32 (the sweep), a free-matrix override [N, R] f32 (both) and the
    pod-table mask [PT] bool (the dry run). Absent ones stay None."""
    out = {"vic_cumsum": vic_cumsum, "vic_cols": vic_cols, "free": free,
           "table_valid": table_valid}
    dtypes = {"vic_cumsum": np.float32, "vic_cols": np.int32,
              "free": np.float32, "table_valid": np.bool_}
    return {k: None if v is None else _t(np.asarray(v, dtypes[k]), device)
            for k, v in out.items()}


def weights_from_numpy(w: dict) -> ScoreWeights:
    """ScoreWeights from a {field: scalar} mapping (numpy or Python
    scalars), rounded to float32 like the reference's weights."""
    return ScoreWeights(**{k: float(np.float32(v)) for k, v in w.items()})


def dra_batch_from_numpy(dev_valid, dev_selbits, dev_in_use, req_mask,
                         req_count, req_all, pinned, active,
                         device="cuda") -> DraBatch:
    """A DRA allocator batch (ops/dra.py) on ``device``. The selector
    words (``dev_selbits``, ``req_mask``) may be uint32, as the JAX
    package packs them: their bits are kept, held as int32."""
    def words(a):
        return _t(np.ascontiguousarray(a).astype(np.uint32).view(np.int32),
                  device)

    def of(a, dtype):
        return _t(np.asarray(a, dtype), device)

    return DraBatch(dev_valid=of(dev_valid, np.bool_),
                    dev_selbits=words(dev_selbits),
                    dev_in_use=of(dev_in_use, np.bool_),
                    req_mask=words(req_mask),
                    req_count=of(req_count, np.int32),
                    req_all=of(req_all, np.bool_),
                    pinned=of(pinned, np.int32),
                    active=of(active, np.bool_))


def learned_params(params, device="cuda") -> LearnedParams:
    """The learned scorer's ((W, b), ...) layer stack (numpy arrays, as
    ``np.asarray`` gives the JAX package's) packed on ``device``; refuses
    a stack wider or deeper than the hand kernel holds."""
    return LearnedParams.pack(params, device)
