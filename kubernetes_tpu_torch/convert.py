"""Carry a packed launch across from numpy arrays.

The scheduler's state is the packed cluster and pod blobs plus the score
weights (there are no trained weights). These helpers build the port's
objects from plain numpy arrays — for example the JAX package's arrays,
which a caller obtains with ``np.asarray`` — so one packed launch can be
fed to both packages. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_tpu_torch.backend.mirror import LaunchSpec
from kubernetes_tpu_torch.models.pipeline import ScoreWeights
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
                      enable_topology: bool = False, g_cap: int = 0,
                      device="cuda") -> LaunchSpec:
    """A LaunchSpec from numpy arrays: ``cblobs`` maps node_f32 / node_i32
    / pods_i32, ``pblobs`` and ``ptmpl`` map f32 / i32; ``gid``/``rep`` are
    the phase-1 groups or None."""
    return LaunchSpec(
        cblobs=cluster_blobs_from_numpy(cblobs["node_f32"],
                                        cblobs["node_i32"],
                                        cblobs["pods_i32"], device),
        pblobs=blobs_from_numpy(pblobs["f32"], pblobs["i32"], device),
        enable_topology=enable_topology, active=tuple(active),
        pfields=tuple(pfields),
        ptmpl=blobs_from_numpy(ptmpl["f32"], ptmpl["i32"], device),
        gid=None if gid is None else _t(np.asarray(gid, np.int32), device),
        rep=None if rep is None else _t(np.asarray(rep, np.int32), device),
        g_cap=g_cap)


def weights_from_numpy(w: dict) -> ScoreWeights:
    """ScoreWeights from a {field: scalar} mapping (numpy or Python
    scalars), rounded to float32 like the reference's weights."""
    return ScoreWeights(**{k: float(np.float32(v)) for k, v in w.items()})
