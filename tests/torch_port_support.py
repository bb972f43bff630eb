"""Shared helpers of the tests/test_torch_*.py modules: carry objects and
arrays from the JAX package to its PyTorch port.

``to_port`` rebuilds a JAX-package api dataclass, recursively, as the
port's class of the same name (uids and names preserved), so one cluster
can be fed to both packages.
"""

from __future__ import annotations

import dataclasses

import kubernetes_tpu_torch.api.objects as port_objects


def to_port(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(port_objects, type(obj).__name__)
        init = {f.name: to_port(getattr(obj, f.name))
                for f in dataclasses.fields(obj) if f.init}
        new = cls(**init)
        for f in dataclasses.fields(obj):
            if not f.init:
                setattr(new, f.name, to_port(getattr(obj, f.name)))
        return new
    if isinstance(obj, list):
        return [to_port(x) for x in obj]
    if isinstance(obj, tuple):
        return tuple(to_port(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_port(v) for k, v in obj.items()}
    return obj



def fuzz_cluster(rng, n_nodes: int, n_pods: int, n_bound: int = 0,
                 ports: bool = True):
    """The port's seeded fuzz cluster (kubernetes_tpu_torch.perf.fuzz) as
    JAX-package objects."""
    import kubernetes_tpu.api.objects as jax_objects
    from kubernetes_tpu_torch.perf.fuzz import fuzz_cluster as build

    return build(rng, n_nodes, n_pods, n_bound, ports, objects=jax_objects)
