"""Shared helpers of the tests/test_torch_*.py modules: carry objects and
arrays from the JAX package to its PyTorch port.

``to_port`` rebuilds a JAX-package api dataclass, recursively, as the
port's class of the same name (uids and names preserved), so one cluster
can be fed to both packages.

Importing this module caps torch's intra-op and inter-op thread pools at
one sixth of the cores: the suite runs on six pytest-xdist workers, and
uncapped each worker's pools take every core, so the workers
oversubscribe the machine (six workers of eight threads on eight cores)
and starve the tests that time a wall-clock replay beside them. Every
tests/test_torch_*.py module imports it.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

_THREADS = max(1, (os.cpu_count() or 1) // 6)
torch.set_num_threads(_THREADS)
try:
    torch.set_num_interop_threads(_THREADS)
except RuntimeError:
    pass    # inter-op work already started in this process: keep its pool

import kubernetes_tpu_torch.api.objects as port_objects
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.ops.features import Capacities as TCaps


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


def port_spec(spec):
    """A JAX launch (Mirror.prepare_launch's LaunchSpec), its arrays handed
    to the port as numpy, on the CPU."""
    a = np.asarray
    return convert.launch_from_numpy(
        {"node_f32": a(spec.cblobs.node_f32),
         "node_i32": a(spec.cblobs.node_i32),
         "pods_i32": a(spec.cblobs.pods_i32)},
        {"f32": a(spec.pblobs.f32), "i32": a(spec.pblobs.i32)},
        None if spec.gid is None else a(spec.gid),
        None if spec.rep is None else a(spec.rep),
        ptmpl={"f32": a(spec.ptmpl.f32), "i32": a(spec.ptmpl.i32)},
        active=spec.active, pfields=spec.pfields,
        enable_topology=spec.enable_topology, d_cap=spec.d_cap,
        g_cap=spec.g_cap, topo_soft=spec.topo_soft, device="cpu")


def port_caps(caps):
    """The port's Capacities equal to a JAX package Capacities."""
    return TCaps(**{f: getattr(caps, f) for f in caps.__dataclass_fields__})


def fuzz_cluster(rng, n_nodes: int, n_pods: int, n_bound: int = 0,
                 ports: bool = True):
    """The port's seeded fuzz cluster (kubernetes_tpu_torch.perf.fuzz) as
    JAX-package objects."""
    import kubernetes_tpu.api.objects as jax_objects
    from kubernetes_tpu_torch.perf.fuzz import fuzz_cluster as build

    return build(rng, n_nodes, n_pods, n_bound, ports, objects=jax_objects)


def apply_vanished_retry(sched):
    """The port's stated DRA deviation (ROADMAP queue 3), applied to a JAX
    package Scheduler instance for an exact comparison: a pod whose
    DynamicResources Reserve rejects it after a same-batch device race
    ("devices vanished") retries after backoff instead of parking in the
    unschedulable pool (where no event wakes it). Patches this instance
    only; the package's files are untouched."""
    orig = sched._undo_commit
    q = sched.queue

    def to_backoff(qp, *_args, **_kw):
        q._in_flight.pop(qp.uid, None)
        qp.timestamp = q._now()
        q._trim_events()
        if not q.is_parked(qp.uid):
            q._requeue(qp)

    def undo(qp, state, assumed, node_name, msg, rejected_by="",
             park_unreachable=False):
        if rejected_by == "DynamicResources" and msg.startswith("reserve:"):
            q.add_unschedulable_if_not_present = to_backoff
            try:
                return orig(qp, state, assumed, node_name, msg, rejected_by,
                            park_unreachable)
            finally:
                del q.add_unschedulable_if_not_present
        return orig(qp, state, assumed, node_name, msg, rejected_by,
                    park_unreachable)

    sched._undo_commit = undo
    return sched
