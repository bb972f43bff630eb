"""Run ONE perf workload of the port and print its result as JSON.

`python -m kubernetes_tpu_torch.perf.run_one <workload_fn> [--scale X]
 [--device cuda|cpu] [--learned CHECKPOINT]`

where <workload_fn> is one of scheduling_basic, topology_spreading,
scheduling_pod_anti_affinity, scheduling_pod_affinity,
preferred_pod_affinity, preferred_pod_anti_affinity,
preferred_topology_spreading, mixed_scheduling_base_pod,
preemption_async, preemption_async_enabled, mixed_churn,
multi_tenant_gang_storm,
quota_exhaustion_churn, gang_preemption, gang_topology_packing,
dra_steady_state, dra_steady_state_templates, dra_steady_state_cel_in,
dra_multi_request.

The device defaults to cuda; the result names the device it ran on.
``--learned`` runs the learned profile (perf/workloads.py
learned_config: LearnedScore at weight 1.0, reading the checkpoint at
that path, polled between batches).
"""

from __future__ import annotations

import json
import sys
import time


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    name = argv[0]
    scale = 1.0
    if "--scale" in argv:
        scale = float(argv[argv.index("--scale") + 1])
    device = "cuda"
    if "--device" in argv:
        device = argv[argv.index("--device") + 1]
    from kubernetes_tpu_torch.perf import workloads as W
    from kubernetes_tpu_torch.perf.harness import run_workload

    config = None
    if "--learned" in argv:
        config = W.learned_config(argv[argv.index("--learned") + 1])
    factory = getattr(W, name)
    t0 = time.time()
    r = run_workload(factory(), scale=scale, device=device, config=config)
    r["run_s"] = round(time.time() - t0, 3)
    if device.startswith("cuda"):
        import torch

        r["device_name"] = torch.cuda.get_device_name(0)
    print(json.dumps(r))


if __name__ == "__main__":
    main()
