"""kubernetes_tpu_torch — the PyTorch/CUDA port of kubernetes_tpu.

The same batched scheduler (Hub -> Scheduler -> Cache/Snapshot -> Mirror
-> one device launch per batch -> commit/bind) with the device programs
written by hand for NVIDIA Hopper (csrc/*.cu, bound with ctypes in
kernels/) and a plain-torch twin beside each kernel. It imports torch and
numpy, never jax and nothing of kubernetes_tpu. Entry points run on the
card (device="cuda") unless the caller asks for the CPU, where the twins
run.

Layer map:

    kubernetes_tpu_torch.api        — object model, quantities, labels
    kubernetes_tpu_torch.utils      — interner, quantity parsing, tracing
                                      (the flight recorder, export v3)
    kubernetes_tpu_torch.backend    — cache, snapshot, node_tree, queue, heap, mirror
    kubernetes_tpu_torch.framework  — extension points, CycleState, runtime
    kubernetes_tpu_torch.plugins    — plugin registry + queueing hints
    kubernetes_tpu_torch.ops        — blob schema + the filter/score twins
    kubernetes_tpu_torch.kernels    — kernel build, wrappers and twins
    kubernetes_tpu_torch.models     — the batched scheduling pipeline
    kubernetes_tpu_torch.scheduler  — event handlers + scheduling loop
    kubernetes_tpu_torch.hub        — in-process API hub
    kubernetes_tpu_torch.metrics    — counters, gauges, histograms
    kubernetes_tpu_torch.learn      — the learned scorer's checkpoints,
                                      replay, trainer (K10), regret, loop
    kubernetes_tpu_torch.perf       — workload harness (run_one), A/B
"""

__version__ = "0.1.0"
