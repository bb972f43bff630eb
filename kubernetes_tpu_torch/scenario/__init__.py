"""The scenario engine (port of the JAX package's scenario/): so far only
``lifecycle``, the one node add / remove / cordon / uncordon code path that
the perf harness's Churn op uses. The trace format, its generators, the
replayer and the fuzzer are ROADMAP queue 1 item 9."""

from kubernetes_tpu_torch.scenario.lifecycle import NodeLifecycle

__all__ = ["NodeLifecycle"]
