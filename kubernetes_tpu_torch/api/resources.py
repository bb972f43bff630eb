"""Resource vectors and pod resource-request aggregation.

Host-side equivalent of ``framework.Resource``
(kubernetes/pkg/scheduler/framework/types.go:846) and
``computePodResourceRequest``
(kubernetes/pkg/scheduler/framework/plugins/noderesources/fit.go:219):
pod request = max(sum(app containers), max(init containers)) + overhead,
with restartable (sidecar) init containers added to the running sum.

``NonZeroRequest`` mirrors types.go:799-803: containers with no cpu/memory
request count as 100m CPU / 200Mi memory for *scoring* (never for fit).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kubernetes_tpu_torch.api.objects import Container, Pod
from kubernetes_tpu_torch.utils.quantity import parse_bytes, parse_cpu_milli, parse_int

CPU = "cpu"
MEMORY = "memory"
EPHEMERAL_STORAGE = "ephemeral-storage"
PODS = "pods"

# scoring defaults for request-less containers (types.go DefaultMilliCPURequest /
# DefaultMemoryRequest)
DEFAULT_MILLI_CPU_REQUEST = 100
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024


def _is_native(name: str) -> bool:
    return name in (CPU, MEMORY, EPHEMERAL_STORAGE, PODS)


@dataclass
class Resource:
    """Dense resource vector: native columns + sparse scalar (extended) resources."""

    milli_cpu: int = 0
    memory: int = 0
    ephemeral_storage: int = 0
    allowed_pod_number: int = 0
    scalar: dict[str, int] = field(default_factory=dict)

    @classmethod
    def from_map(cls, m: dict[str, str]) -> "Resource":
        r = cls()
        for name, q in m.items():
            if name == CPU:
                r.milli_cpu = parse_cpu_milli(q)
            elif name == MEMORY:
                r.memory = parse_bytes(q)
            elif name == EPHEMERAL_STORAGE:
                r.ephemeral_storage = parse_bytes(q)
            elif name == PODS:
                r.allowed_pod_number = parse_int(q)
            else:
                r.scalar[name] = parse_int(q)
        return r

    def add(self, other: "Resource") -> None:
        self.milli_cpu += other.milli_cpu
        self.memory += other.memory
        self.ephemeral_storage += other.ephemeral_storage
        for k, v in other.scalar.items():
            self.scalar[k] = self.scalar.get(k, 0) + v

    def sub(self, other: "Resource") -> None:
        self.milli_cpu -= other.milli_cpu
        self.memory -= other.memory
        self.ephemeral_storage -= other.ephemeral_storage
        for k, v in other.scalar.items():
            self.scalar[k] = self.scalar.get(k, 0) - v

    def set_max(self, other: "Resource") -> None:
        self.milli_cpu = max(self.milli_cpu, other.milli_cpu)
        self.memory = max(self.memory, other.memory)
        self.ephemeral_storage = max(self.ephemeral_storage, other.ephemeral_storage)
        for k, v in other.scalar.items():
            self.scalar[k] = max(self.scalar.get(k, 0), v)

    def clone(self) -> "Resource":
        return Resource(self.milli_cpu, self.memory, self.ephemeral_storage,
                        self.allowed_pod_number, dict(self.scalar))

    def is_zero(self) -> bool:
        return (self.milli_cpu == 0 and self.memory == 0
                and self.ephemeral_storage == 0
                and not any(self.scalar.values()))


def _container_request(c: Container, non_zero: bool = False) -> Resource:
    r = Resource.from_map(c.resources.requests)
    if non_zero:
        if CPU not in c.resources.requests:
            r.milli_cpu = DEFAULT_MILLI_CPU_REQUEST
        if MEMORY not in c.resources.requests:
            r.memory = DEFAULT_MEMORY_REQUEST
    return r


def pod_request(pod: Pod, *, non_zero: bool = False) -> Resource:
    """Aggregate pod resource request (fit.go:219 computePodResourceRequest).

    With ``non_zero=True``, cpu/memory of request-less containers default to
    100m / 200Mi — the scoring-path semantics of NonZeroRequested.

    The result is memoized on the pod object (specs are treated as immutable
    by the hub/cache copy-on-write contract, api.objects module docstring);
    callers must NOT mutate the returned Resource. Quantity-string parsing
    otherwise dominates the per-pod host cost of the scheduling hot path.
    """
    cache = pod.__dict__.get("_request_memo")
    if cache is None:
        cache = pod._request_memo = [None, None]
    memo = cache[1 if non_zero else 0]
    if memo is not None:
        return memo
    total = Resource()
    for c in pod.spec.containers:
        total.add(_container_request(c, non_zero))

    # restartable (sidecar) init containers accumulate; regular init containers
    # impose a running max over (their own request + accumulated sidecars).
    sidecar_sum = Resource()
    init_max = Resource()
    for c in pod.spec.init_containers:
        r = _container_request(c, non_zero)
        if c.restart_policy == "Always":
            sidecar_sum.add(r)
            init_max.set_max(sidecar_sum)
        else:
            peak = sidecar_sum.clone()
            peak.add(r)
            init_max.set_max(peak)
    total.add(sidecar_sum)
    # max(sum-of-app+sidecars, peak-init)
    total.set_max(init_max)

    if pod.spec.overhead:
        total.add(Resource.from_map(pod.spec.overhead))
    cache[1 if non_zero else 0] = total
    return total
