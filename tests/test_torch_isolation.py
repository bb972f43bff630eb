"""The port stands alone: no file of kubernetes_tpu_torch/ (nor
chip_smoke.py) imports jax, jaxlib or kubernetes_tpu; the whole package
imports with those modules blocked; and the entry points default to the
card, raising on a machine without one instead of running on the CPU."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tests.torch_port_support  # noqa: F401 — caps torch's threads

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "kubernetes_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "kubernetes_tpu")


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    bad = [(str(p.relative_to(ROOT)), m) for p in _sources()
           for m in _imported(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_scan_reaches_the_preemption_modules():
    """The scans above cover the preemption slice: its twins, kernels'
    wrappers and sources, and the Evaluator."""
    scanned = {str(p.relative_to(ROOT)) for p in _sources()}
    for mod in ("ops/preempt.py", "kernels/preempt.py",
                "framework/preemption.py"):
        assert f"kubernetes_tpu_torch/{mod}" in scanned, mod
    for src in ("preempt_sweep.cu", "preempt_feasible.cu"):
        text = (PKG / "csrc" / src).read_text()
        assert "#include <torch" not in text and "jax" not in text, src


def test_scan_reaches_the_gang_modules():
    """The scans above cover the gang slice: the job queue, the wait
    room, the plugin, the twins, the kernels' wrappers and sources."""
    scanned = {str(p.relative_to(ROOT)) for p in _sources()}
    for mod in ("backend/jobqueue.py", "framework/waiting.py",
                "plugins/gang.py", "ops/gang.py", "kernels/gang.py"):
        assert f"kubernetes_tpu_torch/{mod}" in scanned, mod
    for src in ("gang_pack.cu", "gang_capacity.cu"):
        text = (PKG / "csrc" / src).read_text()
        assert "#include <torch" not in text and "jax" not in text, src


def test_scan_reaches_the_dra_modules():
    """The scans above cover the DRA slice: the CEL evaluator, the plugin,
    the twin, the kernel's wrapper and source."""
    scanned = {str(p.relative_to(ROOT)) for p in _sources()}
    for mod in ("utils/cel.py", "plugins/dra.py", "ops/dra.py",
                "kernels/dra.py"):
        assert f"kubernetes_tpu_torch/{mod}" in scanned, mod
    text = (PKG / "csrc" / "dra_feasible.cu").read_text()
    assert "#include <torch" not in text and "jax" not in text


def test_package_imports_with_jax_and_the_jax_package_blocked():
    mods = sorted(
        "kubernetes_tpu_torch." + str(p.relative_to(PKG).with_suffix(""))
        .replace(os.sep, ".").removesuffix(".__init__")
        for p in PKG.rglob("*.py"))
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'kubernetes_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m.removesuffix('.__init__'))\n"
            "print('imported', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


def test_scheduler_defaults_to_the_card():
    _no_card()
    from kubernetes_tpu_torch.hub import Hub
    from kubernetes_tpu_torch.scheduler import Scheduler

    with pytest.raises(RuntimeError, match="CUDA"):
        Scheduler(Hub())


def test_run_workload_defaults_to_the_card():
    _no_card()
    from kubernetes_tpu_torch.perf.harness import run_workload
    from kubernetes_tpu_torch.perf.workloads import scheduling_basic

    with pytest.raises(RuntimeError, match="CUDA"):
        run_workload(scheduling_basic(), scale=0.001)


def test_mirror_and_launch_default_to_the_card():
    _no_card()
    from kubernetes_tpu_torch.backend.mirror import Mirror
    from kubernetes_tpu_torch.ops.features import Capacities

    mirror = Mirror(caps=Capacities(nodes=8, pods=8))
    assert mirror.device.type == "cuda"
    with pytest.raises((RuntimeError, AssertionError)):
        mirror.to_blobs()


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line when run
    alone in a directory, on a machine without a card."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_unported_batches_raise_naming_their_roadmap_item():
    """A pod with volumes (ROADMAP item 7) raises on the CPU as it would on
    the card, instead of taking a route the reference never takes. A
    soft-only topology batch (preferred terms only), unported before K4,
    now binds, and so does a gang pod (its PodGroup of one arrives first),
    unported before K7, a pod with a resource claim, unported before K8,
    and a pod under a percentageOfNodesToScore window, unported before
    K3's window."""
    from kubernetes_tpu_torch.api.objects import (
        LABEL_POD_GROUP,
        Affinity,
        Device,
        DeviceRequest,
        LabelSelector,
        ObjectMeta,
        PodAffinity,
        PodAffinityTerm,
        PodGroup,
        PodResourceClaim,
        ResourceClaim,
        ResourceClaimSpec,
        ResourceSlice,
        Volume,
        WeightedPodAffinityTerm,
    )
    from kubernetes_tpu_torch.config.types import default_config
    from kubernetes_tpu_torch.hub import Hub
    from kubernetes_tpu_torch.ops.features import Capacities
    from kubernetes_tpu_torch.perf.workloads import _node, _pod
    from kubernetes_tpu_torch.scheduler import Scheduler

    hub = Hub()
    sched = Scheduler(hub, caps=Capacities(nodes=8, pods=64), device="cpu")
    try:
        for i in range(4):
            hub.create_node(_node(i))
        term = PodAffinityTerm(topology_key="kubernetes.io/hostname",
                               label_selector=LabelSelector(
                                   match_labels={"app": "x"}))
        soft = _pod("soft", affinity=Affinity(
            pod_affinity=PodAffinity(preferred=[WeightedPodAffinityTerm(
                weight=10, pod_affinity_term=term)])))
        hub.create_pod(soft)
        sched.run_until_idle()
        assert hub.get_pod(soft.metadata.uid).spec.node_name
        hub.create_pod_group(PodGroup(metadata=ObjectMeta(name="g"),
                                      min_member=1))
        gang = _pod("gang", labels={LABEL_POD_GROUP: "g"})
        hub.create_pod(gang)
        sched.run_until_idle()
        assert hub.get_pod(gang.metadata.uid).spec.node_name
        hub.create_resource_slice(ResourceSlice(
            metadata=ObjectMeta(name="s"), node_name="node-2",
            driver="gpu.example.com", pool="p",
            devices=[Device(name="d0", device_class_name="gpu")]))
        hub.create_resource_claim(ResourceClaim(
            metadata=ObjectMeta(name="c"), spec=ResourceClaimSpec(
                device_requests=[DeviceRequest(name="r",
                                               device_class_name="gpu")])))
        dra = _pod("dra")
        dra.spec.resource_claims = [PodResourceClaim(
            name="c", resource_claim_name="c")]
        hub.create_pod(dra)
        sched.run_until_idle()
        assert hub.get_pod(dra.metadata.uid).spec.node_name == "node-2"
        vol = _pod("vol")
        vol.spec.volumes = [Volume(name="v")]
        hub.create_pod(vol)
        with pytest.raises(NotImplementedError, match="item 7"):
            sched.run_until_idle()
    finally:
        sched.close()
    cfg = default_config()
    cfg.percentage_of_nodes_to_score = 50
    hub = Hub()
    sched = Scheduler(hub, cfg, caps=Capacities(nodes=8, pods=64),
                      device="cpu")
    try:
        for i in range(4):
            hub.create_node(_node(i))
        pct = _pod("pct")
        hub.create_pod(pct)
        sched.run_until_idle()
        assert hub.get_pod(pct.metadata.uid).spec.node_name
    finally:
        sched.close()
