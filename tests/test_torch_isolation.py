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
    """A gang pod (K7) raises on the CPU as it would on the card, and so
    does a percentageOfNodesToScore window, instead of taking a route the
    reference never takes. A soft-only topology batch (preferred terms
    only), unported before K4, now binds."""
    from kubernetes_tpu_torch.api.objects import (
        LABEL_POD_GROUP,
        Affinity,
        LabelSelector,
        PodAffinity,
        PodAffinityTerm,
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
        hub.create_pod(_pod("gang", labels={LABEL_POD_GROUP: "g"}))
        with pytest.raises(NotImplementedError, match="K7"):
            sched.run_until_idle()
    finally:
        sched.close()
    cfg = default_config()
    cfg.percentage_of_nodes_to_score = 50
    with pytest.raises(NotImplementedError, match="percentageOfNodesToScore"):
        Scheduler(Hub(), cfg, device="cpu")
