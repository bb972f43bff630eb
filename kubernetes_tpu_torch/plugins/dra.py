"""DynamicResources: the DRA scheduler plugin (port of the JAX package's
plugins/dra.py).

From-scratch equivalent of the reference's accelerator-scheduling path
(plugins/dynamicresources/dynamicresources.go:105-888 + the structured
allocator under staging/src/k8s.io/dynamic-resource-allocation): pods
reference ResourceClaims; DRA drivers publish per-node device inventories
as ResourceSlices; the plugin

- PreFilter: resolve the pod's claims — direct names or per-pod claims
  generated from ResourceClaimTemplates (pod.status.resourceClaimStatuses
  written by the ResourceClaimController below) — missing claim =>
  unresolvable; no claims => Skip; build the free-device view per node
  from the incremental allocated-device ledger + the assume overlay,
- Filter: a node fits iff every unallocated claim can be ALLOCATED from
  that node's remaining devices (structured parameters: per-request CEL
  selectors + DeviceClass selectors, ExactCount/All modes, firstAvailable
  alternatives, adminAccess, matchAttribute constraints), and every
  already-allocated claim is pinned to its allocation's node.

  The HOT PATH of that verdict now runs on device: DeviceAllocatorView
  mirrors the slice inventory into dense tensors with precompiled CEL
  verdict bitmasks, and the scheduler fuses claim feasibility for the
  whole batch into the Filter/Score launch (kernel K8, kernels/dra.py;
  its twin ops/dra.py). Pods routed
  that way skip this plugin's host Filter (applies() -> False); pods
  whose claims fall outside the device-expressible subset — constraints,
  firstAvailable, adminAccess, unparseable selectors — keep the host
  path below, which is also the wholesale fallback when a device launch
  faults. The serial allocator remains the single source of truth at
  Reserve/PreBind (commit-time bookkeeping), so device and host picks
  can never diverge on what reaches the API,
- Reserve: run the same allocator on the chosen node and ASSUME the
  allocation (assume overlay — the scheduler-side AssumeCache the
  reference keeps for claims), Unreserve reverts,
- PreBind: write the allocation + reservedFor to the API (hub).

Restart safety is API-truth-based like everything else in this build: a
restarted scheduler rebuilds its view from claim statuses, so allocations
survive replay and allocated devices never double-book.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from kubernetes_tpu_torch.api.objects import (
    ALLOCATION_MODE_ALL,
    ALLOCATION_MODE_EXACT,
    AllocationResult,
    DeviceAllocationResult,
    ObjectMeta,
    Pod,
    ResourceClaim,
)
from kubernetes_tpu_torch.hub import Unavailable
from kubernetes_tpu_torch.framework.interface import (
    FilterPlugin,
    PreBindPlugin,
    PreFilterPlugin,
    ReservePlugin,
    Status,
)
from kubernetes_tpu_torch.ops.dra import (
    MAX_SELECTORS,
    PIN_ANY,
    PIN_NONE,
    SELBIT_WORDS,
    DraBatch,
)
from kubernetes_tpu_torch.utils.cel import CelDevice, CelError, evaluate
from kubernetes_tpu_torch.utils.cel import _parse as _cel_parse


def claim_name_for(pod: Pod, ref) -> str:
    """Resolve a pod.spec.resourceClaims entry to a claim NAME: direct
    reference, or the controller-generated name for a template reference
    (pod.status.resourceClaimStatuses, falling back to the deterministic
    '<pod>-<ref>' convention the controller uses)."""
    if ref.resource_claim_name:
        return ref.resource_claim_name
    if ref.resource_claim_template_name:
        return (pod.status.resource_claim_statuses.get(ref.name)
                or f"{pod.metadata.name}-{ref.name}")
    return ref.name


def dra_serial_keys(hub, pod: Pod) -> set[str]:
    """Host-serial conflict domains: two pods referencing the SAME claim
    must not share a batch (the first one's assume — allocation or
    reservedFor append — changes what the second must see).

    Pods with DISTINCT claims deliberately DO share batches even when
    their claims compete for one device class: reserve() re-walks the
    free-device view through the assume overlay sequentially at commit
    time and fails cleanly ("devices vanished") into the requeue path, so
    a same-batch capacity race costs one retry, never a double-booking.
    Serializing per device class instead was measured at ~50x throughput
    loss (one claim pod per launch) on DRA steady-state."""
    keys: set[str] = set()
    for ref in pod.spec.resource_claims:
        claim = hub.get_resource_claim(pod.metadata.namespace,
                                       claim_name_for(pod, ref))
        if claim is None:
            continue
        keys.add(f"draclaim:{claim.key()}")
    return keys


def release_pod_claims(hub, pod: Pod) -> None:
    """The slice of the reference's resourceclaim controller the scheduler
    build needs: a deleted pod leaves its claims' reservedFor. The
    ALLOCATION persists — a standalone claim owns its devices until the
    claim itself is deleted (that is how users hand a device from pod to
    pod); freeing capacity means deleting the claim, whose event requeues
    waiting DRA pods."""
    for ref in pod.spec.resource_claims:
        claim = hub.get_resource_claim(pod.metadata.namespace,
                                       claim_name_for(pod, ref))
        if claim is None \
                or pod.metadata.uid not in claim.status.reserved_for:
            continue
        new = claim.clone()
        new.status.reserved_for.remove(pod.metadata.uid)
        hub.update_resource_claim(new)


class ResourceClaimController:
    """The resourceclaim controller slice this build needs (the reference
    runs the full version in kube-controller-manager,
    pkg/controller/resourceclaim): watches pods, stamps a per-pod
    ResourceClaim out of each referenced ResourceClaimTemplate under the
    deterministic name '<pod>-<ref>', records the generated names in
    pod.status.resourceClaimStatuses, and deletes the owned claims when
    the pod goes away (template-generated claims die with their pod;
    directly-referenced claims persist)."""

    def __init__(self, hub):
        from kubernetes_tpu_torch.hub import EventHandlers

        self.hub = hub
        # pods-by-template index: (namespace, template name) -> {uid: Pod}.
        # Template stamping is O(changes): a template arriving re-stamps
        # only the pods that reference it, never the whole cluster (the
        # old `for pod in hub.list_pods()` scan was O(cluster) per
        # template event). The lock covers hub dispatch threads racing
        # pod adds against template adds.
        self._index_lock = threading.Lock()
        self._tmpl_index: dict[tuple[str, str], dict[str, Pod]] = {}
        hub.watch_pods(EventHandlers(on_add=self._on_pod_add,
                                     on_delete=self._on_pod_delete))
        # a pod can reference a template created AFTER it (the reference
        # controller retries via its workqueue): re-stamp waiting pods
        # when their template appears
        hub.watch_resource_claim_templates(EventHandlers(
            on_add=self._on_template_add))

    def _index_pod(self, pod: Pod) -> None:
        with self._index_lock:
            for ref in pod.spec.resource_claims:
                if ref.resource_claim_template_name:
                    key = (pod.metadata.namespace,
                           ref.resource_claim_template_name)
                    self._tmpl_index.setdefault(key, {})[
                        pod.metadata.uid] = pod

    def _unindex_pod(self, pod: Pod) -> None:
        with self._index_lock:
            for ref in pod.spec.resource_claims:
                if ref.resource_claim_template_name:
                    key = (pod.metadata.namespace,
                           ref.resource_claim_template_name)
                    waiting = self._tmpl_index.get(key)
                    if waiting is not None:
                        waiting.pop(pod.metadata.uid, None)
                        if not waiting:
                            del self._tmpl_index[key]

    def _on_template_add(self, tmpl) -> None:
        key = (tmpl.metadata.namespace, tmpl.metadata.name)
        with self._index_lock:
            waiting = list(self._tmpl_index.get(key, {}).values())
        for pod in waiting:
            self._stamp(pod)

    def _on_pod_add(self, pod: Pod) -> None:
        self._index_pod(pod)
        self._stamp(pod)

    def _stamp(self, pod: Pod) -> None:
        import copy

        statuses: dict[str, str] = {}
        for ref in pod.spec.resource_claims:
            if not ref.resource_claim_template_name:
                continue
            name = f"{pod.metadata.name}-{ref.name}"
            tmpl = self.hub.get_resource_claim_template(
                pod.metadata.namespace, ref.resource_claim_template_name)
            if tmpl is None:
                continue    # the template watch re-stamps on its arrival
            if self.hub.get_resource_claim(pod.metadata.namespace,
                                           name) is None:
                self.hub.create_resource_claim(ResourceClaim(
                    metadata=ObjectMeta(name=name,
                                        namespace=pod.metadata.namespace),
                    spec=copy.deepcopy(tmpl.spec)))
            statuses[ref.name] = name
        if statuses and pod.status.resource_claim_statuses != statuses:
            self.hub.set_pod_claim_statuses(pod.metadata.uid, statuses)

    def _on_pod_delete(self, pod: Pod) -> None:
        self._unindex_pod(pod)
        for ref in pod.spec.resource_claims:
            if not ref.resource_claim_template_name:
                continue
            name = (pod.status.resource_claim_statuses.get(ref.name)
                    or f"{pod.metadata.name}-{ref.name}")
            claim = self.hub.get_resource_claim(pod.metadata.namespace,
                                                name)
            if claim is not None:
                self.hub.delete_resource_claim(claim.metadata.uid)


class DeviceAllocatorView:
    """Dense device-inventory mirror + precompiled CEL selector masks:
    the host half of the batched device allocator (ops/dra.py).

    What it keeps, and when it pays:

    - a per-node device table derived from the plugin's slice ledger
      (``_node_bits``): per device, one uint32[SELBIT_WORDS] verdict
      bitmask over every registered selector. Recomputed only for DIRTY
      nodes (slice add/remove) or when a NEW selector registers — the
      steady state does zero CEL evaluation per cycle;
    - the selector registry (``_sel_bit``): expression -> bit. Entries
      are ("cel", expression) for CEL selectors and ("class", name) for
      the legacy direct device_class_name match. Selectors register
      lazily the first time a claim referencing them is packed —
      effectively at watch time, since claims/classes arrive by watch.
      A selector that fails to PARSE routes its claims to the host path
      (and surfaces the same CELSelectorError Event the host path
      records); per-device evaluation errors count as no-match with the
      Event preserved, exactly like the host's _selector_accepts;
    - the resident [N, D] / [N, D, W] device arrays pushed to HBM,
      re-assembled only when a node's bits, the mirror's row assignment,
      or the node capacity changed; the [N, D] in-use mask re-packs per
      cycle from the allocated-device ledger + the assume overlay.

    Thread model: build() runs on the scheduling-loop thread;
    invalidate_node() may arrive from hub dispatch threads. ``_lock``
    (the view's own) orders them; plugin._ledger_lock is only ever taken
    INSIDE it (view -> ledger), never the other way around.
    """

    MAX_REQS = 32        # flattened requests per pod beyond -> host path

    def __init__(self, plugin: "DynamicResources"):
        self.plugin = plugin
        self._lock = threading.Lock()
        self._sel_bit: dict[tuple, int] = {}
        self._sel_bad: set[tuple] = set()        # unparseable expressions
        self._eval_err: dict[tuple, Exception] = {}  # first eval error
        # node -> (entries, bits[d, W]); entries mirror _devices_on(node)
        self._node_bits: dict[str, tuple[list, np.ndarray]] = {}
        self._dirty: set[str] = set()            # nodes needing rebits
        self._triple_loc: dict[tuple, tuple[str, int]] = {}
        self._node_triples: dict[str, list[tuple]] = {}
        self._row_cache: dict[str, int] = {}     # node -> last packed row
        self._d_cap = 8                          # pow2 device bucket
        self._push: Optional[tuple] = None       # (valid, selbits) torch
        self._push_n_cap = 0
        self.stats = {"selectors_compiled": 0, "host_fallback_pods": 0,
                      "device_pods": 0, "inventory_rebuilds": 0}

    # ------------- slice-watch maintenance -------------

    def invalidate_node(self, node_name: str) -> None:
        """A ResourceSlice on ``node_name`` changed: its verdict bits and
        slot map are stale. Called by the plugin's slice handlers AFTER
        they release the ledger lock."""
        with self._lock:
            self._dirty.add(node_name)
            self._push = None

    # ------------- selector registry -------------

    def _bit_for(self, key: tuple, source: tuple[str, str]
                 ) -> Optional[int]:
        """Bit index for one selector key, registering it (and dirtying
        every node's verdict table) on first sight. None = outside the
        compilable subset (parse failure or registry full) — the caller
        routes the claim to the host path."""
        if key in self._sel_bad:
            # surface the parse error for THIS source too (the plugin
            # dedups per (source, expression), like the host path)
            self.plugin._record_cel_error(
                source, key[1], self._eval_err.get(
                    key, CelError("unparseable selector")))
            return None
        bit = self._sel_bit.get(key)
        if bit is None:
            if len(self._sel_bit) >= MAX_SELECTORS:
                return None
            if key[0] == "cel":
                try:
                    _cel_parse(key[1])
                except CelError as e:
                    self._sel_bad.add(key)
                    self._eval_err[key] = e
                    self.plugin._record_cel_error(source, key[1], e)
                    return None
            bit = self._sel_bit[key] = len(self._sel_bit)
            self.stats["selectors_compiled"] += 1
            self._dirty.update(self._node_bits)
            self._push = None
        err = self._eval_err.get(key)
        if err is not None:
            # an expression that errored on some device: every source
            # referencing it gets its own (deduped) Event, host-parity
            self.plugin._record_cel_error(source, key[1], err)
        return bit

    def _verdict(self, key: tuple, driver: str, dev) -> bool:
        """One selector against one device — the precompile-time analog
        of the host _selector_accepts (same evaluate(), same CelError =
        no-match semantics; the Event is recorded once per expression
        here and re-attributed per source by _bit_for)."""
        if key[0] == "class":
            return dev.device_class_name == key[1]
        try:
            return evaluate(key[1],
                            CelDevice(driver, dev.attributes, dev.capacity))
        except CelError as e:
            self._eval_err.setdefault(key, e)
            return False

    # ------------- inventory tensors -------------

    def _rebuild_node(self, node: str) -> None:
        entries = self.plugin._devices_on(node)
        for t in self._node_triples.pop(node, ()):
            self._triple_loc.pop(t, None)
        if not entries:
            self._node_bits.pop(node, None)
            self._row_cache.pop(node, None)
            return
        while len(entries) > self._d_cap:
            self._d_cap *= 2
        bits = np.zeros((len(entries), SELBIT_WORDS), np.uint32)
        for key, bit in self._sel_bit.items():
            w, m = bit // 32, np.uint32(1 << (bit % 32))
            for di, (drv, _pool, dev) in enumerate(entries):
                if self._verdict(key, drv, dev):
                    bits[di, w] |= m
        self._node_bits[node] = (entries, bits)
        triples = [(drv, pool, dev.name)
                   for (drv, pool, dev) in entries]
        self._node_triples[node] = triples
        for slot, t in enumerate(triples):
            self._triple_loc[t] = (node, slot)

    def _ensure_inventory(self, row_of: Callable[[str], int], n_cap: int,
                          device: torch.device) -> tuple:
        """Refresh dirty nodes' verdict bits and (if anything moved)
        re-assemble + re-push the resident [N, D(, W)] tensors to
        ``device``."""
        for node in sorted(self._dirty):
            self._rebuild_node(node)
        self._dirty.clear()
        moved = any(row_of(node) != self._row_cache.get(node, -3)
                    for node in self._node_bits)
        if self._push is not None and not moved \
                and self._push_n_cap == n_cap \
                and self._push[0].device == device:
            return self._push
        self.stats["inventory_rebuilds"] += 1
        valid = np.zeros((n_cap, self._d_cap), bool)
        selbits = np.zeros((n_cap, self._d_cap, SELBIT_WORDS), np.uint32)
        for node, (entries, bits) in self._node_bits.items():
            row = row_of(node)
            self._row_cache[node] = row
            if row < 0 or row >= n_cap:
                continue
            k = len(entries)
            valid[row, :k] = True
            selbits[row, :k] = bits
        self._push = (torch.from_numpy(valid).to(device),
                      torch.from_numpy(selbits.view(np.int32)).to(device))
        self._push_n_cap = n_cap
        return self._push

    def _in_use_array(self, n_cap: int) -> np.ndarray:
        """[N, D] bool from the allocated-device ledger + assume overlay
        (the batch-start view every pod's host pre_filter used to
        compute; same-batch capacity races resolve at Reserve exactly as
        before)."""
        arr = np.zeros((n_cap, self._d_cap), bool)
        for t in self.plugin._in_use_view(set()):
            loc = self._triple_loc.get(t)
            if loc is None:
                continue
            row = self._row_cache.get(loc[0], -1)
            if 0 <= row < n_cap:
                arr[row, loc[1]] = True
        return arr

    # ------------- claim compilation -------------

    def _claim_reqs(self, claim: ResourceClaim
                    ) -> Optional[list[tuple[np.ndarray, int, bool]]]:
        """Flatten one unallocated claim into (mask words, count, all)
        request rows, or None when the claim is outside the
        device-expressible subset (constraints, firstAvailable,
        adminAccess, non-positive counts, uncompilable selectors)."""
        if claim.spec.constraints:
            return None
        out = []
        for req in claim.spec.device_requests:
            if req.first_available or getattr(req, "admin_access", False):
                return None
            if req.allocation_mode not in (ALLOCATION_MODE_EXACT,
                                           ALLOCATION_MODE_ALL):
                return None
            if req.allocation_mode == ALLOCATION_MODE_EXACT \
                    and req.count <= 0:
                return None
            bits: list[int] = []
            if req.device_class_name:
                dc = self.plugin.hub.get_device_class(req.device_class_name)
                if dc is None:
                    b = self._bit_for(("class", req.device_class_name),
                                      ("DeviceClass", req.device_class_name))
                    if b is None:
                        return None
                    bits.append(b)
                else:
                    for sel in dc.selectors:
                        b = self._bit_for(
                            ("cel", sel.cel_expression),
                            ("DeviceClass", req.device_class_name))
                        if b is None:
                            return None
                        bits.append(b)
            for sel in req.selectors:
                b = self._bit_for(("cel", sel.cel_expression),
                                  ("ResourceClaim", claim.key()))
                if b is None:
                    return None
                bits.append(b)
            words = np.zeros((SELBIT_WORDS,), np.uint32)
            for b in bits:
                words[b // 32] |= np.uint32(1 << (b % 32))
            is_all = req.allocation_mode == ALLOCATION_MODE_ALL
            out.append((words, 0 if is_all else req.count, is_all))
        return out

    def _pod_item(self, pod: Pod, row_of: Callable[[str], int]
                  ) -> Optional[tuple[list, int]]:
        """(flattened request rows, pinned row) for one pod, or None when
        any claim is missing or inexpressible (host path)."""
        pinned = PIN_ANY
        reqs: list = []
        for _ref, claim in self.plugin._pod_claims(pod):
            if claim is None:
                return None
            alloc = claim.status.allocation
            if alloc is not None:
                if alloc.node_name:
                    row = row_of(alloc.node_name)
                    if row < 0 or pinned not in (PIN_ANY, row):
                        pinned = PIN_NONE
                    else:
                        pinned = row
                continue
            creqs = self._claim_reqs(claim)
            if creqs is None:
                return None
            reqs.extend(creqs)
        if len(reqs) > self.MAX_REQS:
            return None
        return reqs, pinned

    # ------------- the per-dispatch build -------------

    def build(self, pods: list[Pod], row_of: Callable[[str], int],
              n_cap: int, b_cap: int, device="cpu"
              ) -> tuple[Optional[DraBatch], dict]:
        """Pack one batch's DRA tensors. Returns (DraBatch | None, stats)
        — None when no pod in the batch is device-evaluable. Also
        refreshes the plugin's device-routing set: routed pods skip the
        host DynamicResources filter (applies() -> False) because the
        fused launch carries their verdict. The tensors are on
        ``device`` (the mirror's); the selector words are the uint32 bit
        patterns held as int32."""
        device = torch.device(device)
        t0 = time.perf_counter()
        stats = {"compile_s": 0.0, "routed": 0, "fallback": 0}
        with self._lock:
            items = []
            routed: set[str] = set()
            for b, pod in enumerate(pods):
                if not pod.spec.resource_claims:
                    continue
                item = self._pod_item(pod, row_of)
                if item is None:
                    stats["fallback"] += 1
                    continue
                items.append((b, item[0], item[1]))
                routed.add(pod.metadata.uid)
            self.plugin._device_routed = frozenset(routed)
            stats["routed"] = len(items)
            self.stats["device_pods"] += len(items)
            self.stats["host_fallback_pods"] += stats["fallback"]
            if not items:
                return None, stats
            t_c0 = time.perf_counter()
            dev_valid, dev_selbits = self._ensure_inventory(row_of, n_cap,
                                                            device)
            stats["compile_s"] = time.perf_counter() - t_c0
            in_use = self._in_use_array(n_cap)
            q_need = max(1, max(len(reqs) for _b, reqs, _p in items))
            q_cap = 1
            while q_cap < q_need:
                q_cap *= 2
            req_mask = np.zeros((b_cap, q_cap, SELBIT_WORDS), np.uint32)
            req_count = np.zeros((b_cap, q_cap), np.int32)
            req_all = np.zeros((b_cap, q_cap), bool)
            pinned = np.full((b_cap,), PIN_ANY, np.int32)
            active = np.zeros((b_cap,), bool)
            for b, reqs, pin in items:
                active[b] = True
                pinned[b] = pin
                for q, (words, cnt, is_all) in enumerate(reqs):
                    req_mask[b, q] = words
                    req_count[b, q] = cnt
                    req_all[b, q] = is_all
            batch = DraBatch(
                dev_valid=dev_valid, dev_selbits=dev_selbits,
                dev_in_use=torch.from_numpy(in_use).to(device),
                req_mask=torch.from_numpy(req_mask.view(np.int32)).to(device),
                req_count=torch.from_numpy(req_count).to(device),
                req_all=torch.from_numpy(req_all).to(device),
                pinned=torch.from_numpy(pinned).to(device),
                active=torch.from_numpy(active).to(device))
            stats["build_s"] = time.perf_counter() - t0
            return batch, stats


@dataclass
class ClaimAssumeCache:
    """Assumed claim allocations ahead of the API write."""

    allocations: dict[str, ResourceClaim] = field(default_factory=dict)

    def assume(self, claim: ResourceClaim) -> None:
        self.allocations[claim.key()] = claim

    def restore(self, key: str) -> None:
        self.allocations.pop(key, None)

    def get(self, key: str) -> Optional[ResourceClaim]:
        return self.allocations.get(key)


class DynamicResources(PreFilterPlugin, FilterPlugin, ReservePlugin,
                       PreBindPlugin):
    NAME = "DynamicResources"
    STATE_KEY = "DynamicResources/claims"
    ASSUMED_KEY = "DynamicResources/assumed"

    def __init__(self, hub):
        import threading

        from kubernetes_tpu_torch.hub import EventHandlers

        self.hub = hub
        self.assume = ClaimAssumeCache()
        # incremental allocated-device ledger + per-node device index,
        # maintained by claim/slice watch events — replaces the
        # O(all claims x all slices) rescan per pod that dominated at
        # reference DRA scale (thousands of slices). _ledger_lock guards
        # against the binder pool's PreBind claim writes dispatching
        # concurrently with the loop thread's reads.
        self._ledger_lock = threading.Lock()
        self._alloc_of: dict[str, frozenset] = {}   # claim key -> triples
        self._in_use: dict[tuple, int] = {}         # triple -> refcount
        self._claim_rv: dict[str, int] = {}         # claim key -> newest rv
        self._node_devices: dict[str, list] = {}    # node -> [(drv,pool,Device)]
        self._slice_entries: dict[str, tuple] = {}  # slice uid -> (node, n)
        # (epoch, expression, id(device)) -> bool; devices are held
        # strongly by _node_devices while their verdicts matter, and the
        # epoch bumps on slice removal so an allocator thread racing the
        # removal can only insert entries no future lookup reaches
        # (id(dev) may be reused after GC)
        self._sel_cache: dict[tuple, bool] = {}
        self._sel_epoch = 0
        # CEL selector failures surfaced instead of silently parking
        # pods: per-source counts (the dra_cel_errors_total mirror) and
        # a (source, expression) dedup set so a broken expression records
        # ONE hub Event per object, not one per (pod, node, device)
        self._cel_errors: dict[str, int] = {}
        self._cel_seen: set[tuple] = set()
        # batched device allocator (ops/dra.py): the view mirrors the
        # slice inventory into dense tensors + precompiled selector
        # masks; pods it routes skip the host filter (applies() False)
        # because the fused launch carries their DRA verdict. The set is
        # refreshed by every build_device_batch call and cleared when
        # the scheduler degrades a batch to the host path.
        self.device_view = DeviceAllocatorView(self)
        self._device_routed: frozenset[str] = frozenset()
        hub.watch_resource_claims(EventHandlers(
            on_add=self._claim_event,
            on_update=lambda old, new: self._claim_event(new),
            on_delete=self._claim_removed))
        hub.watch_resource_slices(EventHandlers(
            on_add=self._slice_added, on_delete=self._slice_removed))

    def applies(self, pod: Pod) -> bool:
        """Host-filter relevance probe: claims present AND the pod was
        not routed through the device allocator for the current batch
        (the fused launch already carries routed pods' verdicts)."""
        return bool(pod.spec.resource_claims) \
            and pod.metadata.uid not in self._device_routed

    def set_device_routed(self, uids) -> None:
        """Scheduler seam: which pods the CURRENT batch evaluates on
        device. Cleared (empty) before any host-path pass — the host
        fallback ladder must re-enable the host DRA filter."""
        self._device_routed = frozenset(uids)

    def build_device_batch(self, pods: list[Pod], row_of, n_cap: int,
                           b_cap: int, device="cpu"):
        """Pack this batch's DraBatch tensors on ``device`` (or None) +
        build stats; refreshes the device-routing set as a side effect."""
        return self.device_view.build(pods, row_of, n_cap, b_cap, device)

    # --- the incremental ledger (claim/slice watch maintenance) ---

    def _apply_triples(self, key: str, triples: frozenset) -> None:
        """Ledger-lock-held: replace one claim's contribution."""
        old = self._alloc_of.get(key, frozenset())
        if old == triples:
            return
        for t in old - triples:
            n = self._in_use.get(t, 0) - 1
            if n <= 0:
                self._in_use.pop(t, None)
            else:
                self._in_use[t] = n
        for t in triples - old:
            self._in_use[t] = self._in_use.get(t, 0) + 1
        if triples:
            self._alloc_of[key] = triples
        else:
            self._alloc_of.pop(key, None)

    def _claim_event(self, claim: ResourceClaim) -> None:
        alloc = claim.status.allocation
        triples = frozenset(
            (d.driver, d.pool, d.device)
            for d in (alloc.devices if alloc is not None else ())
            if not d.admin_access)      # admin access never blocks others
        key = claim.key()
        rv = claim.metadata.resource_version
        with self._ledger_lock:
            # hub dispatch happens outside the hub lock, so a binder
            # thread's update and the loop thread's delete can arrive out
            # of commit order: the rv guard keeps a late update from
            # resurrecting a deleted claim's devices forever (hub rvs are
            # globally monotonic, so recreations are covered too)
            if rv <= self._claim_rv.get(key, -1):
                return
            self._claim_rv[key] = rv
            self._apply_triples(key, triples)

    def _claim_removed(self, claim: ResourceClaim) -> None:
        key = claim.key()
        with self._ledger_lock:
            self._claim_rv[key] = max(claim.metadata.resource_version,
                                      self._claim_rv.get(key, -1))
            if len(self._claim_rv) > 100_000:   # bound tombstone growth:
                # keep the newest half (stale events are short races)
                keep = sorted(self._claim_rv.items(),
                              key=lambda kv: kv[1])[50_000:]
                self._claim_rv = dict(keep)
            self._apply_triples(key, frozenset())

    def _slice_added(self, sl) -> None:
        with self._ledger_lock:
            entries = self._node_devices.setdefault(sl.node_name, [])
            for dev in sl.devices:
                entries.append((sl.driver, sl.pool, dev))
            self._slice_entries[sl.metadata.uid] = (sl.node_name,
                                                    sl.driver, sl.pool,
                                                    {d.name
                                                     for d in sl.devices})
        # outside the ledger lock (view lock -> ledger lock ordering)
        self.device_view.invalidate_node(sl.node_name)

    def _slice_removed(self, sl) -> None:
        with self._ledger_lock:
            meta = self._slice_entries.pop(sl.metadata.uid, None)
            if meta is None:
                return
            node, driver, pool, names = meta
            self._node_devices[node] = [
                (drv, pl, dev)
                for drv, pl, dev in self._node_devices.get(node, [])
                if not (drv == driver and pl == pool and dev.name in names)]
            # dropped Device objects may be GC'd and their ids reused —
            # bump the epoch (old-epoch keys become unreachable even if a
            # racing allocator inserts after this clear) and drop the bulk
            self._sel_epoch += 1
            self._sel_cache.clear()
        self.device_view.invalidate_node(node)

    def _in_use_view(self, exclude_keys: set[str]) -> set[tuple]:
        """Triples taken by any claim — ledger truth overlaid with assumed
        allocations — except the excluded claims'."""
        with self._ledger_lock:
            used = {t for t, n in self._in_use.items() if n > 0}
            base_alloc = dict(self._alloc_of)
        for key, claim in list(self.assume.allocations.items()):
            # overlay replaces the stored claim's contribution entirely
            used -= base_alloc.get(key, frozenset())
            alloc = claim.status.allocation
            if alloc is not None and key not in exclude_keys:
                used |= {(d.driver, d.pool, d.device)
                         for d in alloc.devices if not d.admin_access}
        for key in exclude_keys:
            if key not in self.assume.allocations:
                used -= base_alloc.get(key, frozenset())
        return used

    def _devices_on(self, node_name: str) -> list:
        with self._ledger_lock:
            return list(self._node_devices.get(node_name, ()))

    # --- views through the assume overlay ---

    def _claim(self, ns: str, name: str) -> Optional[ResourceClaim]:
        c = self.hub.get_resource_claim(ns, name)
        if c is None:
            return None
        assumed = self.assume.get(c.key())
        return assumed if assumed is not None else c

    def _pod_claims(self, pod: Pod):
        for ref in pod.spec.resource_claims:
            yield ref, self._claim(pod.metadata.namespace,
                                   claim_name_for(pod, ref))

    # --- the structured allocator (the reference's staging allocator) ---

    def _selector_accepts(self, expression: str, entry,
                          source: tuple[str, str]) -> bool:
        """One CEL selector against one device, MEMOIZED: a device's
        attributes are immutable for its lifetime in the slice index, so
        (expression, device) verdicts never change — without the cache
        the steady-state template workload re-evaluates the same
        expression over the same 800 devices for every (pod, node).
        A CelError (broken expression) counts as no-match but is
        SURFACED: a hub Event on the source object + the per-source
        error count the scheduler mirrors into dra_cel_errors_total."""
        driver, _pool, dev = entry
        key = (self._sel_epoch, expression, id(dev))
        hit = self._sel_cache.get(key)
        if hit is not None:
            return hit
        try:
            ok = evaluate(expression,
                          CelDevice(driver, dev.attributes, dev.capacity))
        except CelError as e:
            ok = False
            self._record_cel_error(source, expression, e)
        if len(self._sel_cache) > 500_000:
            self._sel_cache.clear()
        self._sel_cache[key] = ok
        return ok

    def _record_cel_error(self, source: tuple[str, str],
                          expression: str, err: Exception) -> None:
        kind, key = source
        src = f"{kind}/{key}"
        with self._ledger_lock:
            if (src, expression) in self._cel_seen:
                return
            self._cel_seen.add((src, expression))
            self._cel_errors[src] = self._cel_errors.get(src, 0) + 1
        try:
            self.hub.record_event(
                kind, key, "CELSelectorError",
                f"selector {expression!r} failed: {err}")
        except Exception:  # noqa: BLE001 — best-effort: an unreachable
            # hub must not turn a diagnostic into a scheduling failure
            pass

    def cel_error_stats(self) -> dict[str, int]:
        """{source object: distinct broken expressions} — mirrored into
        dra_cel_errors_total by the scheduler's maintenance tick."""
        with self._ledger_lock:
            return dict(self._cel_errors)

    def _cel_error_hint(self, claim: ResourceClaim) -> str:
        """Names the broken selector source touching ``claim``, if any —
        appended to the Filter's unschedulable message so a parked pod's
        condition points at the actual offender."""
        with self._ledger_lock:
            if not self._cel_errors:
                return ""
            if f"ResourceClaim/{claim.key()}" in self._cel_errors:
                return f"broken CEL selector on claim {claim.key()}"
            for req in claim.spec.device_requests:
                for alt in (req.first_available or [req]):
                    src = f"DeviceClass/{alt.device_class_name}"
                    if alt.device_class_name and src in self._cel_errors:
                        return ("broken CEL selector on deviceclass "
                                f"{alt.device_class_name}")
        return ""

    def _device_matches(self, entry, class_name: str, device_class,
                        selectors, claim_key: str) -> bool:
        """entry = (driver, pool, Device). DeviceClass CEL selectors (or
        the legacy direct device_class_name match when no class object
        exists) AND the request's own CEL selectors must all accept.
        ``device_class`` is the pre-resolved DeviceClass (resolved once
        per alternative, not per device — the allocator runs this for
        every device on every candidate node)."""
        _driver, _pool, dev = entry
        if class_name:
            if device_class is not None:
                for sel in device_class.selectors:
                    if not self._selector_accepts(
                            sel.cel_expression, entry,
                            ("DeviceClass", class_name)):
                        return False
            elif dev.device_class_name != class_name:
                return False
        for sel in selectors:
            if not self._selector_accepts(sel.cel_expression, entry,
                                          ("ResourceClaim", claim_key)):
                return False
        return True

    @staticmethod
    def _attr_of(entry, attribute: str):
        """matchAttribute resolution: qualified 'domain/name' keys match
        directly; plain keys resolve against the device's own driver
        domain (mirroring utils.cel._DomainMap)."""
        driver, _pool, dev = entry
        if attribute in dev.attributes:
            return dev.attributes[attribute]
        if "/" in attribute:
            dom, name = attribute.split("/", 1)
            if dom == driver:
                return dev.attributes.get(name)
        return None

    def allocate_claim(self, claim: ResourceClaim, node_name: str,
                       in_use: set[tuple]
                       ) -> Optional[list[DeviceAllocationResult]]:
        """Pick concrete devices on ``node_name`` satisfying every request
        of ``claim`` (ExactCount/All modes, firstAvailable alternatives,
        adminAccess, matchAttribute constraints), or None. Used by both
        Filter (feasibility = non-None) and Reserve (the actual pick), so
        the two can never diverge."""
        devices = self._devices_on(node_name)
        constraints = claim.spec.constraints
        picked: list[DeviceAllocationResult] = []
        taken: set[tuple] = set()
        locked: dict[int, object] = {}      # constraint idx -> value

        def applicable(parent_name):
            # a constraint names PARENT requests; it binds every
            # subrequest of a firstAvailable parent (empty = all requests)
            return [ci for ci, c in enumerate(constraints)
                    if not c.requests or parent_name in c.requests]

        def constraint_ok(cis, entry):
            for ci in cis:
                v = self._attr_of(entry, constraints[ci].match_attribute)
                if v is None or (ci in locked and locked[ci] != v):
                    return False
            return True

        def lock(cis, entry):
            for ci in cis:
                locked[ci] = self._attr_of(entry,
                                           constraints[ci].match_attribute)

        def fill(matched, cis, want, req_name, admin) -> bool:
            got = 0
            for entry, triple in matched:
                if got == want:
                    break
                if triple in taken or not constraint_ok(cis, entry):
                    continue
                lock(cis, entry)
                taken.add(triple)
                picked.append(DeviceAllocationResult(
                    request=req_name, driver=entry[0], pool=entry[1],
                    device=entry[2].name, admin_access=admin))
                got += 1
            return got == want

        def try_alternative(parent_name, req_name, class_name, selectors,
                            count, mode, admin) -> bool:
            device_class = (self.hub.get_device_class(class_name)
                            if class_name else None)
            matched = []
            for entry in devices:
                triple = (entry[0], entry[1], entry[2].name)
                if triple in taken:
                    continue
                if not admin and triple in in_use:
                    continue
                if not self._device_matches(entry, class_name,
                                            device_class, selectors,
                                            claim.key()):
                    continue
                matched.append((entry, triple))
            want = len(matched) if mode == ALLOCATION_MODE_ALL else count
            if len(matched) < want or want == 0:
                return False
            cis = applicable(parent_name)
            unlocked = [ci for ci in cis if ci not in locked]
            if not unlocked:
                return fill(matched, cis, want, req_name, admin)
            # unlocked matchAttribute constraints: a greedy first pick can
            # lock the wrong value ([A,B,B] with count=2 must pick B) —
            # try each candidate device as the constraint ANCHOR
            save = (list(picked), set(taken), dict(locked))
            for anchor, _t in matched:
                if not constraint_ok(cis, anchor):
                    continue
                lock(cis, anchor)
                if fill(matched, cis, want, req_name, admin):
                    return True
                picked[:] = save[0]
                taken.clear()
                taken.update(save[1])
                locked.clear()
                locked.update(save[2])
            return False

        for req in claim.spec.device_requests:
            alternatives = ([(f"{req.name}/{sub.name}", sub)
                             for sub in req.first_available]
                            if req.first_available else [(req.name, req)])
            satisfied = False
            for alt_name, alt in alternatives:
                save = (list(picked), set(taken), dict(locked))
                if try_alternative(req.name, alt_name,
                                   alt.device_class_name,
                                   alt.selectors, alt.count,
                                   alt.allocation_mode,
                                   getattr(alt, "admin_access", False)):
                    satisfied = True
                    break
                picked[:] = save[0]
                taken.clear()
                taken.update(save[1])
                locked.clear()
                locked.update(save[2])
            if not satisfied:
                return None
        return picked

    # --- extension points ---

    def pre_filter(self, state, pod: Pod, nodes) -> Status:
        if not pod.spec.resource_claims:
            return Status.skip()
        claims = []
        for ref, claim in self._pod_claims(pod):
            if claim is None:
                return Status.unschedulable(
                    f'resourceclaim "{claim_name_for(pod, ref)}" '
                    "not found", plugin=self.NAME, resolvable=False)
            claims.append(claim)
        state.write(self.STATE_KEY, claims)
        # exclude only the pod's UNALLOCATED claims: an allocated claim's
        # devices are taken no matter who reads the view (excluding it
        # would let a sibling claim double-book them)
        exclude = {c.key() for c in claims
                   if c.status.allocation is None}
        state.write(self.STATE_KEY + "/in_use",
                    self._in_use_view(exclude))
        return Status()

    def filter(self, state, pod: Pod, node_info) -> Status:
        claims = state.read(self.STATE_KEY) or []
        in_use = state.read(self.STATE_KEY + "/in_use") or set()
        node_name = node_info.node.metadata.name
        # claims share node devices: feasibility must thread one claim's
        # picks into the next's in-use view
        local_use = in_use
        for claim in claims:
            alloc = claim.status.allocation
            if alloc is not None:
                if alloc.node_name and alloc.node_name != node_name:
                    return Status.unschedulable(
                        "claim already allocated on another node",
                        plugin=self.NAME)
                continue
            picked = self.allocate_claim(claim, node_name, local_use)
            if picked is None:
                hint = self._cel_error_hint(claim)
                return Status.unschedulable(
                    "cannot allocate all claims"
                    + (f" ({hint})" if hint else ""), plugin=self.NAME)
            if len(claims) > 1:
                if local_use is in_use:
                    local_use = set(in_use)
                local_use |= {(d.driver, d.pool, d.device)
                              for d in picked if not d.admin_access}
        return Status()

    def reserve(self, state, pod: Pod, node_name: str) -> Status:
        assumed_keys = []
        claims = []
        for ref, c in self._pod_claims(pod):
            if c is None:
                return Status.unschedulable(
                    f'resourceclaim "{claim_name_for(pod, ref)}" '
                    "disappeared", plugin=self.NAME)
            claims.append(c)
        exclude = {c.key() for c in claims
                   if c.status.allocation is None}
        in_use = self._in_use_view(exclude)
        for claim in claims:
            if claim.status.allocation is not None:
                # already allocated: record this pod as a consumer
                if pod.metadata.uid not in claim.status.reserved_for:
                    new = claim.clone()
                    new.status.reserved_for.append(pod.metadata.uid)
                    self.assume.assume(new)
                    assumed_keys.append(new.key())
                continue
            picked = self.allocate_claim(claim, node_name, in_use)
            if picked is None:
                for k in assumed_keys:
                    self.assume.restore(k)
                return Status.unschedulable(
                    "devices vanished before reserve", plugin=self.NAME)
            in_use = in_use | {(d.driver, d.pool, d.device)
                               for d in picked if not d.admin_access}
            new = claim.clone()
            new.status.allocation = AllocationResult(
                node_name=node_name, devices=picked)
            if pod.metadata.uid not in new.status.reserved_for:
                new.status.reserved_for.append(pod.metadata.uid)
            self.assume.assume(new)
            assumed_keys.append(new.key())
        state.write(self.ASSUMED_KEY, assumed_keys)
        return Status()

    def unreserve(self, state, pod: Pod, node_name: str) -> None:
        for key in state.read(self.ASSUMED_KEY) or []:
            self.assume.restore(key)

    def pre_bind(self, state, pod: Pod, node_name: str) -> Status:
        for key in state.read(self.ASSUMED_KEY) or []:
            assumed = self.assume.get(key)
            if assumed is None:
                continue
            ns, name = key.split("/", 1)
            stored = self.hub.get_resource_claim(ns, name)
            if stored is None:
                return Status.error(f"resourceclaim {key} disappeared",
                                    plugin=self.NAME)
            try:
                new = stored.clone()
                if assumed.status.allocation is not None:
                    new.status.allocation = assumed.status.allocation
                merged = list(new.status.reserved_for)
                for uid in assumed.status.reserved_for:
                    if uid not in merged:
                        merged.append(uid)
                new.status.reserved_for = merged
                self.hub.update_resource_claim(new)
            except Unavailable:
                raise    # transport outage: degraded mode parks the pod
            except Exception as e:  # noqa: BLE001 — surfaced as Status
                return Status.error(str(e), plugin=self.NAME)
            self.assume.restore(key)
        return Status()
