"""Batched DRA allocation feasibility: the plain-torch twin of kernel K8
(port of the JAX package's ops/dra.py).

The cluster's device inventory is mirrored into dense per-node tensors
(``dev_valid``/``dev_selbits``/``dev_in_use``, [N, D] with D a per-node
device bucket) by plugins/dra.py's DeviceAllocatorView. Every CEL
selector is compiled at watch time into one bit of a per-device verdict
bitmask (SELBIT_WORDS 32-bit words = up to 256 distinct selectors), so a
request matches a device iff the request's required-bit mask is a subset
of the device's verdict bits.

``batch_feasible`` evaluates a whole batch against every node with the
host allocator's greedy request-order, device-order semantics: for each
request, the eligible devices (free, not taken by an earlier request of
the pod, selector bits covering the mask) are ranked by a cumulative sum
over the device axis; the first ``count`` of them (every one in All
mode) join a carried ``taken`` mask. Then the pinned-node check. The
pod axis is evaluated in chunks of DRA_CHUNK, which only bounds the
transient [chunk, N, D] masks.

The selector words are 32-bit bit patterns held in int32 tensors (the
reference's uint32): AND and equality see the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

# fixed selector-bitmask width: 8 words = 256 distinct compiled
# selectors; the 257th distinct selector routes its claims to the host
# path (DeviceAllocatorView)
SELBIT_WORDS = 8
MAX_SELECTORS = SELBIT_WORDS * 32

# chunk of the pod axis evaluated at once: bounds the transient
# [chunk, N, D] eligibility masks of giant drain batches
DRA_CHUNK = 256

# ``pinned`` sentinels: -1 = no allocated claim pins this pod; -2 = an
# allocated claim pins it to a node that is not (or no longer) mirrored,
# or two claims pin it to different nodes: feasible nowhere
PIN_ANY = -1
PIN_NONE = -2


@dataclass
class DraBatch:
    """One launch's DRA inputs (N = mirror node capacity, D = device
    bucket per node, Q = request bucket per pod, W = SELBIT_WORDS, B =
    batch bucket).

    Device inventory (resident between launches, re-pushed only on slice,
    selector or row changes):
      dev_valid    [N, D]    bool   device exists at (node row, slot)
      dev_selbits  [N, D, W] int32  bit s set iff selector s accepts it
      dev_in_use   [N, D]    bool   allocated to some claim
    Per-batch claim tensors (each pod's unallocated claims' requests):
      req_mask     [B, Q, W] int32  bits a device must all carry
      req_count    [B, Q]    int32  ExactCount want (0 = unused slot)
      req_all      [B, Q]    bool   allocation mode All
      pinned       [B]       int32  row an allocated claim pins the pod
                                    to (PIN_ANY / PIN_NONE sentinels)
      active       [B]       bool   pod routed through the device
                                    allocator (False rows verdict True)
    """

    dev_valid: torch.Tensor
    dev_selbits: torch.Tensor
    dev_in_use: torch.Tensor
    req_mask: torch.Tensor
    req_count: torch.Tensor
    req_all: torch.Tensor
    pinned: torch.Tensor
    active: torch.Tensor

    def to(self, device) -> "DraBatch":
        return DraBatch(**{f.name: getattr(self, f.name).to(device)
                           for f in fields(self)})


def batch_feasible(dra: DraBatch) -> torch.Tensor:
    """[B, N] bool: can every unallocated claim of pod b be allocated on
    node n (greedy host-parity semantics), and does n satisfy the pod's
    allocated-claim pins? Inactive rows are all True."""
    free = dra.dev_valid & ~dra.dev_in_use                      # [N, D]
    n = free.shape[0]
    b, q_cap, w_cap = dra.req_mask.shape
    rows = torch.arange(n, device=free.device)
    out = torch.empty((b, n), dtype=torch.bool, device=free.device)
    for c0 in range(0, b, DRA_CHUNK):
        c1 = min(b, c0 + DRA_CHUNK)
        mask = dra.req_mask[c0:c1]
        count = dra.req_count[c0:c1]
        is_all = dra.req_all[c0:c1]
        taken = torch.zeros((c1 - c0,) + tuple(free.shape),
                            dtype=torch.bool, device=free.device)
        ok = torch.ones((c1 - c0, n), dtype=torch.bool, device=free.device)
        for q in range(q_cap):
            sel_ok = torch.ones_like(taken)
            for w in range(w_cap):
                m = mask[:, q, w][:, None, None]
                sel_ok &= (dra.dev_selbits[None, :, :, w] & m) == m
            elig = free[None] & ~taken & sel_ok                 # [c, N, D]
            csum = torch.cumsum(elig.to(torch.int32), dim=2)
            total = csum[:, :, -1]                              # [c, N]
            all_q = is_all[:, q]
            used = (count[:, q] > 0) | all_q
            want = torch.where(all_q, torch.ones_like(count[:, q]),
                               count[:, q])
            ok &= ~used[:, None] | (total >= want[:, None])
            # greedy pick in device order; All mode takes every eligible
            # device
            taken |= elig & (all_q[:, None, None]
                             | (csum <= count[:, q][:, None, None]))
        pinned = dra.pinned[c0:c1][:, None]
        ok &= torch.where(pinned >= 0, rows[None] == pinned,
                          pinned == PIN_ANY)
        out[c0:c1] = ok | ~dra.active[c0:c1][:, None]
    return out


def fuse_phase1(static_ok: torch.Tensor, dra: DraBatch, host_ok=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's fusion after phase 1 (pipeline.py:1023-1039):
    (static_ok & dra_ok [& host_ok], dra_reject [B] i32), where
    dra_reject counts the nodes that passed the static filters and fail
    only on claims."""
    dra_ok = batch_feasible(dra)
    dra_reject = (static_ok & ~dra_ok).sum(dim=1).to(torch.int32)
    out = static_ok & dra_ok
    if host_ok is not None:
        out = out & host_ok
    return out, dra_reject
