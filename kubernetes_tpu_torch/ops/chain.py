"""The chain patch on the device (port of the JAX package's
``models/pipeline.py`` ``_chain_set_rows_jit`` / ``_chain_add_rows_jit``,
:1645-1653, as ``patch_chain`` at :1655 calls them).

``patch_chain_ref`` is the plain-torch statement of kernel K11 — the
executable spec its hand-written kernel (``kernels/chain.py``,
``csrc/chain_patch.cu``) is held to, and what the port runs for CPU
tensors. It folds node-row patches into the device-resident usage chain
(free [N, R] f32, nzr [N, 2] f32) in place of a full snapshot re-sync:

- ``set`` rows are absolute repacks (a node added, updated or removed):
  the chain's row is replaced;
- ``add`` rows are commutative usage deltas (a foreign pod bound or
  deleted): they are added to the chain's row.

Sets apply first, then adds, as in the reference. The function is out of
place: its inputs are never written (the reference's ``.at[].set`` /
``.at[].add`` are functional, and an in-flight wave's pending tuple may
still hold the input chain).

The caller's lists obey a contract, checked by the kernel's wrapper:
set indices unique, add indices unique, no index both a set and an add,
every index below N. The reference reaches it by building the lists from
a set and a dict and dropping the deltas of a node it repacks. Its pow2
padding of the lists (duplicated sets, zero adds) and ``warm_patch_chain``
exist only to spare XLA recompiles; the port has neither, so each element
of the result is one copy or one f32 add.
"""

from __future__ import annotations

import torch


def patch_chain_ref(free: torch.Tensor, nzr: torch.Tensor,
                    set_idx: torch.Tensor, set_free: torch.Tensor,
                    set_nzr: torch.Tensor, add_idx: torch.Tensor,
                    add_free: torch.Tensor, add_nzr: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """New (free, nzr): the input rows, ``set_idx``'s rows replaced by
    ``set_free`` / ``set_nzr``, then ``add_idx``'s rows plus ``add_free``
    / ``add_nzr``. Index tensors are integer [S] / [A]; empty lists are
    allowed."""
    free = free.clone()
    nzr = nzr.clone()
    if set_idx.numel():
        idx = set_idx.to(device=free.device, dtype=torch.int64)
        free.index_copy_(0, idx, set_free.to(free.device, free.dtype))
        nzr.index_copy_(0, idx, set_nzr.to(nzr.device, nzr.dtype))
    if add_idx.numel():
        idx = add_idx.to(device=free.device, dtype=torch.int64)
        free.index_add_(0, idx, add_free.to(free.device, free.dtype))
        nzr.index_add_(0, idx, add_nzr.to(nzr.device, nzr.dtype))
    return free, nzr
