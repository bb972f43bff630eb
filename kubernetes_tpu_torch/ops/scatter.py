"""The row scatter on the device (port of the JAX package's
``backend/mirror.py`` ``_scatter_rows_jit``, :128, and
``framework/preemption.py`` ``_scatter_rows0_jit``, :51).

``scatter_rows_ref`` is the plain-torch statement of kernel K12, the
executable spec its hand-written kernel (``kernels/scatter.py``,
``csrc/row_scatter.cu``) is held to, and what the port runs for CPU
tensors: ``buf[idx] = rows`` along axis 0, in place. The reference
donates ``buf``, so its update is in place too.

The reference pads ``idx`` to a power of two with its last row repeated
(an idempotent write that only spares XLA recompiles); the port's
callers pass each row once, and K12's wrapper refuses a duplicate.
"""

from __future__ import annotations

import torch


def scatter_rows_ref(buf: torch.Tensor, idx: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """``buf`` with its rows ``idx`` replaced by ``rows`` (in place;
    returned)."""
    return buf.index_copy_(0, idx.to(device=buf.device, dtype=torch.int64),
                           rows.to(buf.device, buf.dtype))
