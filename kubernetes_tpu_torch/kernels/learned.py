"""K9, the learned score term: the packed parameters K2a and K3 read, the
hand kernel's caps, and the wrapper of K9's standalone probe
(csrc/learned_mlp.cu).

K9 is a device function (csrc/learned_mlp.cuh ``learned_term``) that the
auction's bid kernel (K2a) and the serial scan (K3) call on every
(pod, node) total they form, after the hand-tuned terms: the reference
fuses the MLP into the same XLA programs (models/pipeline.py :634-636,
:1466-1474). Its twin is ops/learned.py.

``LearnedParams`` is the layer stack as ONE contiguous float32 buffer on
the launch's device (W0 row-major [d0, d1], b0, W1, b1, ...) plus the
widths (d0 = 9, d1, ..., dL = 1). It is packed once per checkpoint
reload (plugins/learned.py), never once per launch; ``layers`` are views
of the buffer for the twins.

The hand kernel holds every layer width at most MAX_WIDTH and at most
MAX_LAYERS layers (a thread keeps two activation rows of MAX_WIDTH
floats), so 9 -> 64 -> ... -> 1 fits. A wider or deeper checkpoint is
refused at load (``check_caps``, a CheckpointError naming the cap): a
stated deviation, since the JAX package serves any width.

``learned_probe`` runs K9 alone over raw feature rows [M, 9] (frac_cpu,
frac_mem, fit, bal, taint, aff, img, spread, ipa on their pipeline
scales) -> [M]: no scheduling path launches it; it exists so the device
function can be held against ops/learned.learned_term and timed alone.

The ``learned_mlp`` launch counter (kernels/build.py LAUNCHES) counts
every launch that runs K9: a K2a bid round or a K3 scan that carries
learned params, and the probe.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from kubernetes_tpu_torch.kernels import build as KB
from kubernetes_tpu_torch.learn.checkpoint import CheckpointError
from kubernetes_tpu_torch.ops import learned as LN

MAX_WIDTH = 64
MAX_LAYERS = 8


class LearnedCapError(CheckpointError):
    """A layer stack wider or deeper than the hand kernel holds."""


def check_caps(params) -> None:
    """Raise LearnedCapError unless ``params`` ((W, b), ...) fits K9: at
    most MAX_LAYERS layers, every width at most MAX_WIDTH, F inputs and a
    scalar head."""
    if not 1 <= len(params) <= MAX_LAYERS:
        raise LearnedCapError(
            f"learned scorer has {len(params)} layers; the hand kernel "
            f"(csrc/learned_mlp.cuh) holds 1 to MAX_LAYERS = {MAX_LAYERS}")
    prev = LN.NUM_FEATURES
    for i, (w, b) in enumerate(params):
        shape = tuple(w.shape)
        if len(shape) != 2 or shape[0] != prev or tuple(b.shape) != (
                shape[1],):
            raise LearnedCapError(
                f"learned scorer layer {i}: W {shape}, b {tuple(b.shape)} "
                f"after {prev} inputs")
        if shape[1] > MAX_WIDTH:
            raise LearnedCapError(
                f"learned scorer layer {i} is {shape[1]} wide; the hand "
                f"kernel (csrc/learned_mlp.cuh) holds widths up to "
                f"MAX_WIDTH = {MAX_WIDTH}")
        prev = shape[1]
    if prev != 1:
        raise LearnedCapError(f"learned scorer head must be scalar, got "
                              f"{prev}")


@dataclass(frozen=True)
class LearnedParams:
    """The packed layer stack on one device."""

    buf: torch.Tensor          # [P] f32 contiguous: W0, b0, W1, b1, ...
    dims: tuple                # (9, h1, ..., 1) layer widths

    @staticmethod
    def pack(params, device="cuda") -> "LearnedParams":
        """Pack a ((W, b), ...) stack of array-likes (numpy arrays, CPU
        tensors) into one buffer on ``device``; refuses a stack the hand
        kernel cannot hold (check_caps)."""
        check_caps(params)
        parts, dims = [], [LN.NUM_FEATURES]
        for w, b in params:
            w = np.asarray(w, np.float32)
            parts += [w.reshape(-1), np.asarray(b, np.float32).reshape(-1)]
            dims.append(int(w.shape[1]))
        buf = torch.from_numpy(np.ascontiguousarray(np.concatenate(parts)))
        return LearnedParams(buf=buf.to(device), dims=tuple(dims))

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1

    @property
    def layers(self) -> tuple:
        """((W, b), ...) views of the buffer (the twins' params)."""
        out, off = [], 0
        for din, dout in zip(self.dims[:-1], self.dims[1:]):
            w = self.buf[off:off + din * dout].view(din, dout)
            off += din * dout
            out.append((w, self.buf[off:off + dout]))
            off += dout
        return tuple(out)


class LearnedNet(ctypes.Structure):
    """csrc/learned_mlp.cuh ``LearnedNet``: the buffer pointer, the layer
    count and the widths (MAX_LAYERS + 1 slots)."""

    _fields_ = [("params", ctypes.c_void_p), ("n_layers", ctypes.c_int),
                ("n_params", ctypes.c_int),
                ("dims", ctypes.c_int * (MAX_LAYERS + 1))]


def net_of(params) -> LearnedNet:
    """The kernel-side description of ``params`` (a LearnedParams on the
    launch's device, or None: n_layers 0, no learned term)."""
    net = LearnedNet()
    if params is None:
        return net
    net.params = params.buf.data_ptr()
    net.n_layers = params.n_layers
    net.n_params = params.buf.numel()
    for i, d in enumerate(params.dims):
        net.dims[i] = d
    return net


def smem_floats(net: LearnedNet) -> int:
    """csrc/learned_mlp.cuh learned_smem_floats: the floats a block
    stages (rounded up to a multiple of 4)."""
    return (net.n_params + 3) & ~3 if net.n_layers > 0 else 0


def require_params(params, device) -> None:
    KB.require(params.buf, "learned params", torch.float32,
               (params.buf.numel(),), device)


# ---------------------------------------------------------------- twin


def learned_probe_ref(params: LearnedParams, rows: torch.Tensor
                      ) -> torch.Tensor:
    """[M, 9] raw feature rows -> [M] learned term (ops/learned.py)."""
    return LN.learned_term(params.layers, rows[:, 0:2], rows[:, 2],
                           rows[:, 3], rows[:, 4], rows[:, 5], rows[:, 6],
                           rows[:, 7], rows[:, 8])


# ---------------------------------------------------------------- kernel


def learned_probe(params: LearnedParams, rows: torch.Tensor
                  ) -> torch.Tensor:
    """K9 alone: the kernel for CUDA tensors, the twin for CPU tensors."""
    dev = rows.device
    if dev.type == "cpu":
        return learned_probe_ref(params, rows)
    if dev.type != "cuda":
        raise ValueError(f"learned_probe: unsupported device {dev}")
    m = rows.shape[0]
    KB.require(rows, "rows", torch.float32, (m, LN.NUM_FEATURES), dev)
    require_params(params, dev)
    out = torch.empty((m,), dtype=torch.float32, device=dev)
    net = net_of(params)
    launch = KB.library("learned_mlp").learned_mlp_launch
    launch.argtypes = [ctypes.POINTER(LearnedNet), ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]
    launch.restype = ctypes.c_int
    KB.check("learned_mlp", launch(ctypes.byref(net), rows.data_ptr(),
                                   out.data_ptr(), m, KB.stream_handle()))
    KB.LAUNCHES["learned_mlp"] += 1
    return out
