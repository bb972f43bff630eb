"""K9, the learned score term: the packed parameters K2a and K3 read, the
path each launch takes through the hand kernel, and the wrapper of K9's
standalone probe (csrc/learned_mlp.cu).

K9 is a device function (csrc/learned_mlp.cuh ``learned_term``) that the
auction's bid kernel (K2a) and the serial scan (K3) call on every
(pod, node) total they form, after the hand-tuned terms: the reference
fuses the MLP into the same XLA programs (models/pipeline.py :634-636,
:1466-1474). Its twin is ops/learned.py.

``LearnedParams`` is the layer stack as ONE contiguous float32 buffer on
the launch's device (W0 row-major [d0, d1], b0, W1, b1, ...) plus the
widths (d0 = 9, d1, ..., dL = 1), on the host and as an int32 array on
the device. It is packed once per checkpoint reload (plugins/learned.py),
never once per launch; ``layers`` are views of the buffer for the twins.

The hand kernel serves any width and any depth, as the JAX package does
(``check_caps`` holds only the shapes: 9 inputs, W and b that match, a
scalar head). ``net_of`` picks the path once a launch: the narrow path
(every hidden layer at most NARROW_MAX wide, the stack at most
NARROW_FLOATS floats) stages the stack in each block's shared memory and
keeps a pair's activations in registers; the wide path forms a warp's
pairs together, PAIRS at most at a time, with its activations in a
per-warp slab: in shared memory where a block's slabs fit in
SLAB_SHARED_MAX bytes, else in a global scratch buffer the wrapper
allocates (``scratch_for``).

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
from dataclasses import dataclass, field

import numpy as np
import torch

from kubernetes_tpu_torch.kernels import build as KB
from kubernetes_tpu_torch.learn.checkpoint import CheckpointError
from kubernetes_tpu_torch.ops import learned as LN

# csrc/learned_mlp.cuh's constants
NARROW_MAX = 32            # widest hidden layer of the narrow path (K3,
                           # the probe; a kernel may stop lower: K2a 16)
NARROW_FLOATS = 16384      # largest stack the narrow path stages (padded)
PAIRS = 8                  # most pairs a warp carries (wide path)
SLAB_SHARED_MAX = 65536    # bytes of a block's slabs kept in shared memory
PROBE_THREADS = 256        # csrc/learned_mlp.cu THREADS


def check_caps(params) -> None:
    """Raise CheckpointError unless ``params`` ((W, b), ...) is a stack K9
    serves: at least one layer, F inputs, each W [in, out] with b [out]
    chained to the previous width, and a scalar head."""
    if not params:
        raise CheckpointError("learned scorer has no layers")
    prev = LN.NUM_FEATURES
    for i, (w, b) in enumerate(params):
        shape = tuple(w.shape)
        if len(shape) != 2 or shape[0] != prev or tuple(b.shape) != (
                shape[1],):
            raise CheckpointError(
                f"learned scorer layer {i}: W {shape}, b {tuple(b.shape)} "
                f"after {prev} inputs")
        prev = shape[1]
    if prev != 1:
        raise CheckpointError(f"learned scorer head must be scalar, got "
                              f"{prev}")


@dataclass(frozen=True)
class LearnedParams:
    """The packed layer stack on one device."""

    buf: torch.Tensor          # [P] f32 contiguous: W0, b0, W1, b1, ...
    dims: tuple                # (9, h1, ..., 1) layer widths
    # the widths as int32 on buf's device (made from dims when not given)
    dims_buf: torch.Tensor = field(default=None, compare=False)

    def __post_init__(self):
        if self.dims_buf is None:
            object.__setattr__(self, "dims_buf", torch.tensor(
                self.dims, dtype=torch.int32, device=self.buf.device))

    @staticmethod
    def pack(params, device="cuda") -> "LearnedParams":
        """Pack a ((W, b), ...) stack of array-likes (numpy arrays, CPU
        tensors) into one buffer on ``device``; refuses a malformed stack
        (check_caps)."""
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
    """csrc/learned_mlp.cuh ``LearnedNet``: the buffer and widths
    pointers, the wide path's scratch, the layer count and the path."""

    _fields_ = [("params", ctypes.c_void_p), ("dims", ctypes.c_void_p),
                ("scratch", ctypes.c_void_p), ("n_layers", ctypes.c_int),
                ("n_params", ctypes.c_int), ("narrow", ctypes.c_int),
                ("n_staged", ctypes.c_int), ("widest", ctypes.c_int),
                ("pairs", ctypes.c_int),
                ("slab_shared", ctypes.c_int)]


def _a4(x: int) -> int:
    return (x + 3) & ~3


def staged_floats(dims: tuple) -> int:
    """Floats of the narrow path's staged stack (csrc/learned_mlp.cuh
    learned_stage): each layer's W and b with rows padded to a multiple
    of 4."""
    return sum((din + 1) * _a4(dout) for din, dout in zip(dims, dims[1:]))


def narrow_class(dims: tuple, hmax: int = NARROW_MAX) -> int:
    """The narrow path's width class (the widest hidden layer rounded up
    to a multiple of 8, at least 8) in a kernel whose largest class is
    ``hmax``, or 0: the wide path."""
    hidden = max(dims[1:-1], default=0)
    if hidden > hmax or staged_floats(dims) > NARROW_FLOATS:
        return 0
    return max(8, -(-hidden // 8) * 8)


def net_of(params, warps: int, hmax: int = NARROW_MAX) -> LearnedNet:
    """The kernel-side description of ``params`` (a LearnedParams on the
    launch's device, or None: n_layers 0, no learned term) for a kernel of
    ``warps`` warps a block whose largest narrow class is ``hmax``
    (csrc K9_NARROW): the path, and on the wide path the pairs a
    warp carries and where its slab lives (the largest of PAIRS, 4, 2, 1
    pairs whose block of slabs fits SLAB_SHARED_MAX bytes of shared
    memory; else PAIRS pairs in a global scratch, which the wrapper
    attaches with ``scratch_for``)."""
    net = LearnedNet()
    if params is None:
        return net
    net.params = params.buf.data_ptr()
    net.dims = params.dims_buf.data_ptr()
    net.n_layers = params.n_layers
    net.n_params = params.buf.numel()
    net.narrow = narrow_class(params.dims, hmax)
    if net.narrow:
        net.n_staged = staged_floats(params.dims)
    net.widest = _a4(max(params.dims))
    if not net.narrow:
        net.pairs = PAIRS
        for pairs in (PAIRS, 4, 2, 1):
            if warps * 2 * pairs * net.widest * 4 <= SLAB_SHARED_MAX:
                net.pairs, net.slab_shared = pairs, 1
                break
    return net


def slab_floats(net: LearnedNet) -> int:
    """csrc/learned_mlp.cuh learned_slab_floats: a wide-path warp's slab."""
    return 2 * net.pairs * net.widest


def smem_floats(net: LearnedNet, warps: int) -> int:
    """csrc/learned_mlp.cuh learned_smem_floats: the floats of shared
    memory K9 takes in a block of ``warps`` warps (a multiple of 4)."""
    if net.n_layers <= 0:
        return 0
    if net.narrow:
        return net.n_staged + _a4(net.n_layers + 1)
    return warps * slab_floats(net) if net.slab_shared else 0


def scratch_for(net: LearnedNet, launch_warps: int, device):
    """The wide path's global slabs when they are not in shared memory: a
    [launch_warps x slab] buffer on ``device`` (kept alive by the caller
    until the launch is enqueued), attached to ``net``; None otherwise."""
    if net.n_layers <= 0 or net.narrow or net.slab_shared:
        return None
    buf = torch.empty((launch_warps * slab_floats(net),),
                      dtype=torch.float32, device=device)
    net.scratch = buf.data_ptr()
    return buf


def require_params(params, device) -> None:
    KB.require(params.buf, "learned params", torch.float32,
               (params.buf.numel(),), device)
    KB.require(params.dims_buf, "learned widths", torch.int32,
               (len(params.dims),), device)


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
    net = net_of(params, PROBE_THREADS // 32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # a wide stack's global slabs for at most two blocks an SM
    per_sm = 16 if net.narrow or net.slab_shared else 2
    blocks = max(1, min(-(-m // PROBE_THREADS), sms * per_sm))
    scratch = scratch_for(net, blocks * (PROBE_THREADS // 32), dev)
    launch = KB.library("learned_mlp").learned_mlp_launch
    launch.argtypes = [ctypes.POINTER(LearnedNet), ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                       ctypes.c_void_p]
    launch.restype = ctypes.c_int
    KB.check("learned_mlp", launch(ctypes.byref(net), rows.data_ptr(),
                                   out.data_ptr(), m, blocks,
                                   KB.stream_handle()))
    del scratch     # freed in stream order: reused after this launch
    KB.LAUNCHES["learned_mlp"] += 1
    return out


# ---------------------------------------------------------------- K10


def train_relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) whose derivative is 0 at x = 0, as jax.nn.relu's (the
    trainer's ReLU; K10's backward keeps the deltas where z > 0)."""
    return torch.where(x > 0, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))


def unpack(buf: torch.Tensor, dims: tuple) -> tuple:
    """((W, b), ...) views of a packed buffer (LearnedParams' layout);
    gradients of the views flow back to ``buf``."""
    out, off = [], 0
    for din, dout in zip(dims[:-1], dims[1:]):
        w = buf[off:off + din * dout].view(din, dout)
        off += din * dout
        out.append((w, buf[off:off + dout]))
        off += dout
    return tuple(out)


def mlp_train_apply(layers, x: torch.Tensor) -> torch.Tensor:
    """[M, 9] -> [M]: the reference's mlp_apply (``x @ W + b``, ReLU
    between layers, scalar head) in plain torch."""
    last = len(layers) - 1
    for i, (w, b) in enumerate(layers):
        x = x @ w + b
        if i < last:
            x = train_relu(x)
    return x[..., 0]


def mlp_loss_ref(buf: torch.Tensor, dims: tuple, x: torch.Tensor,
                 y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K10's twin: mean(w * (mlp(x) - y) ** 2), differentiable in
    ``buf`` by torch autograd."""
    pred = mlp_train_apply(unpack(buf, dims), x)
    return torch.mean(w * (pred - y) ** 2)


class _TrainArgs(ctypes.Structure):
    """csrc/learned_train.cu TrainArgs."""

    _fields_ = [("M", ctypes.c_long), ("L", ctypes.c_int),
                ("S", ctypes.c_int), ("P", ctypes.c_int),
                *[(name, ctypes.c_void_p) for name in (
                    "params", "dims", "x", "y", "w", "z", "dz", "loss_part",
                    "grad_part", "loss", "grad")]]


def _train_args(buf, dims_buf, dims, x, y, w, z) -> _TrainArgs:
    a = _TrainArgs()
    a.M, a.L = x.shape[0], len(dims) - 1
    a.S, a.P = sum(dims[1:]), buf.numel()
    for name, t in (("params", buf), ("dims", dims_buf), ("x", x), ("y", y),
                    ("w", w), ("z", z)):
        setattr(a, name, t.data_ptr())
    return a


def _train_lib():
    lib = KB.library("learned_train")
    for fn in (lib.k10_forward_launch, lib.k10_backward_launch):
        fn.argtypes = [ctypes.POINTER(_TrainArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.k10_blocks.argtypes = [ctypes.c_long]
    return lib


def _check_train(buf, dims, x, y, w):
    dev = buf.device
    m = x.shape[0]
    if len(dims) - 1 > 64 or dims[0] != LN.NUM_FEATURES or dims[-1] != 1:
        raise ValueError(f"K10 serves 9 inputs, a scalar head and at most "
                         f"64 layers; got widths {dims}")
    KB.require(buf, "params", torch.float32, (buf.numel(),), dev)
    KB.require(x, "x", torch.float32, (m, LN.NUM_FEATURES), dev)
    KB.require(y, "y", torch.float32, (m,), dev)
    KB.require(w, "w", torch.float32, (m,), dev)


_DIMS_BUFS: dict = {}


def _dims_buf(dims: tuple, dev) -> torch.Tensor:
    """The widths as int32 on ``dev``, made once a stack shape (a fit
    calls the step hundreds of times; a fresh copy each time would be a
    host-to-device copy each step)."""
    key = (tuple(dims), str(dev))
    t = _DIMS_BUFS.get(key)
    if t is None:
        t = _DIMS_BUFS[key] = torch.tensor(dims, dtype=torch.int32,
                                           device=dev)
    return t


class MLPLoss(torch.autograd.Function):
    """K10 bound to torch autograd: forward (k10_forward, saving the
    pre-activations) gives the loss, backward (k10_backward) the gradient
    of every packed parameter. CUDA tensors only (mlp_loss picks the
    twin for CPU tensors)."""

    @staticmethod
    def forward(ctx, buf, x, y, w, dims):
        _check_train(buf, dims, x, y, w)
        dev = buf.device
        m = x.shape[0]
        dims_buf = _dims_buf(dims, dev)
        z = torch.empty((sum(dims[1:]), m), dtype=torch.float32, device=dev)
        lib = _train_lib()
        blocks = lib.k10_blocks(m)
        a = _train_args(buf, dims_buf, dims, x, y, w, z)
        loss_part = torch.empty((blocks,), dtype=torch.float32, device=dev)
        loss = torch.empty((), dtype=torch.float32, device=dev)
        a.loss_part, a.loss = loss_part.data_ptr(), loss.data_ptr()
        KB.check("learned_train", lib.k10_forward_launch(
            ctypes.byref(a), KB.stream_handle()))
        KB.LAUNCHES["learned_train_fwd"] += 1
        ctx.save_for_backward(buf, x, y, w, z, dims_buf)
        ctx.dims = dims
        return loss

    @staticmethod
    def backward(ctx, g):
        buf, x, y, w, z, dims_buf = ctx.saved_tensors
        grad = mlp_grad(buf, dims_buf, ctx.dims, x, y, w, z)
        return grad * g, None, None, None, None


def mlp_grad(buf, dims_buf, dims, x, y, w, z) -> torch.Tensor:
    """K10's backward alone: the gradient [P] from the forward's saved
    pre-activations ``z``."""
    dev = buf.device
    m = x.shape[0]
    lib = _train_lib()
    blocks = lib.k10_blocks(m)
    a = _train_args(buf, dims_buf, dims, x, y, w, z)
    dz = torch.empty_like(z)
    grad_part = torch.empty((blocks, buf.numel()), dtype=torch.float32,
                            device=dev)
    grad = torch.empty((buf.numel(),), dtype=torch.float32, device=dev)
    a.dz, a.grad_part, a.grad = (dz.data_ptr(), grad_part.data_ptr(),
                                 grad.data_ptr())
    KB.check("learned_train", lib.k10_backward_launch(
        ctypes.byref(a), KB.stream_handle()))
    KB.LAUNCHES["learned_train_bwd"] += 1
    return grad


def mlp_value_and_grad(buf: torch.Tensor, dims: tuple, x: torch.Tensor,
                       y: torch.Tensor, w: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss [], gradient [P]) of mean(w * (mlp(x) - y) ** 2) at the packed
    params ``buf``: K10 (through MLPLoss) for CUDA tensors, the twin's
    autograd for CPU tensors (the reference's jax.value_and_grad)."""
    dev = buf.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"mlp_value_and_grad: unsupported device {dev}")
    p = buf.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = (mlp_loss_ref(p, dims, x, y, w) if dev.type == "cpu"
                else MLPLoss.apply(p, x, y, w, tuple(dims)))
        (grad,) = torch.autograd.grad(loss, p)
    return loss.detach(), grad
