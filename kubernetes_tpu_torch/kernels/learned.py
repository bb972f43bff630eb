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


# csrc/learned_train.cu's constants
TRAIN_THREADS = (64, 32, 16)   # a tile's rows, widest first
TRAIN_MAX_LAYERS = 64
TRAIN_BLOCKS_PER_SM = 16
TRAIN_GROUP = 32               # blocks a group of the two-level fold
SMALL_H = 8                    # the narrow path: 9 -> H -> 1, H <= this
SMALL_THREADS = 64
SMALL_BLOCKS_PER_SM = 4
TRAIN_SMEM_MAX = 232448        # bytes of shared memory a block can use
TRAIN_SMEM_STATIC = 1296       # of it the kernel's static part (to the
                               # dynamic part's 16-byte aligned start)
SM_SHARED = 233472             # an SM's shared memory (228 KB)
BLOCK_RESERVED = 1024          # shared memory the card reserves a block
MODE_LOSS, MODE_GRAD = 0, 1


def train_smem(dims: tuple, threads: int) -> int:
    """K10's dynamic shared memory for a tile of ``threads`` rows: x and
    every pre-activation, every delta and the rows' losses, a unit's row
    padded to threads + 1 floats, and the block's P + 1 sums
    (csrc/learned_train.cu train_smem)."""
    return 4 * ((2 * sum(dims[1:]) + LN.NUM_FEATURES + 1) * (threads + 1)
                + n_params(dims) + 1)


def n_params(dims: tuple) -> int:
    return sum((a + 1) * b for a, b in zip(dims, dims[1:]))


@dataclass(frozen=True)
class TrainPlan:
    """K10's launch. The tiled path (``small`` False): ``threads`` rows a
    tile (the block's threads), ``tiles`` tiles a block, ``blocks``
    blocks; ``smem`` bytes of dynamic shared memory a block; ``chunks``
    rounds of parameter sums a tile (a thread sums parameters t, t +
    threads, ... and the loss). The narrow path (``small``: 9 -> H -> 1,
    H <= SMALL_H): ``blocks`` of ``threads``, rows strided by the grid's
    threads, ``tiles`` rows a thread at most; no dynamic shared memory."""
    threads: int
    tiles: int
    blocks: int
    smem: int
    chunks: int
    small: bool = False


def small_path(dims: tuple) -> bool:
    """Does K10 take its narrow path (csrc/learned_train.cu k10_small)
    for the stack ``dims``?"""
    return (len(dims) == 3 and dims[0] == LN.NUM_FEATURES
            and 1 <= dims[1] <= SMALL_H and dims[2] == 1)


def plan_train(m: int, dims: tuple, sms: int = 132) -> TrainPlan:
    """K10's launch for ``m`` rows of the stack ``dims`` on a card of
    ``sms`` SMs. A 9 -> H -> 1 stack with H <= SMALL_H takes the narrow
    path: blocks of SMALL_THREADS covering the rows once while they fit
    SMALL_BLOCKS_PER_SM blocks an SM, the rows strided past that. Any
    other stack takes the widest tile (64, 32 or 16 rows) whose activations,
    deltas and parameter sums fit a block's shared memory; one tile a
    block while the tiles fit TRAIN_BLOCKS_PER_SM blocks an SM (as many as
    shared memory lets stay resident), more tiles a block past that.
    Raises ValueError for a stack none fits (train_smem at 16 rows past
    TRAIN_SMEM_MAX - TRAIN_SMEM_STATIC bytes: a single hidden layer of
    1,279 units is the widest served) or of more than TRAIN_MAX_LAYERS
    layers."""
    if m < 1:
        raise ValueError("K10: no rows")
    if len(dims) - 1 > TRAIN_MAX_LAYERS or dims[0] != LN.NUM_FEATURES \
            or dims[-1] != 1 or min(dims) < 1:
        raise ValueError(f"K10 serves 9 inputs, a scalar head and at most "
                         f"{TRAIN_MAX_LAYERS} layers; got widths {dims}")
    if small_path(dims):
        blocks = min(-(-m // SMALL_THREADS), SMALL_BLOCKS_PER_SM * sms)
        return TrainPlan(SMALL_THREADS, -(-m // (blocks * SMALL_THREADS)),
                         blocks, 0, 0, small=True)
    room = TRAIN_SMEM_MAX - TRAIN_SMEM_STATIC
    fits = [t for t in TRAIN_THREADS if train_smem(dims, t) <= room]
    if not fits:
        raise ValueError(
            f"K10: a 16-row tile of the widths {dims} ({sum(dims[1:])} "
            f"units, {n_params(dims)} parameters) needs "
            f"{train_smem(dims, TRAIN_THREADS[-1])} bytes of shared memory, "
            f"past a block's {room}")
    t = fits[0]
    smem = train_smem(dims, t)
    per_sm = min(TRAIN_BLOCKS_PER_SM,
                 SM_SHARED // (smem + TRAIN_SMEM_STATIC + BLOCK_RESERVED))
    row_tiles = -(-m // t)
    blocks = min(row_tiles, max(per_sm, 1) * sms)
    tiles = -(-row_tiles // blocks)
    blocks = -(-row_tiles // tiles)
    return TrainPlan(t, tiles, blocks, smem, -(-(n_params(dims) + 1) // t))


class _TrainArgs(ctypes.Structure):
    """csrc/learned_train.cu TrainArgs."""

    _fields_ = [("M", ctypes.c_long), ("L", ctypes.c_int),
                ("S", ctypes.c_int), ("P", ctypes.c_int),
                ("mode", ctypes.c_int), ("threads", ctypes.c_int),
                ("tiles", ctypes.c_int), ("blocks", ctypes.c_int),
                ("dims", ctypes.c_int * (TRAIN_MAX_LAYERS + 1)),
                *[(name, ctypes.c_void_p) for name in (
                    "params", "x", "y", "w", "gscale", "part", "gpart",
                    "ticket", "loss", "grad")]]


def _train_lib():
    lib = KB.library("learned_train")
    lib.k10_step_launch.argtypes = [ctypes.POINTER(_TrainArgs),
                                    ctypes.c_void_p]
    lib.k10_step_launch.restype = ctypes.c_int
    return lib


class TrainStep:
    """K10's launch prepared once for ``m`` rows of the stack ``dims`` on a
    CUDA ``device`` (train.py's _fit makes one a fit): the plan, the
    argument block, the blocks' and the groups' partial sums and the
    tickets. A step sets the pointers that change and launches once;
    nothing is allocated."""

    def __init__(self, m: int, dims: tuple, device):
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"TrainStep: a CUDA device, got {dev}")
        self.m, self.dims, self.device = m, tuple(dims), dev
        props = torch.cuda.get_device_properties(dev)
        self.plan = plan_train(m, self.dims, props.multi_processor_count)
        self.p = n_params(self.dims)
        groups = -(-self.plan.blocks // TRAIN_GROUP)
        self.part = torch.empty(((self.plan.blocks + groups)
                                 * (self.p + 1),), dtype=torch.float32,
                                device=dev)
        self.ticket = torch.zeros((groups + 1,), dtype=torch.int32,
                                  device=dev)
        self.lib = _train_lib()
        a = self.args = _TrainArgs()
        a.M, a.L = m, len(self.dims) - 1
        a.S, a.P = sum(self.dims[1:]), self.p
        a.threads, a.tiles, a.blocks = (self.plan.threads, self.plan.tiles,
                                        self.plan.blocks)
        for k, d in enumerate(self.dims):
            a.dims[k] = d
        a.part, a.ticket = self.part.data_ptr(), self.ticket.data_ptr()
        a.gpart = a.part + 4 * self.plan.blocks * (self.p + 1)

    def check(self, buf, x, y, w) -> None:
        """The wrapper-side argument check of a step's tensors."""
        dev, m = self.device, self.m
        KB.require(buf, "params", torch.float32, (self.p,), dev)
        KB.require(x, "x", torch.float32, (m, LN.NUM_FEATURES), dev)
        KB.require(y, "y", torch.float32, (m,), dev)
        KB.require(w, "w", torch.float32, (m,), dev)

    def launch(self, mode: int, buf, x, y, w, loss: int, grad: int = 0,
               gscale: int = 0) -> None:
        """One launch: the loss to address ``loss`` (one float), in
        MODE_GRAD also the gradient to ``grad`` [P], times the float at
        ``gscale`` where given (addresses on the card; 0 for none)."""
        a = self.args
        a.mode = mode
        a.params, a.x, a.y, a.w = (buf.data_ptr(), x.data_ptr(),
                                   y.data_ptr(), w.data_ptr())
        a.loss, a.grad, a.gscale = loss, grad or None, gscale or None
        KB.check("learned_train", self.lib.k10_step_launch(
            ctypes.byref(a), KB.stream_handle(self.device.index)))
        KB.LAUNCHES["learned_train"] += 1


_STEPS: dict = {}


def train_step(m: int, dims: tuple, device) -> TrainStep:
    """The prepared K10 launch of (m, dims, device), made at its first
    use and kept (the last few shapes)."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (m, tuple(dims), dev.index)
    step = _STEPS.get(key)
    if step is None:
        if len(_STEPS) >= 8:
            _STEPS.clear()
        step = _STEPS[key] = TrainStep(m, dims, dev)
    return step


class MLPLoss(torch.autograd.Function):
    """K10 bound to torch autograd, both directions the one kernel: the
    forward launches the loss mode and saves its inputs, the backward
    launches the gradient mode on them, scaled by the incoming gradient
    in the kernel. The gradient mode recomputes the forward in the same
    launch: keeping the activations for it would write and read back 8 B
    a hidden unit a row, where the recompute re-reads x, y and w (44 B a
    row) and costs no more than the loss mode. CUDA tensors only
    (mlp_loss picks the twin for CPU tensors)."""

    @staticmethod
    def forward(ctx, buf, x, y, w, dims):
        step = train_step(x.shape[0], dims, buf.device)
        step.check(buf, x, y, w)
        loss = torch.empty((), dtype=torch.float32, device=buf.device)
        step.launch(MODE_LOSS, buf, x, y, w, loss.data_ptr())
        ctx.save_for_backward(buf, x, y, w)
        ctx.dims = dims
        return loss

    @staticmethod
    def backward(ctx, g):
        buf, x, y, w = ctx.saved_tensors
        step = train_step(x.shape[0], ctx.dims, buf.device)
        loss = torch.empty((), dtype=torch.float32, device=buf.device)
        grad = torch.empty_like(buf)
        g = g.to(torch.float32).contiguous()
        step.launch(MODE_GRAD, buf, x, y, w, loss.data_ptr(),
                    grad.data_ptr(), g.data_ptr())
        return grad, None, None, None, None


def mlp_value_and_grad(buf: torch.Tensor, dims: tuple, x: torch.Tensor,
                       y: torch.Tensor, w: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss [], gradient [P]) of mean(w * (mlp(x) - y) ** 2) at the packed
    params ``buf``: ONE K10 launch for CUDA tensors (no autograd tape), the
    twin's autograd for CPU tensors (the reference's jax.value_and_grad).
    Fresh outputs each call (train.py's _fit launches its prepared
    TrainStep into buffers of its own)."""
    dev = buf.device
    if dev.type == "cpu":
        p = buf.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = mlp_loss_ref(p, dims, x, y, w)
            (grad,) = torch.autograd.grad(loss, p)
        return loss.detach(), grad
    if dev.type != "cuda":
        raise ValueError(f"mlp_value_and_grad: unsupported device {dev}")
    step = train_step(x.shape[0], dims, dev)
    step.check(buf, x, y, w)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    grad = torch.empty_like(buf)
    step.launch(MODE_GRAD, buf, x, y, w, loss.data_ptr(), grad.data_ptr())
    return loss, grad
