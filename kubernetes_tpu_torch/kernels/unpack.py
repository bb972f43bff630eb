"""K13 the blob unpack: the wrapper around csrc/blob_unpack.cu and its
twin (``ops/blobs.py`` ``fields_ref``).

``unpack_fields`` takes ``(codec, blobs, names)`` parts and returns, for
each part, ``{name: tensor}``: every named field of the part's blobs as a
contiguous typed tensor of its own (f32, i32, or bool for a bool field),
shaped as ``BlobCodec.field`` views it. This is the one place that
routes: CUDA blobs launch K13 once for every field of every part, into
one new device allocation that the fields view at 16-byte-aligned
offsets; CPU blobs run the twin. A build or launch failure raises.

The launch path is prepared once a plan (``Prepared``): the C entry is
bound with its argument types at the plan's first launch, the plan keeps
its argument block (``_FewArgs`` for up to MAX_FEW fields, else
``_UnpackArgs``) and rewrites only the source and output pointers a
call, and the outputs' dtypes, shapes and offsets are computed once. A
call still makes a new allocation and new views: a seed must be tensors
that nothing else holds. Plans are launched from one thread at a time,
as every wrapper of the port is.

Its callers: ``seed`` (the usage chain's seed, ``extract_state``; its
plan is found by the caps' identity and the blob's shape, without
hashing the caps), ``unpack_cluster`` (``Mirror.to_device``) and
``unpack_pods`` (``Mirror.pack_batch``). The launches themselves keep
reading views of the blobs (``ops/features.py`` ``unpack_*``): K13
serves where the reference made new arrays, not where a view serves.
"""

from __future__ import annotations

import ctypes

import torch

from kubernetes_tpu_torch.kernels import build as KB
from kubernetes_tpu_torch.ops.blobs import Blobs, fields_ref
from kubernetes_tpu_torch.ops.features import (
    ClusterBlobs,
    ClusterTensors,
    PodBlobs,
    PodFeatures,
    codecs,
)

MAX_SRC = 4
MAX_FIELDS = 96
MAX_FEW = 4
ALIGN = 16


def _members(n: int) -> list:
    return [("nsrc", ctypes.c_int), ("nfields", ctypes.c_int),
            ("src_rows", ctypes.c_int * MAX_SRC),
            ("src_stride", ctypes.c_long * MAX_SRC),
            ("src", ctypes.c_void_p * MAX_SRC),
            ("dst", ctypes.c_void_p),
            ("f_src", ctypes.c_int * n),
            ("f_col", ctypes.c_int * n),
            ("f_width", ctypes.c_int * n),
            ("f_bool", ctypes.c_int * n),
            ("f_dst", ctypes.c_long * n),
            ("f_lg", ctypes.c_int * n),
            ("f_tile0", ctypes.c_int * (n + 1))]


class _UnpackArgs(ctypes.Structure):
    _fields_ = _members(MAX_FIELDS)


class _FewArgs(ctypes.Structure):
    _fields_ = _members(MAX_FEW)


_DTYPES = {"f32": torch.float32, "i32": torch.int32, "bool": torch.bool}
_PER_FIELD = ("f_src", "f_col", "f_width", "f_bool", "f_dst")

# launch layouts by (codec, names, blob shapes) of every part: the argument
# struct without its pointers, each source's (part, kind), the output
# bytes and each field's (part, name, byte offset, bytes, dtype, shape)
_PLANS: dict = {}


def _key(parts) -> tuple:
    return tuple((id(codec), names, tuple(blobs.f32.shape),
                  tuple(blobs.i32.shape)) for codec, blobs, names in parts)


def _plan(parts) -> tuple:
    key = _key(parts)
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    srcs: list[tuple[int, str]] = []
    args = _UnpackArgs()
    fields = []
    total = 0
    for p, (codec, blobs, names) in enumerate(parts):
        for name in names:
            shape, kind = codec.schema[name]
            blob_kind = "f32" if kind == "f32" else "i32"
            blob = getattr(blobs, blob_kind)
            col, width = (codec._f32_off if kind == "f32"
                          else codec._i32_off)[name]
            if (p, blob_kind) not in srcs:
                s = len(srcs)
                if s == MAX_SRC:
                    raise ValueError(f"blob_unpack: more than {MAX_SRC} "
                                     f"blobs")
                srcs.append((p, blob_kind))
                args.src_rows[s] = blob.numel() // blob.shape[-1]
                args.src_stride[s] = blob.shape[-1]
            f = len(fields)
            if f == MAX_FIELDS:
                raise ValueError(f"blob_unpack: more than {MAX_FIELDS} "
                                 f"fields")
            args.f_src[f] = srcs.index((p, blob_kind))
            args.f_col[f], args.f_width[f] = col, width
            args.f_bool[f] = int(kind == "bool")
            args.f_dst[f] = total
            nbytes = (blob.numel() // blob.shape[-1]) * width * (
                1 if kind == "bool" else 4)
            fields.append((p, name, total, nbytes, _DTYPES[kind],
                           tuple(blob.shape[:-1]) + shape))
            total += -(-nbytes // ALIGN) * ALIGN
    args.nsrc, args.nfields = len(srcs), len(fields)
    plan = _PLANS[key] = (args, srcs, max(total, ALIGN), fields)
    return plan


class Prepared:
    """One layout's launch, prepared once: its argument block (the small
    one for up to MAX_FEW fields), the sources' expected (dtype, shape)
    and device, the outputs' allocation and views. ``bind`` refreshes the
    pointers of a call, ``launch`` also launches and views the outputs."""

    def __init__(self, parts):
        template, self.srcs, total, self.fields = _plan(parts)
        self.codecs = tuple(codec for codec, _, _ in parts)  # ids stay
        few = template.nfields <= MAX_FEW
        self.args = (_FewArgs if few else _UnpackArgs)()
        self.entry = "blob_unpack_few_launch" if few else "blob_unpack_launch"
        a = self.args
        a.nsrc, a.nfields = template.nsrc, template.nfields
        for s in range(template.nsrc):
            a.src_rows[s] = template.src_rows[s]
            a.src_stride[s] = template.src_stride[s]
        for name in _PER_FIELD:
            dst, src = getattr(a, name), getattr(template, name)
            for f in range(template.nfields):
                dst[f] = src[f]
        self.pargs = ctypes.byref(a)
        self.expect = [(_DTYPES[kind], getattr(parts[p][1], kind).shape)
                       for p, kind in self.srcs]
        self.device = parts[0][1].i32.device
        # one allocation: of the fields' dtype when they share one, else
        # bytes that each other dtype views once
        kinds = {dtype for _, _, _, _, dtype, _ in self.fields}
        self.alloc = kinds.pop() if len(kinds) == 1 else torch.uint8
        size = torch.empty((), dtype=self.alloc).element_size()
        self.numel = total // size
        self.retype = [dt for dt in {f[4] for f in self.fields}
                       if dt != self.alloc]
        self.views = []
        for _, _, off, _, dtype, shape in self.fields:
            stride, step = [], 1
            for n in reversed(shape):
                stride.append(step)
                step *= n
            item = torch.empty((), dtype=dtype).element_size()
            self.views.append((-1 if dtype == self.alloc
                               else self.retype.index(dtype), shape,
                               tuple(reversed(stride)), off // item))
        self.fn = None

    def bind(self, blobs) -> torch.Tensor:
        """The call's sources (one a ``srcs`` entry, in order) checked and
        their pointers written, a new output allocation and its pointer:
        the allocation."""
        a = self.args
        for s, (t, (dtype, shape)) in enumerate(zip(blobs, self.expect)):
            if t.device != self.device or t.dtype != dtype \
                    or t.shape != shape or not t.is_contiguous():
                raise ValueError(f"blob_unpack: source {s} must be a "
                                 f"contiguous {dtype} {tuple(shape)} tensor "
                                 f"on {self.device}")
            a.src[s] = t.data_ptr()
        buf = torch.empty((self.numel,), dtype=self.alloc,
                          device=self.device)
        a.dst = buf.data_ptr()
        return buf

    def outputs(self, buf: torch.Tensor) -> list:
        """Each field's view of the allocation, in the plan's order."""
        typed = [buf.view(dt) for dt in self.retype]
        return [(buf if k < 0 else typed[k]).as_strided(shape, stride, off)
                for k, shape, stride, off in self.views]

    def launch(self, blobs) -> list:
        """K13 once: each field a new tensor, in the plan's order."""
        buf = self.bind(blobs)
        fn = self.fn
        if fn is None:
            fn = getattr(KB.library("blob_unpack"), self.entry)
            fn.argtypes = [ctypes.POINTER(type(self.args)), ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self.fn = fn
        KB.check("blob_unpack",
                 fn(self.pargs, KB.stream_handle(self.device.index)))
        KB.LAUNCHES["blob_unpack"] += 1
        return self.outputs(buf)


# prepared launches by the _plan key; the chain's seed by (id(caps), the
# node blobs' shapes), its entry holding the caps (so the id stays theirs)
_PREPARED: dict = {}
_SEEDS: dict = {}
SEED_FIELDS = ("free", "nonzero_requested")


def prepared(parts) -> Prepared:
    key = _key(parts)
    prep = _PREPARED.get(key)
    if prep is None:
        prep = _PREPARED[key] = Prepared(parts)
    return prep


def unpack_fields(parts) -> list[dict]:
    """K13: ``[{name: tensor}]``, one dict a ``(codec, blobs, names)``
    part (module docstring)."""
    parts = [(codec, blobs, tuple(names)) for codec, blobs, names in parts]
    dev = parts[0][1].i32.device
    if dev.type == "cpu":
        return [fields_ref(codec, blobs, names)
                for codec, blobs, names in parts]
    if dev.type != "cuda":
        raise ValueError(f"blob_unpack: unsupported device {dev}")
    prep = prepared(parts)
    tensors = prep.launch([getattr(parts[p][1], kind)
                           for p, kind in prep.srcs])
    out: list[dict] = [{} for _ in parts]
    for (p, name, *_), t in zip(prep.fields, tensors):
        out[p][name] = t
    return out


class Seed(tuple):
    """(free, nzr) made by ``seed``: new contiguous tensors that nothing
    else holds, so the launch they seed (models/pipeline.py round_inputs
    and _serial_commit, kernels/gang.py pack_core) takes them as its
    working state in place of copies. A chained state is a plain tuple
    (pending waves and dry runs still hold it) and is copied."""


def seed(cblobs: ClusterBlobs, caps) -> Seed:
    """(free [N, R], nonzero_requested [N, 2]) of the node blob, new
    contiguous tensors: the usage chain's seed."""
    f32, i32 = cblobs.node_f32, cblobs.node_i32
    if not f32.is_cuda:
        (f,) = unpack_fields([(codecs(caps)[0], Blobs(f32=f32, i32=i32),
                               SEED_FIELDS)])
        return Seed((f["free"], f["nonzero_requested"]))
    hit = _SEEDS.get((id(caps), f32.shape, i32.shape))
    if hit is None:
        prep = prepared([(codecs(caps)[0], Blobs(f32=f32, i32=i32),
                          SEED_FIELDS)])
        hit = _SEEDS[id(caps), f32.shape, i32.shape] = (
            caps, prep, tuple(kind == "f32" for _, kind in prep.srcs))
    _, prep, is_f32 = hit
    return Seed(prep.launch([f32 if k else i32 for k in is_f32]))


def unpack_cluster(cblobs: ClusterBlobs, caps) -> ClusterTensors:
    """Every ClusterTensors field of the blobs, contiguous, in one
    launch."""
    node_codec, table_codec, _ = codecs(caps)
    empty = torch.zeros(cblobs.pods_i32.shape[:-1] + (0,),
                        dtype=torch.float32, device=cblobs.pods_i32.device)
    node, table = unpack_fields([
        (node_codec, Blobs(f32=cblobs.node_f32, i32=cblobs.node_i32),
         node_codec.schema),
        (table_codec, Blobs(f32=empty, i32=cblobs.pods_i32),
         table_codec.schema)])
    return ClusterTensors(**node, **table)


def unpack_pods(pblobs: PodBlobs, caps) -> PodFeatures:
    """Every PodFeatures field of a full-schema pod batch, contiguous, in
    one launch."""
    pod_codec = codecs(caps)[2]
    (f,) = unpack_fields([(pod_codec, Blobs(f32=pblobs.f32, i32=pblobs.i32),
                           pod_codec.schema)])
    return PodFeatures(**f)
