"""K13 the blob unpack: the wrapper around csrc/blob_unpack.cu and its
twin (``ops/blobs.py`` ``fields_ref``).

``unpack_fields`` takes ``(codec, blobs, names)`` parts and returns, for
each part, ``{name: tensor}``: every named field of the part's blobs as a
contiguous typed tensor of its own (f32, i32, or bool for a bool field),
shaped as ``BlobCodec.field`` views it. This is the one place that
routes: CUDA blobs launch K13 once for every field of every part, into
one new device allocation that the fields view at 16-byte-aligned
offsets; CPU blobs run the twin. A build or launch failure raises.

Its callers: ``seed`` (the usage chain's seed, ``extract_state``),
``unpack_cluster`` (``Mirror.to_device``) and ``unpack_pods``
(``Mirror.pack_batch``). The launches themselves keep reading views of
the blobs (``ops/features.py`` ``unpack_*``): K13 serves where the
reference made new arrays, not where a view serves.
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
ALIGN = 16


class _UnpackArgs(ctypes.Structure):
    _fields_ = [("nsrc", ctypes.c_int), ("nfields", ctypes.c_int),
                ("src_rows", ctypes.c_int * MAX_SRC),
                ("src_stride", ctypes.c_long * MAX_SRC),
                ("src", ctypes.c_void_p * MAX_SRC),
                ("dst", ctypes.c_void_p),
                ("f_src", ctypes.c_int * MAX_FIELDS),
                ("f_col", ctypes.c_int * MAX_FIELDS),
                ("f_width", ctypes.c_int * MAX_FIELDS),
                ("f_bool", ctypes.c_int * MAX_FIELDS),
                ("f_dst", ctypes.c_long * MAX_FIELDS)]


_DTYPES = {"f32": torch.float32, "i32": torch.int32, "bool": torch.bool}

# launch plans by (codec, names, blob shapes) of every part: the argument
# struct without its pointers, each source's (part, kind), the output
# bytes and each field's (part, name, byte offset, bytes, dtype, shape)
_PLANS: dict = {}


def _plan(parts) -> tuple:
    key = tuple((id(codec), names, tuple(blobs.f32.shape),
                 tuple(blobs.i32.shape)) for codec, blobs, names in parts)
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
    template, srcs, total, fields = _plan(parts)
    args = _UnpackArgs.from_buffer_copy(template)
    for s, (p, kind) in enumerate(srcs):
        blob = getattr(parts[p][1], kind)
        if blob.device != dev or not blob.is_contiguous() \
                or blob.dtype != _DTYPES[kind]:
            raise ValueError(f"blob_unpack: the {kind} blob must be a "
                             f"contiguous {kind} tensor on {dev}")
        args.src[s] = blob.data_ptr()
    buf = torch.empty((total,), dtype=torch.uint8, device=dev)
    args.dst = buf.data_ptr()
    launch = KB.library("blob_unpack").blob_unpack_launch
    launch.argtypes = [ctypes.POINTER(_UnpackArgs), ctypes.c_void_p]
    launch.restype = ctypes.c_int
    KB.check("blob_unpack", launch(ctypes.byref(args), KB.stream_handle()))
    KB.LAUNCHES["blob_unpack"] += 1
    out: list[dict] = [{} for _ in parts]
    for p, name, off, nbytes, dtype, shape in fields:
        out[p][name] = buf[off:off + nbytes].view(dtype).view(shape)
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
    node_codec = codecs(caps)[0]
    (f,) = unpack_fields([(node_codec, Blobs(f32=cblobs.node_f32,
                                             i32=cblobs.node_i32),
                           ("free", "nonzero_requested"))])
    return Seed((f["free"], f["nonzero_requested"]))


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
