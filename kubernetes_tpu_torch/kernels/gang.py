"""K7 gang admission: wrappers around csrc/gang_pack.cu (K7a) and
csrc/gang_capacity.cu (K7b), and their twins.

- ``pack_gangs`` (K7a): the fused gang packer. On the card: K1 on the G
  representative rows (the static filter mask), then one launch of the
  packer kernel, which walks the gangs in order inside one thread block
  and updates copies of the carried free/nzr in place.
- ``gang_capacity`` (K7b): the host-fallback PreFilter's capacity bound,
  one reduction over a [N, R] free matrix (a view of the mirror's
  device-resident blob is read in place) to a device scalar that the
  caller pulls with its cycle's other verdicts.

The twins are ``ops/gang.py`` (``pack_gangs``, ``pack_core``,
``capacity``). Each wrapper launches its kernel for CUDA tensors and runs
the twin only for CPU tensors; a build or launch failure raises.
"""

from __future__ import annotations

import ctypes

import torch

from kubernetes_tpu_torch.kernels import build as KB
from kubernetes_tpu_torch.ops import gang as OG

pack_gangs_ref = OG.pack_gangs
pack_core_ref = OG.pack_core
capacity_ref = OG.capacity

# launch width of both kernels (one block): csrc/gang_pack.cu THREADS
THREADS = 1024
HIST_BINS = OG.KEY_STRIDE


# ---------------------------------------------------------------- K7a

_PACK_DIMS = ("G", "N", "R", "d_cap", "tk", "fit_on", "dom_stride")
_PACK_POINTERS = ("free", "nzr", "nom", "static_ok", "topo", "req", "nzreq",
                  "need", "own_nom", "ok", "alloc", "cap", "spans", "guard",
                  "capn", "dom", "dcap", "rank", "by_rank", "used", "hist")


class _PackArgs(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_int) for name in _PACK_DIMS]
                + [(name, ctypes.c_void_p) for name in _PACK_POINTERS])


def pack_core(free0: torch.Tensor, nzr0: torch.Tensor, nom: torch.Tensor,
              static_ok: torch.Tensor, topo_dom: torch.Tensor, tk: int,
              req: torch.Tensor, nzreq: torch.Tensor, need: torch.Tensor,
              own_nom: torch.Tensor | None, d_cap: int, fit_on: bool
              ) -> OG.GangPackResult:
    """K7a after K1: one launch over the phase-1 mask ``static_ok``
    [G, N]. ``topo_dom`` is the cluster's [N, TK] topology table (read in
    place, column ``tk``); free0/nzr0 are copied, and the copies carry
    the gangs' commits. The twin for CPU tensors."""
    dev = free0.device
    if dev.type == "cpu":
        return pack_core_ref(free0, nzr0, nom, static_ok,
                             OG.pack_domain(topo_dom, tk, d_cap), req,
                             nzreq, need, own_nom, d_cap, fit_on)
    if dev.type != "cuda":
        raise ValueError(f"pack_gangs: unsupported device {dev}")
    g, n = static_ok.shape
    r = free0.shape[1]
    if d_cap < 1:
        raise ValueError(f"pack_gangs: d_cap {d_cap} < 1")
    if topo_dom.stride(1) != 1:
        raise ValueError("pack_gangs: topo_dom rows must be contiguous")
    f32, i32, u8, i64 = torch.float32, torch.int32, torch.bool, torch.int64
    col = max(int(tk), 0)
    topo = topo_dom[:, col]
    table = {
        "free": (free0.clone(memory_format=torch.contiguous_format), f32,
                 (n, r)),
        "nzr": (nzr0.clone(memory_format=torch.contiguous_format), f32,
                (n, 2)),
        "nom": (nom.contiguous(), f32, (n, r)),
        "static_ok": (static_ok.contiguous(), u8, (g, n)),
        "req": (req.contiguous(), f32, (g, r)),
        "nzreq": (nzreq.contiguous(), f32, (g, 2)),
        "need": (need.to(i32).contiguous(), i32, (g,)),
        "ok": (torch.empty((g,), dtype=u8, device=dev), u8, (g,)),
        "alloc": (torch.empty((g, n), dtype=i32, device=dev), i32, (g, n)),
        "cap": (torch.empty((g,), dtype=i32, device=dev), i32, (g,)),
        "spans": (torch.empty((g,), dtype=i32, device=dev), i32, (g,)),
        "guard": (torch.empty((), dtype=i32, device=dev), i32, ()),
        "capn": (torch.empty((n,), dtype=i32, device=dev), i32, (n,)),
        "dom": (torch.empty((n,), dtype=i32, device=dev), i32, (n,)),
        "dcap": (torch.empty((d_cap,), dtype=i64, device=dev), i64,
                 (d_cap,)),
        "rank": (torch.empty((d_cap,), dtype=i32, device=dev), i32,
                 (d_cap,)),
        "by_rank": (torch.empty((d_cap,), dtype=i32, device=dev), i32,
                    (d_cap,)),
        "used": (torch.empty((d_cap,), dtype=i32, device=dev), i32,
                 (d_cap,)),
        "hist": (torch.empty((HIST_BINS,), dtype=i64, device=dev), i64,
                 (HIST_BINS,)),
    }
    if own_nom is not None:
        table["own_nom"] = (own_nom.to(i32).contiguous(), i32, (g, n))
    args = _PackArgs(G=g, N=n, R=r, d_cap=int(d_cap), tk=int(tk),
                     fit_on=int(bool(fit_on)),
                     dom_stride=int(topo_dom.stride(0)))
    for name, (t, dtype, shape) in table.items():
        KB.require(t, name, dtype, shape, dev)
        setattr(args, name, t.data_ptr())
    if topo.device != dev or topo.dtype != i32:
        raise ValueError("pack_gangs: topo_dom must be i32 on the device")
    args.topo = topo.data_ptr()
    args.own_nom = table["own_nom"][0].data_ptr() if own_nom is not None \
        else None
    launch = KB.library("gang_pack").gang_pack_launch
    launch.argtypes = [ctypes.POINTER(_PackArgs), ctypes.c_void_p]
    launch.restype = ctypes.c_int
    KB.check("gang_pack", launch(ctypes.byref(args), KB.stream_handle()))
    KB.LAUNCHES["gang_pack"] += 1
    t = {name: tt for name, (tt, _, _) in table.items()}
    return OG.GangPackResult(ok=t["ok"], alloc=t["alloc"], cap=t["cap"],
                             spans=t["spans"], free=t["free"], nzr=t["nzr"],
                             guard=t["guard"])


def pack_gangs(cblobs, gblobs, wk: dict, caps, need, tk: int,
               d_cap: int = 8, enabled_filters=None, active=None,
               pfields=None, ptmpl=None, state=None,
               own_nom=None) -> OG.GangPackResult:
    """K7 on the card (K1 on the representative rows, then K7a), the twin
    ``ops/gang.py:pack_gangs`` for CPU tensors. Arguments as the twin's;
    ``own_nom`` None means no gang has a nominated member."""
    dev = cblobs.node_f32.device
    if dev.type == "cpu":
        return pack_gangs_ref(cblobs, gblobs, wk, caps, need, tk, d_cap,
                              enabled_filters, active, pfields, ptmpl,
                              state, own_nom)
    (static_ok, free0, nzr0, nom, req, nzreq, fit_on,
     topo_dom) = OG.pack_inputs(cblobs, gblobs, wk, caps, enabled_filters,
                                active, pfields, ptmpl, state)
    need_t = torch.as_tensor(need, dtype=torch.int32).to(dev)
    onom = (None if own_nom is None
            else torch.as_tensor(own_nom, dtype=torch.int32).to(dev))
    return pack_core(free0, nzr0, nom, static_ok, topo_dom, tk, req, nzreq,
                     need_t, onom, d_cap, fit_on)


# ---------------------------------------------------------------- K7b

class _CapArgs(ctypes.Structure):
    _fields_ = [("N", ctypes.c_int), ("R", ctypes.c_int),
                ("free_stride", ctypes.c_int),
                ("free", ctypes.c_void_p), ("req", ctypes.c_void_p),
                ("out", ctypes.c_void_p)]


def gang_capacity(free: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """K7b: the capacity bound as a 0-d i32 tensor on ``free``'s device,
    never synchronised here (the caller pulls it with its cycle's
    verdicts). ``free`` may be a row-strided view (the mirror's resident
    blob); the twin for CPU tensors."""
    dev = free.device
    if dev.type == "cpu":
        return capacity_ref(free, req)
    if dev.type != "cuda":
        raise ValueError(f"gang_capacity: unsupported device {dev}")
    n, r = free.shape
    if free.dtype != torch.float32 or free.stride(1) != 1:
        raise ValueError("gang_capacity: free must be f32 with contiguous "
                         "rows")
    req = req.to(device=dev, dtype=torch.float32).contiguous()
    KB.require(req, "req", torch.float32, (r,), dev)
    out = torch.empty((), dtype=torch.int32, device=dev)
    args = _CapArgs(N=n, R=r, free_stride=int(free.stride(0)),
                    free=free.data_ptr(), req=req.data_ptr(),
                    out=out.data_ptr())
    launch = KB.library("gang_capacity").gang_capacity_launch
    launch.argtypes = [ctypes.POINTER(_CapArgs), ctypes.c_void_p]
    launch.restype = ctypes.c_int
    KB.check("gang_capacity", launch(ctypes.byref(args),
                                     KB.stream_handle()))
    KB.LAUNCHES["gang_capacity"] += 1
    return out
