"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc for sm_90a into its own shared library
with a plain C interface, loaded with ctypes (no PyTorch headers, so a
build takes seconds). Sources build in parallel, one nvcc each, all at
the first use of any; the library name carries a hash of the source,
of every local header it includes (``#include "..."``, followed
recursively) and of the flags, so an edited kernel or header is rebuilt.
Outputs go to ``build/kernels/`` at the root of the checkout.

Flags: ``-fmad=false`` forbids multiply-add contraction, so every kernel
rounds its float arithmetic exactly as its plain-torch twin (and the JAX
reference) does, and placements can be compared bit for bit.
``-Xptxas=-v`` makes ptxas report each kernel's registers, spills and
shared memory; the report is kept beside the library (``build_log``).

``LAUNCHES`` counts, per ``__global__`` entry the wrappers launch (a
source may hold several: topo_statics.cu holds the three K5 stages,
soft_scores.cu the two K4 stages, preempt_feasible.cu K6b's spread
minimum and its fold), the launches on the card (twin calls on CPU
tensors do not count). K9, the learned score term, is a device function
in ``learned_mlp.cuh`` that K2a and K3 include; ``learned_mlp`` counts
every launch that runs it: a K2a bid round or a K3 scan carrying learned
params, and its standalone probe (learned_mlp.cu), which no scheduling
path runs. K3 has two more: ``scan_port_conf`` counts its in-batch
hostPort pre-pass (an ordinary launch before the scan), and
``serial_scan_global_carries`` the scans whose carries did not all fit
in shared memory (kernels/scan.py plan_scan).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")

KERNELS = ("phase1_static", "auction_score_argmax", "auction_accept_commit",
           "topo_statics", "serial_scan", "soft_scores", "preempt_sweep",
           "preempt_feasible", "gang_pack", "gang_capacity", "dra_feasible",
           "learned_mlp")

# launch counters: one per kernel, one per K5, K4 and K6b stage
COUNTERS = ("phase1_static", "auction_score_argmax", "auction_accept_commit",
            "topo_table", "topo_nodes", "topo_pairs", "serial_scan",
            "soft_scatter", "soft_gather", "preempt_sweep", "feasible_min",
            "preempt_feasible", "gang_pack", "gang_capacity", "dra_feasible",
            "learned_mlp", "scan_port_conf", "serial_scan_global_carries")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas=-v")

LAUNCHES: dict[str, int] = {k: 0 for k in COUNTERS}

_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return path


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_digest(path: str, flags=NVCC_FLAGS) -> str:
    """Hash of a source, of the local headers it includes (each once,
    followed recursively, relative to the including file) and of the
    flags: the name of the library built from it."""
    digest = hashlib.sha256(" ".join(flags).encode())
    seen: set[str] = set()
    todo = [os.path.abspath(path)]
    while todo:
        f = todo.pop(0)
        if f in seen:
            continue
        seen.add(f)
        with open(f, "rb") as fh:
            text = fh.read()
        digest.update(os.path.basename(f).encode() + b"\0" + text)
        todo.extend(os.path.join(os.path.dirname(f), inc.decode())
                    for inc in _LOCAL_INCLUDE.findall(text))
    return digest.hexdigest()[:12]


def _lib_path(name: str, src_dir: str = SRC_DIR) -> str:
    digest = source_digest(os.path.join(src_dir, name + ".cu"))
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_all(names=KERNELS, src_dir: str = SRC_DIR) -> float:
    """Compile every missing library, one nvcc per source, all started
    together. Returns the wall seconds spent; raises with nvcc's output
    when a build fails."""
    t0 = time.time()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name, src_dir)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(src_dir, name + ".cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({p.returncode}):\n"
                          + log.decode(errors="replace"))
        else:
            os.replace(tmp, out)
            with open(out + ".log", "wb") as fh:
                fh.write(log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.time() - t0


def library(name: str, src_dir: str = SRC_DIR) -> ctypes.CDLL:
    """The loaded library of one kernel. The first use of a missing one
    builds every missing kernel, in parallel, so a drain pays the build
    once, at its first launch, and not again when a later batch first
    needs another kernel (a topology batch after plain ones). ``src_dir``
    names another directory of sources (a measurement building an older
    version of a kernel beside the current one)."""
    key = name if src_dir == SRC_DIR else os.path.join(src_dir, name)
    lib = _LIBS.get(key)
    if lib is None:
        path = _lib_path(name, src_dir)
        if not os.path.exists(path):
            build_all(KERNELS if src_dir == SRC_DIR else (name,), src_dir)
        lib = ctypes.CDLL(path)
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        _LIBS[key] = lib
    return lib


def build_variant(name: str, defines: tuple) -> ctypes.CDLL:
    """A measurement build of one source with extra preprocessor defines
    (``("SCAN_PROFILE",)``): its own library beside the scheduling one,
    loaded and returned; never what the wrappers launch by default."""
    key = name + "+" + "+".join(defines)
    lib = _LIBS.get(key)
    if lib is None:
        flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
        src = os.path.join(SRC_DIR, name + ".cu")
        path = os.path.join(BUILD_DIR, f"lib{name}-{source_digest(src, flags)}"
                                       f"-{'-'.join(defines).lower()}.so")
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            p = subprocess.run([nvcc_path(), *flags, "-o", tmp, src],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT)
            if p.returncode != 0:
                raise RuntimeError(f"nvcc {name}.cu {defines} failed "
                                   f"({p.returncode}):\n"
                                   + p.stdout.decode(errors="replace"))
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        _LIBS[key] = lib
    return lib


_PTXAS = re.compile(r"Compiling entry function '(\w+)'|"
                    r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads|"
                    r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def build_log(name: str, src_dir: str = SRC_DIR) -> dict:
    """ptxas's report for each __global__ entry of one built source:
    {mangled entry: {registers, spill_stores, spill_loads, stack, smem}}
    (static shared memory; a kernel's dynamic shared memory is its
    launch's)."""
    path = _lib_path(name, src_dir) + ".log"
    out: dict = {}
    cur = None
    if not os.path.exists(path):
        return out
    with open(path, encoding="utf-8", errors="replace") as fh:
        for m in _PTXAS.finditer(fh.read()):
            if m.group(1):
                cur = out.setdefault(m.group(1), {})
            elif cur is None:
                continue
            elif m.group(2):
                cur.update(stack=int(m.group(2)),
                           spill_stores=int(m.group(3)),
                           spill_loads=int(m.group(4)))
            elif m.group(5):
                cur.update(registers=int(m.group(5)),
                           smem=int(m.group(6) or 0))
    return out


def check(name: str, code: int) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        msg = library(name).kernel_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def stream_handle():
    """PyTorch's current CUDA stream as a pointer for the C entries."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require(t, name: str, dtype, shape, device) -> None:
    """The wrapper-side argument check: device, dtype, shape, contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
