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

``LAUNCHES`` counts, per ``__global__`` entry the wrappers launch (a
source may hold several: topo_statics.cu holds the three K5 stages,
soft_scores.cu the two K4 stages, preempt_feasible.cu K6b's spread
minimum and its fold), the launches on the card (twin calls on CPU
tensors do not count). K9, the learned score term, is a device function
in ``learned_mlp.cuh`` that K2a and K3 include; ``learned_mlp`` counts
every launch that runs it: a K2a bid round or a K3 scan carrying learned
params, and its standalone probe (learned_mlp.cu), which no scheduling
path runs.
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
            "learned_mlp")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false")

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


def _lib_path(name: str) -> str:
    digest = source_digest(os.path.join(SRC_DIR, name + ".cu"))
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_all(names=KERNELS) -> float:
    """Compile every missing library, one nvcc per source, all started
    together. Returns the wall seconds spent; raises with nvcc's output
    when a build fails."""
    t0 = time.time()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(SRC_DIR, name + ".cu")]
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
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.time() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel. The first use of a missing one
    builds every missing kernel, in parallel, so a drain pays the build
    once, at its first launch, and not again when a later batch first
    needs another kernel (a topology batch after plain ones)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not os.path.exists(path):
            build_all()
        lib = ctypes.CDLL(path)
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return lib


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
