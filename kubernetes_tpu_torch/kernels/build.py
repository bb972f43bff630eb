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

``LAUNCHES`` counts, per ``__global__`` entry the wrappers launch, the
launches on the card (twin calls on CPU tensors do not count;
topo_statics counts K5's one cooperative launch of its three stages,
preempt_feasible K6b's one launch of a dry run's fold with its spread
minima).
K9, the learned score term, is a device function
in ``learned_mlp.cuh`` that K2a and K3 include; ``learned_mlp`` counts
every launch that runs it: a K2a bid round or a K3 scan carrying learned
params, and its standalone probe (learned_mlp.cu), which no scheduling
path runs. K3 has two more: ``scan_port_conf`` counts its in-batch
hostPort pre-pass (an ordinary launch before the scan), and
``serial_scan_global_carries`` the scans whose carries did not all fit
in shared memory (kernels/scan.py plan_scan) and ``serial_scan_narrow``
the scans of the narrow instantiation (kernels/scan.py narrow_launch). K7a's
``gang_pack_global`` counts the packer launches that left some node-slice
or domain array in global memory (kernels/gang.py plan_pack); K2b's
``auction_accept_commit_global`` the K-accept rounds whose choice lists
were in a global scratch (kernels/auction.py plan_commit); K4's
``soft_scores_global`` the rounds whose domain maps stayed in global
memory (kernels/soft.py plan_soft). ``auction_export`` counts K2a's
end-state export pass; ``learned_train`` K10, the trainer's step, one
launch a step (csrc/learned_train.cu; its loss mode too);
``chain_patch`` K11, the usage chain's patch (csrc/chain_patch.cu);
``row_scatter`` K12, the dirty rows into the resident blobs and the
victim cumsum (csrc/row_scatter.cu); ``blob_unpack`` K13, the chain's
seed and the typed unpacks (csrc/blob_unpack.cu).
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
           "learned_mlp", "learned_train", "chain_patch", "row_scatter",
           "blob_unpack")

# launch counters: one per kernel, and the variants named above
COUNTERS = ("phase1_static", "auction_score_argmax", "auction_accept_commit",
            "topo_statics", "serial_scan",
            "soft_scores", "preempt_sweep", "preempt_feasible", "gang_pack",
            "gang_capacity", "dra_feasible",
            "learned_mlp", "scan_port_conf", "serial_scan_global_carries",
            "auction_export", "learned_train",
            "gang_pack_global", "auction_accept_commit_global",
            "soft_scores_global", "serial_scan_narrow", "chain_patch",
            "row_scatter", "blob_unpack")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas=-v")

LAUNCHES: dict[str, int] = {k: 0 for k in COUNTERS}

# seconds each source's nvcc took in the last build_all that built it
BUILD_SECONDS: dict[str, float] = {}

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
    together (each one's seconds in BUILD_SECONDS). Returns the wall
    seconds spent; raises with nvcc's output when a build fails."""
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
        log = open(tmp + ".log", "w+b")  # noqa: SIM115 (closed below)
        procs.append((name, out, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    done: dict = {}
    while len(done) < len(procs):
        for name, _, _, _, p in procs:
            if name not in done and p.poll() is not None:
                done[name] = time.time() - t0
        time.sleep(0.05)
    if src_dir != SRC_DIR:
        tag = os.path.basename(os.path.dirname(os.path.abspath(src_dir)))
        done = {f"{k}@{tag}": v for k, v in done.items()}
    BUILD_SECONDS.update(done)
    errors = []
    for name, out, tmp, log, p in procs:
        log.seek(0)
        text = log.read()
        log.close()
        os.remove(tmp + ".log")
        if p.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({p.returncode}):\n"
                          + text.decode(errors="replace"))
        else:
            os.replace(tmp, out)
            with open(out + ".log", "wb") as fh:
                fh.write(text)
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


def _variant_path(name: str, defines: tuple) -> str:
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    src = os.path.join(SRC_DIR, name + ".cu")
    tag = "-".join(defines).lower().replace("=", "")
    return os.path.join(BUILD_DIR,
                        f"lib{name}-{source_digest(src, flags)}-{tag}.so")


def build_variant(name: str, defines: tuple) -> ctypes.CDLL:
    """A measurement build of one source with extra preprocessor defines
    (``("SCAN_PROFILE",)``, ``("EXP_K9_MIN_CTAS=1",)``): its own library
    beside the scheduling one (ptxas's report beside it: variant_log),
    loaded and returned; never what the wrappers launch by default."""
    key = name + "+" + "+".join(defines)
    lib = _LIBS.get(key)
    if lib is None:
        flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
        src = os.path.join(SRC_DIR, name + ".cu")
        path = _variant_path(name, defines)
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
            with open(path + ".log", "wb") as fh:
                fh.write(p.stdout)
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        _LIBS[key] = lib
    return lib


_PTXAS = re.compile(r"Compiling entry function '(\w+)'|"
                    r"Function properties for (\w+)|"
                    r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads|"
                    r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def build_log(name: str, src_dir: str = SRC_DIR) -> dict:
    """ptxas's report for each __global__ entry and each device function
    of its own (``__noinline__``) of one built source: {mangled name:
    {registers, spill_stores, spill_loads, stack, smem}} (a device
    function has no registers or smem of its own; static shared memory;
    a kernel's dynamic shared memory is its launch's)."""
    return _parse_log(_lib_path(name, src_dir) + ".log")


def variant_log(name: str, defines: tuple) -> dict:
    """build_log of a measurement build (build_variant)."""
    return _parse_log(_variant_path(name, defines) + ".log")


def _parse_log(path: str) -> dict:
    out: dict = {}
    cur = None
    if not os.path.exists(path):
        return out
    with open(path, encoding="utf-8", errors="replace") as fh:
        for m in _PTXAS.finditer(fh.read()):
            if m.group(1) or m.group(2):
                cur = out.setdefault(m.group(1) or m.group(2), {})
            elif cur is None:
                continue
            elif m.group(3):
                cur.update(stack=int(m.group(3)),
                           spill_stores=int(m.group(4)),
                           spill_loads=int(m.group(5)))
            elif m.group(6):
                cur.update(registers=int(m.group(6)),
                           smem=int(m.group(7) or 0))
    return out


def check(name: str, code: int) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        msg = library(name).kernel_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


_RAW_STREAM: list = []


def stream_handle(index=None) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream of device ``index`` (the current
    device where None) as a pointer for the C entries: the raw handle,
    without making a Stream object where this torch has the call
    (``torch._C._cuda_getCurrentRawStream``)."""
    import torch

    if not _RAW_STREAM:
        _RAW_STREAM.append(getattr(
            torch._C, "_cuda_getCurrentRawStream",
            lambda i: torch.cuda.current_stream(i).cuda_stream))
    if index is None:
        index = torch.cuda.current_device()
    return ctypes.c_void_p(_RAW_STREAM[0](index))


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
