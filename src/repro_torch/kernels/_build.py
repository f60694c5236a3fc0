"""Build, load and call the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into
``build/repro_torch/`` at the root of the checkout. The file name carries a
hash of the sources and flags, so an edited source rebuilds and an unchanged
one loads at once. All stale sources compile in parallel, one ``nvcc`` each.

Besides the build, this module holds what the kernel wrappers share:
the element kinds a kernel takes, the checks made before a launch, and the
elementwise arithmetic of the plain PyTorch versions.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.core.types import popcount32

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("buffer_fold", "delta_extract", "digest_blocks", "join",
           "lex_join", "masked_extract", "round_recv", "round_step",
           "slot_bump")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Element kinds of the kernels: (kernel kind, element dtype) -> launch code.
# Bool states travel as a zero-copy uint8 view ({0, 1}: or ≡ max); BitGSet
# words travel as int32 bit-views and are unsigned inside the kernels. The
# sync kernels take SYNC_KINDS; the elementwise kernels (join,
# delta_extract) also take int8 max, with signed compares.
KIND_CODES = {("max", torch.uint8): 0, ("max", torch.int32): 1,
              ("bitor", torch.int32): 2, ("max", torch.int8): 3}
SYNC_KINDS = (("max", torch.uint8), ("max", torch.int32),
              ("bitor", torch.int32))

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    cand = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")] \
        if os.environ.get("CUDA_HOME") else []
    cand += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every stale library among ``names`` in parallel; return
    ``{name: path}``. Raises with the compiler's output if one fails."""
    with _lock:
        paths = {n: _library_path(n) for n in names}
        stale = {n: p for n, p in paths.items() if not p.exists()}
        if not stale:
            return paths
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        for n, p in stale.items():
            tmp = p.with_suffix(f".tmp{os.getpid()}.so")
            log = open(p.with_suffix(".log"), "w")
            procs[n] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                 str(CSRC / f"{n}.cu")],
                stdout=log, stderr=subprocess.STDOUT), tmp, log)
        failed = []
        for n, (proc, tmp, log) in procs.items():
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, stale[n])
            else:
                failed.append(n)
        if failed:
            msgs = "\n".join(stale[n].with_suffix(".log").read_text()
                             for n in failed)
            raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
        return paths


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the last build of ``name``, or '' if it was not built in
    this checkout."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str, signature: dict) -> ctypes.CDLL:
    """The loaded library ``name`` (built on first use) with the C
    ``signature`` ``{function: argtypes}`` declared; every function returns
    a ``cudaError_t`` as int."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        for fn, argtypes in signature.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check_launch(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: {lib.cuda_error_string(err).decode()}")


@contextlib.contextmanager
def launching(device: torch.device):
    """Make ``device`` the current card for a launch and give the handle of
    its current stream. The launchers query and configure the current card
    and launch on the stream they are given, so a kernel whose tensors lie
    on another card than the caller's current one (a block of a sharded
    run) still runs on that card, in order with what PyTorch queued
    there."""
    with torch.cuda.device(device):
        yield ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


# -- checks shared by the wrappers --------------------------------------------

def kernel_view(t: torch.Tensor, kind: str,
                kinds=SYNC_KINDS) -> torch.Tensor:
    """The view a kernel takes of a state tensor: bool as uint8 (zero-copy),
    the other dtypes of ``kinds`` as they are. Raises on anything else."""
    if t.dtype == torch.bool:
        t = t.view(torch.uint8)
    if (kind, t.dtype) not in kinds:
        raise TypeError(f"kernel kind {kind!r} does not take {t.dtype}; "
                        f"expected one of {sorted(map(str, kinds))}")
    return t


def restore(t, dtype: torch.dtype):
    """Undo :func:`kernel_view` on an output (None passes through)."""
    if t is None or dtype != torch.bool:
        return t
    return t.view(torch.bool)


def check_cuda(name: str, *tensors) -> None:
    """All tensors on one CUDA device and contiguous (None skipped)."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, expected CUDA")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        dev = t.device
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(f"{name}: kernels are built for sm_90a, "
                           f"{torch.cuda.get_device_name(dev)} is not")


def is_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


# -- elementwise arithmetic of the plain versions ------------------------------

def join_fn(kind: str):
    if kind == "max":
        return torch.maximum
    if kind == "bitor":
        return torch.bitwise_or
    raise ValueError(f"unknown kernel kind {kind!r}")


def count(v: torch.Tensor, kind: str) -> torch.Tensor:
    """Irreducibles per element: 1 per non-⊥ entry, or the set bits of a
    packed word."""
    return popcount32(v) if kind == "bitor" else (v != 0).to(torch.int32)


def novel(d: torch.Tensor, x: torch.Tensor, kind: str):
    """``(Δ(d, x), |⇓Δ| per element)`` against the running state x."""
    if kind == "bitor":
        s = torch.bitwise_and(d, torch.bitwise_not(x))
        return s, popcount32(s)
    nov = d > x
    return torch.where(nov, d, 0), nov.to(torch.int32)
