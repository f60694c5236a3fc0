"""Elementwise lattice join c = a ⊔ b.

CUDA kernel ``csrc/join.cu`` (replacing the TPU kernel ``join_2d`` in
``src/repro/kernels/join.py``) and its plain PyTorch version, with the
contract of ``repro.kernels.ops.join``: two states of any one shape in, the
join of the same shape out.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build as B

launches = 0          # kernel launches since the last reset (CUDA only)

_SIGNATURE = {"join_launch": [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_void_p]}


def plain(a, b, kind: str = "max"):
    """Plain version: ``torch.maximum`` or ``torch.bitwise_or``."""
    return B.join_fn(kind)(a, b)


def _launch(a, b, kind: str):
    global launches
    B.check_cuda("join", a, b)
    out = torch.empty_like(a)
    lib = B.library("join", _SIGNATURE)
    with B.launching(a.device) as stream:
        err = lib.join_launch(B.KIND_CODES[(kind, a.dtype)], B.ptr(a),
                              B.ptr(b), B.ptr(out), a.numel(), stream)
    B.check_launch(lib, err, "join")
    launches += 1
    return out


def join(a, b, *, kind: str = "max"):
    """a ⊔ b of two states of one shape and dtype: ``max`` over bool,
    uint8, int8 (signed) or int32, ``bitor`` over int32 bit-views of 32-bit
    words. The JAX package's uint32 ``max`` states are taken as int32
    holding values below 2³¹, where the signed and unsigned orders agree;
    a torch uint32 tensor is refused. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (contiguous) or raises."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"join: operands {a.dtype}{tuple(a.shape)} and "
                         f"{b.dtype}{tuple(b.shape)} differ")
    av = B.kernel_view(a, kind, B.KIND_CODES)
    bv = B.kernel_view(b, kind, B.KIND_CODES)
    if B.is_cpu(av):
        out = plain(av, bv, kind)
    elif av.numel() == 0:
        out = torch.empty_like(av)
    else:
        out = _launch(av, bv, kind)
    return B.restore(out, a.dtype)
