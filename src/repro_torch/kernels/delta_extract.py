"""Fused optimal-delta extraction, the RR step: ``(Δ(d, x), x ⊔ d, |⇓Δ|)``
in one pass over (d, x).

CUDA kernel ``csrc/delta_extract.cu`` (replacing the TPU kernel
``delta_extract_2d`` in ``src/repro/kernels/delta_extract.py``) and its
plain PyTorch version, with the contract of
``repro.kernels.ops.delta_extract``: two states of any one shape in, Δ and
the join of the same shape out, and the count as an int32 0-d tensor on
the states' device (no host read).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build as B

launches = 0          # kernel launches since the last reset (CUDA only)

_SIGNATURE = {"delta_extract_launch": [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]}


def plain(d, x, kind: str = "max"):
    """Plain version: Δ and its per-element counts, the join, the sum."""
    s, per = B.novel(d, x, kind)
    return s, B.join_fn(kind)(x, d), per.sum(dtype=torch.int32)


def _launch(d, x, kind: str):
    global launches
    B.check_cuda("delta_extract", d, x)
    s, xj = torch.empty_like(d), torch.empty_like(d)
    count = torch.zeros((), dtype=torch.int32, device=d.device)
    lib = B.library("delta_extract", _SIGNATURE)
    with B.launching(d.device) as stream:
        err = lib.delta_extract_launch(
            B.KIND_CODES[(kind, d.dtype)], B.ptr(d), B.ptr(x), B.ptr(s),
            B.ptr(xj), B.ptr(count), d.numel(), stream)
    B.check_launch(lib, err, "delta_extract")
    launches += 1
    return s, xj, count


def delta_extract(d, x, *, kind: str = "max"):
    """``(Δ(d, x), x ⊔ d, count)`` of two states of one shape and dtype:
    ``max`` over bool (as 0/1: Δ is d ∧ ¬x), uint8, int8 (signed) or int32,
    novel where d > x; ``bitor`` over int32 bit-views of 32-bit words,
    Δ = d & ~x, counted by popcount. The JAX package's uint32 ``max``
    states are taken as int32 holding values below 2³¹, where the signed
    and unsigned orders agree; a torch uint32 tensor is refused.

    ``count`` is an int32 0-d tensor on the states' device. It is exact
    below 2³¹: at the scale shapes, 15 × 4,194,304 words, even the bitor
    popcount stays below 2,013,265,920 bits. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (contiguous) or raises."""
    if d.shape != x.shape or d.dtype != x.dtype:
        raise ValueError(f"delta_extract: operands {d.dtype}{tuple(d.shape)}"
                         f" and {x.dtype}{tuple(x.shape)} differ")
    dv = B.kernel_view(d, kind, B.KIND_CODES)
    xv = B.kernel_view(x, kind, B.KIND_CODES)
    if B.is_cpu(dv):
        s, xj, count = plain(dv, xv, kind)
    elif dv.numel() == 0:
        s, xj = torch.empty_like(dv), torch.empty_like(dv)
        count = torch.zeros((), dtype=torch.int32, device=dv.device)
    else:
        s, xj, count = _launch(dv, xv, kind)
    return B.restore(s, d.dtype), B.restore(xj, d.dtype), count
