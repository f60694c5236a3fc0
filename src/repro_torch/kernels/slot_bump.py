"""The versioned-slot op of the Retwis store: ``cnt`` slots of each row
bumped past the row's version.

CUDA kernel ``csrc/slot_bump.cu`` and its plain PyTorch version. The kernel
replaces no TPU kernel: the JAX package writes the op in ``jnp``
(``repro.sync.workloads.versioned_slot_op``), which XLA fuses into one pass
over the store, where PyTorch's eager mode runs it as seven kernels over
full-size intermediates. It is bound by the bytes it writes: the dense
delta, once, and the counts; a row of ``x`` is read only where its count is
above 0, which at the store's scale is a few hundred rows of millions.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build as B

launches = 0            # kernel launches since the last reset (CUDA only)
MAX_BLOCKS = 1 << 20    # grid cap; the kernel's warps walk the rows beyond it

_SIGNATURE = {"slot_bump_launch": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]}


def plain(x, cnt, slots: int):
    """Plain version: in each row of ``x`` [..., slots], ``cnt`` [...]
    slots from the row's version (its max) mod ``slots`` on, cyclically,
    each raised to its value + 1; ⊥ (0) elsewhere."""
    cols = torch.arange(slots, dtype=torch.int32, device=x.device)
    ver = x.amax(-1, keepdim=True)
    idx = ver % slots
    sel = (cols - idx) % slots < cnt[..., None]
    return torch.where(sel, x + 1, 0).to(x.dtype)


def _launch(x, cnt, slots: int):
    global launches
    B.check_cuda("slot_bump", x, cnt)
    out = torch.empty_like(x)
    lib = B.library("slot_bump", _SIGNATURE)
    with B.launching(x.device) as stream:
        err = lib.slot_bump_launch(B.ptr(x), B.ptr(cnt), B.ptr(out),
                                   x.numel() // slots, slots, MAX_BLOCKS,
                                   stream)
    B.check_launch(lib, err, "slot_bump")
    launches += 1
    return out


def slot_bump(x, cnt, slots: int):
    """The op's δ, a fresh tensor of ``x``'s shape: ``x`` [..., slots] and
    ``cnt`` [...] of one leading shape. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (int32, contiguous, last
    axis ``slots``) or raises."""
    if x.dim() < 1 or cnt.shape != x.shape[:-1]:
        raise ValueError(f"slot_bump: counts {tuple(cnt.shape)} do not "
                         f"match the rows of x {tuple(x.shape)}")
    if B.is_cpu(x):
        return plain(x, cnt, slots)
    if x.dtype != torch.int32 or cnt.dtype != torch.int32:
        raise TypeError(f"slot_bump: x and cnt must be int32, not "
                        f"{x.dtype} and {cnt.dtype}")
    if x.shape[-1] != slots:
        raise ValueError(f"slot_bump: rows of {x.shape[-1]} slots, "
                         f"expected {slots}")
    if x.numel() == 0:
        return torch.empty_like(x)
    return _launch(x, cnt, slots)
