"""Leave-one-out buffer fold: the per-neighbour sends of the BP flavours.

``send[j] = ⊔ {buf[o] | o ≠ j}`` for j < K-1 along the leading slot axis of
an origin-indexed buffer. CUDA kernel ``csrc/buffer_fold.cu`` (replacing the TPU
kernel ``buffer_fold_2d`` in ``src/repro/kernels/buffer_fold.py``) and its
plain PyTorch version, with the same contract.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build as B

launches = 0          # kernel launches since the last reset (CUDA only)
MAX_SLOTS = 16        # csrc/buffer_fold.cu MAX_SLOTS

_SIGNATURE = {"buffer_fold_launch": [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_void_p]}


def plain(buf: torch.Tensor, kind: str = "max"):
    """Plain version: prefix/suffix joins over the leading slot axis."""
    join = B.join_fn(kind)
    slots = buf.unbind(0)
    k = len(slots)
    suffix = [None] * k
    acc = torch.zeros_like(slots[0])
    for s in range(k - 1, -1, -1):
        suffix[s] = acc
        acc = join(acc, slots[s])
    outs = []
    acc = torch.zeros_like(slots[0])
    for s in range(k - 1):
        outs.append(join(acc, suffix[s]))
        acc = join(acc, slots[s])
    return torch.stack(outs)


def _launch(buf: torch.Tensor, kind: str) -> torch.Tensor:
    global launches
    B.check_cuda("buffer_fold", buf)
    k = buf.shape[0]
    if not 2 <= k <= MAX_SLOTS:
        raise ValueError(f"buffer_fold: {k} slots; the kernel takes "
                         f"2..{MAX_SLOTS}")
    out = torch.empty((k - 1,) + tuple(buf.shape[1:]), dtype=buf.dtype,
                      device=buf.device)
    if out.numel() == 0:
        return out
    lib = B.library("buffer_fold", _SIGNATURE)
    with B.launching(buf.device) as stream:
        err = lib.buffer_fold_launch(B.KIND_CODES[(kind, buf.dtype)],
                                     B.ptr(buf), B.ptr(out), k,
                                     buf[0].numel(), stream)
    B.check_launch(lib, err, "buffer_fold")
    launches += 1
    return out


def buffer_fold(buf: torch.Tensor, *, kind: str = "max"):
    """Leave-one-out sends of ``buf`` along its leading slot axis:
    [K, ...] -> [K-1, ...] (the rest may hold a batch's (config, node)
    axes). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (contiguous, bool/uint8/int32 for ``max``,
    int32 bit-views for ``bitor``) or raises."""
    v = B.kernel_view(buf, kind)
    out = plain(v, kind) if B.is_cpu(v) else _launch(v, kind)
    return B.restore(out, buf.dtype)
