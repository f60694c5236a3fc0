"""Per-slot masked block extraction, for the digest-driven resync.

CUDA kernel ``csrc/masked_extract.cu`` (replacing the TPU kernel
``masked_extract_2d`` in ``src/repro/kernels/digest.py``) and its plain
PyTorch version, with the contract of ``repro.kernels.ops.masked_extract``
in the port's slot-major layout: for each slot q, the state x [..., U]
restricted to the blocks its mask [P, ..., nB] flags, ⊥ elsewhere, with x
read once for all P slots -> [P, ..., U].
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build as B

launches = 0          # kernel launches since the last reset (CUDA only)

_SIGNATURE = {"masked_extract_launch": [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p]}


def plain(x, masks, block_elems: int):
    """Plain version on x [M, U] and int masks [P, M, nB]."""
    u = x.shape[-1]
    em = masks.repeat_interleave(block_elems, dim=-1)[..., :u] != 0
    return torch.where(em, x.unsqueeze(0), x.new_zeros(()))


def _launch(x, masks, block_elems: int):
    global launches
    B.check_cuda("masked_extract", x, masks)
    p, (m, u) = masks.shape[0], x.shape
    out = torch.empty((p, m, u), dtype=x.dtype, device=x.device)
    # 16-byte accesses where every row starts on a 16-byte boundary
    vec = int((u * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    lib = B.library("masked_extract", _SIGNATURE)
    # the kernel only moves elements: the "max" codes name their width
    with B.launching(x.device) as stream:
        err = lib.masked_extract_launch(
            B.KIND_CODES[("max", x.dtype)], B.ptr(x), B.ptr(masks),
            B.ptr(out), p, m, u, block_elems, vec, stream)
    B.check_launch(lib, err, "masked_extract")
    launches += 1
    return out


def masked_extract(x, block_masks, *, block_elems: int):
    """Per-slot Δ(state, block mask): x [..., U] (bool, uint8, int32),
    ``block_masks`` bool/int [P, ..., ceil(U / block_elems)] -> [P, ..., U]
    in x's dtype. The leading axes (a batch's (config, node) axes) are
    the kernel's rows. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (x contiguous) or raises."""
    lead, u = tuple(x.shape[:-1]), x.shape[-1]
    p = block_masks.shape[0]
    nb = -(-u // block_elems)
    if block_elems < 8 or block_elems & (block_elems - 1):
        raise ValueError(f"block_elems must be a power of two >= 8, got "
                         f"{block_elems}")
    if tuple(block_masks.shape) != (p,) + lead + (nb,):
        raise ValueError(f"masked_extract: masks {tuple(block_masks.shape)} "
                         f"do not match x {tuple(x.shape)} at block_elems "
                         f"{block_elems}")
    v = x.view(torch.uint8) if x.dtype == torch.bool else x
    if v.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"masked_extract takes bool, uint8 or int32 states, "
                        f"not {x.dtype}")
    m = math.prod(lead)
    mk = block_masks.to(torch.int32).reshape(p, m, nb).contiguous()
    run = plain if B.is_cpu(v) else _launch
    out = run(v.reshape(m, u), mk, block_elems)
    return B.restore(out.reshape((p,) + lead + (u,)), x.dtype)
