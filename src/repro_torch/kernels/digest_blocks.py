"""Blockwise digest of dense states, for the digest-driven resync.

CUDA kernel ``csrc/digest_blocks.cu`` (replacing the TPU kernel
``digest_blocks_2d`` in ``src/repro/kernels/digest.py``) and its plain
PyTorch version, with the contract of ``repro.kernels.ops.digest_blocks``:
x [..., U] -> the ``[hash, count, agg]`` words of each ``block_elems``
block, [..., nB, 3], as int32 bit-views of the JAX package's uint32 words.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build as B

launches = 0          # kernel launches since the last reset (CUDA only)

_SIGNATURE = {"digest_blocks_launch": [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]}


def plain(x, block_elems: int, kind: str = "max"):
    """Plain version: the canonical digest of ``repro_torch.sync.digest``
    (imported here: the sync package imports the kernels)."""
    from repro_torch.sync import digest as D

    return D.digest_state(x, D.DigestSpec(block_elems), kind)


def _launch(x, block_elems: int, kind: str):
    global launches
    B.check_cuda("digest_blocks", x)
    m, u = x.shape
    nb = -(-u // block_elems)
    out = torch.empty((m, nb, 3), dtype=torch.int32, device=x.device)
    lib = B.library("digest_blocks", _SIGNATURE)
    err = lib.digest_blocks_launch(B.KIND_CODES[(kind, x.dtype)], B.ptr(x),
                                   B.ptr(out), m, u, block_elems,
                                   B.stream_handle())
    B.check_launch(lib, err, "digest_blocks")
    launches += 1
    return out


def digest_blocks(x, *, block_elems: int, kind: str = "max"):
    """Digest of states x [..., U] (bool, uint8, int32; int32 bit-views for
    ``bitor``) -> int32 [..., ceil(U / block_elems), 3]. The last block is
    zero-padded before hashing, as in the JAX package. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (contiguous) or
    raises."""
    if block_elems < 8 or block_elems & (block_elems - 1):
        raise ValueError(f"block_elems must be a power of two >= 8, got "
                         f"{block_elems}")
    v = B.kernel_view(x, kind)
    if B.is_cpu(v):
        return plain(v, block_elems, kind)
    lead, u = tuple(x.shape[:-1]), x.shape[-1]
    out = _launch(v.reshape(math.prod(lead), u), block_elems, kind)
    return out.reshape(lead + out.shape[1:])
