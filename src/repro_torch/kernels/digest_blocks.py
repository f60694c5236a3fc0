"""Blockwise digest of dense states, for the digest-driven resync.

CUDA kernel ``csrc/digest_blocks.cu`` (replacing the TPU kernel
``digest_blocks_2d`` in ``src/repro/kernels/digest.py``) and its plain
PyTorch version, with the contract of ``repro.kernels.ops.digest_blocks``:
x [..., U] -> the ``[hash, count, agg]`` words of each ``block_elems``
block, [..., nB, 3], as int32 bit-views of the JAX package's uint32 words.

A lane of the CUDA kernel reads 16 bytes at once where rows allow it, a
segment of lanes owns a block, and a warp walks a run of consecutive
blocks of one row; :func:`plan` sets the loads and the 2-D grid.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build as B

launches = 0          # kernel launches since the last reset (CUDA only)
last_launch = None    # the Plan of the last launch
WARPS = 8             # warps a block (csrc/digest_blocks.cu DG_THREADS / 32)
UNROLL = 4            # vectors a lane loads at once (csrc/digest_blocks.cu)

_SIGNATURE = {"digest_blocks_launch": [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
    ctypes.c_uint, ctypes.c_void_p]}


class Plan(NamedTuple):
    """A launch of ``csrc/digest_blocks.cu``: ``vec`` elements a lane loads
    at once (16 bytes' worth, or 1), lanes per digest block, the vectors
    (and blocks) of one warp's task, and the grid (row tasks, rows)."""
    vec: int
    lanes_per_block: int
    task_vectors: int
    task_blocks: int
    grid_x: int
    grid_y: int

    @property
    def vector(self) -> bool:
        return self.vec > 1


@functools.lru_cache(maxsize=256)
def plan(m: int, u: int, block_elems: int, elem_size: int,
         aligned: bool) -> Plan:
    """The launch of a digest of M rows of U ``elem_size``-byte elements in
    ``block_elems`` blocks. 16-byte loads where the base is ``aligned``, a
    row is a multiple of 16 bytes and a block holds at least one vector;
    else one element a lane. A digest block is ``block_elems / vec``
    vectors; a warp's task is max(32·UNROLL, that) vectors; the grid covers
    every task of a row with WARPS warps a block, and the rows (at most
    65,535, looped beyond)."""
    v = 16 // elem_size
    if not (aligned and (u * elem_size) % 16 == 0 and block_elems >= v):
        v = 1
    lanes = block_elems // v
    tv = max(32 * UNROLL, lanes)
    nb = -(-u // block_elems)
    tasks = -(-(nb * lanes) // tv)
    return Plan(v, lanes, tv, tv // lanes, -(-tasks // WARPS), min(m, 65535))


def plain(x, block_elems: int, kind: str = "max"):
    """Plain version: the canonical digest of ``repro_torch.sync.digest``
    (imported here: the sync package imports the kernels)."""
    from repro_torch.sync import digest as D

    return D.digest_state(x, D.DigestSpec(block_elems), kind)


def _launch(x, block_elems: int, kind: str):
    global launches, last_launch
    B.check_cuda("digest_blocks", x)
    m, u = x.shape
    nb = -(-u // block_elems)
    out = torch.empty((m, nb, 3), dtype=torch.int32, device=x.device)
    pl = plan(m, u, block_elems, x.element_size(), x.data_ptr() % 16 == 0)
    lib = B.library("digest_blocks", _SIGNATURE)
    with B.launching(x.device) as stream:
        err = lib.digest_blocks_launch(
            B.KIND_CODES[(kind, x.dtype)], B.ptr(x), B.ptr(out), m, u,
            block_elems, int(pl.vector), pl.grid_x, pl.grid_y, stream)
    B.check_launch(lib, err, "digest_blocks")
    launches += 1
    last_launch = pl
    return out


def digest_blocks(x, *, block_elems: int, kind: str = "max"):
    """Digest of states x [..., U] (bool, uint8, int32; int32 bit-views for
    ``bitor``) -> int32 [..., ceil(U / block_elems), 3]. The last block is
    zero-padded before hashing, as in the JAX package. The leading axes
    (a batch's (config, node) axes) are the
    kernel's rows. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (contiguous) or raises."""
    if block_elems < 8 or block_elems & (block_elems - 1):
        raise ValueError(f"block_elems must be a power of two >= 8, got "
                         f"{block_elems}")
    v = B.kernel_view(x, kind)
    if B.is_cpu(v):
        return plain(v, block_elems, kind)
    lead, u = tuple(x.shape[:-1]), x.shape[-1]
    out = _launch(v.reshape(math.prod(lead), u), block_elems, kind)
    return out.reshape(lead + out.shape[1:])
