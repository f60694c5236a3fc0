"""Exact mod-2³² arithmetic on int64, and the digests' constants: what the
plain versions of the digest kernels compute with, shared with
``sync.digest``.

The JAX package's digests are uint32. Torch has no unsigned 32-bit
arithmetic, so here a digest word is an int32 bit-view of the same word,
and the arithmetic runs on int64 holding values in [0, 2³²): every product
and sum is reduced mod 2³² (:func:`mul32`, :func:`mod32`), every max
compares the unsigned values.
"""

from __future__ import annotations

import torch

# Mixing constants (Knuth / murmur-style multiplicative hashing), the JAX
# package's; all arithmetic is mod 2³², so sums agree in any order.
WMUL = 0x85EBCA77
LEAF_MUL = 0x27D4EB2F   # per-leaf multiplier of multi-leaf states
PAIR_L = 0xC2B2AE35
PAIR_R = 0x165667B1
MIX1, MIX2 = 0x7FEB352D, 0x846CA68B

CHANNELS = 3  # [hash, count, agg] 32-bit words per block
M32 = 0xFFFFFFFF


def u32(t: torch.Tensor) -> torch.Tensor:
    """Words (bool, uint8, int32 or int32 bit-views) as their unsigned
    32-bit values, held in int64."""
    return t.to(torch.int64) & M32


def mod32(v: torch.Tensor) -> torch.Tensor:
    return v & M32


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """a · b mod 2³² for a in [0, 2³²) and b (a tensor or a constant) in
    [0, 2³²), in halves of 16 bits so no int64 product overflows."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & M32


def to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2³²) -> int32 bit-views."""
    return (((v + 2**31) & M32) - 2**31).to(torch.int32)


def mix64(v: torch.Tensor) -> torch.Tensor:
    """The fmix32-style avalanche mix of values in [0, 2³²)."""
    v = v ^ (v >> 16)
    v = mul32(v, MIX1)
    v = v ^ (v >> 15)
    v = mul32(v, MIX2)
    return v ^ (v >> 16)
