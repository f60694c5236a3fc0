"""Block digests and the Merkle descent price of the digest-driven resync
(DESIGN.md §14), in plain PyTorch.

A digest cuts a replica's U slots into blocks and keeps three 32-bit words
a block: a hash (the sum over the block of a mix of each value + 1 times
an odd weight of its position), the count of non-⊥ slots and the largest
value. Arithmetic is mod 2**32 on int64 values; digests are returned as
int32 bit-views. A digest message is priced as a Merkle descent: the root,
plus the two children of every internal node whose summary differs.
"""

from __future__ import annotations

import torch

CHANNELS = 3
M32 = 0xFFFFFFFF
WMUL = 0x85EBCA77
PAIR_L, PAIR_R = 0xC2B2AE35, 0x165667B1
MIX1, MIX2 = 0x7FEB352D, 0x846CA68B


def u32(t: torch.Tensor) -> torch.Tensor:
    """32-bit words as their unsigned values in int64."""
    return t.to(torch.int64) & M32


def i32(v: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values in int64 as int32 bit-views."""
    return (((v + 2 ** 31) & M32) - 2 ** 31).to(torch.int32)


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """a · b mod 2**32, by 16-bit halves of a (no int64 overflow)."""
    return ((a & 0xFFFF) * b + ((((a >> 16) * b) & 0xFFFF) << 16)) & M32


def mix(v: torch.Tensor) -> torch.Tensor:
    v = v ^ (v >> 16)
    v = mul32(v, MIX1)
    v = v ^ (v >> 15)
    v = mul32(v, MIX2)
    return v ^ (v >> 16)


def digest(x: torch.Tensor, block: int) -> torch.Tensor:
    """Digests of states ``x[..., U]`` (non-negative int32) as int32
    [..., ceil(U / block), 3]; the last block is padded with ⊥."""
    u = x.shape[-1]
    nb = -(-u // block)
    v = torch.nn.functional.pad(u32(x), (0, nb * block - u))
    v = v.reshape(v.shape[:-1] + (nb, block))
    pos = torch.arange(block, dtype=torch.int64, device=x.device)
    h = mix(mul32((v + 1) & M32, mul32(2 * pos + 1, WMUL))).sum(-1) & M32
    return i32(torch.stack([h, (v != 0).sum(-1), v.amax(-1)], -1))


def merkle(leaf: torch.Tensor) -> list:
    """The Merkle levels above a leaf layer [..., nB, 3] padded with zero
    words to a power of two: a parent mixes its children's hashes, adds
    their counts and keeps the larger of their maxima."""
    nb = leaf.shape[-2]
    width = 1 << max(nb - 1, 0).bit_length()
    cur = u32(torch.nn.functional.pad(leaf, (0, 0, 0, width - nb)))
    levels = []
    while cur.shape[-2] > 1:
        a, b = cur[..., ::2, :], cur[..., 1::2, :]
        cur = torch.stack([
            (mul32(mix(a[..., 0]), PAIR_L) + mul32(mix(b[..., 0]), PAIR_R))
            & M32, (a[..., 1] + b[..., 1]) & M32,
            torch.maximum(a[..., 2], b[..., 2])], -1)
        levels.append(cur)
    return levels


def descent_words(mine: torch.Tensor, theirs: torch.Tensor) -> torch.Tensor:
    """32-bit words of a descent of tree ``mine`` against ``theirs`` (leaf
    layers that broadcast): 3 for the root, and 6 for every internal node
    that differs. int32, the block axes reduced away."""
    nodes = None
    for a, b in zip(merkle(mine), merkle(theirs)):
        diff = 2 * (a != b).any(-1).sum(-1, dtype=torch.int32)
        nodes = diff if nodes is None else nodes + diff
    if nodes is None:          # a one-block tree: the root alone
        shape = torch.broadcast_shapes(mine.shape[:-2], theirs.shape[:-2])
        nodes = torch.zeros(shape, dtype=torch.int32, device=mine.device)
    return CHANNELS * (nodes + 1)
