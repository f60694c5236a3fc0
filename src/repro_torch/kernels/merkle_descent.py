"""The Merkle-descent price of a digest-driven resync round's digest
messages.

CUDA kernel ``csrc/merkle_descent.cu`` and its plain PyTorch version: every
row's tree of block digests [R, nB, 3] priced as a descent against the tree
of row ``src[p, r]`` -> the words int32 [P, R], the JAX package's
``descent_words(leaf[None], leaf[src])``. ``sync.digest`` takes
:func:`merkle_levels`, the fold of one tree, and the plain version (as
``routed_descent_words``) from here. The kernel replaces no TPU kernel
(the JAX package prices the descent in plain jnp). Each launch is labelled
``merkle_descent rows=R blocks=nB slots=P`` in a ``torch.profiler`` trace,
so that a reader of the trace knows the shapes it priced.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.mod32 import (CHANNELS, PAIR_L, PAIR_R, mix64,
                                       mod32, mul32, to_i32, u32)

launches = 0          # calls that launched on the card since the last reset

LABEL = "merkle_descent rows={} blocks={} slots={}"

_SIGNATURE = {"merkle_descent_launch": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_void_p]}


def merkle_levels(leaf: torch.Tensor) -> list:
    """Fold the leaf layer [..., nB, 3] (int32 bit-views) pairwise up to the
    root. Returns ``[leaf_padded, ..., root]`` with level ℓ holding
    2^(L-ℓ) nodes; the leaf layer is zero-padded to a power of two. A parent
    mixes its children's hashes, adds their counts and takes the unsigned
    max of their aggs."""
    nb = leaf.shape[-2]
    size = 1 << (nb - 1).bit_length()
    if size != nb:
        leaf = torch.nn.functional.pad(leaf, (0, 0, 0, size - nb))
    levels = [leaf]
    h, cnt, agg = u32(leaf).unbind(-1)
    while h.shape[-1] > 1:
        mixed = mix64(h)
        h = mod32(mul32(mixed[..., ::2], PAIR_L)
                  + mul32(mixed[..., 1::2], PAIR_R))
        cnt = mod32(cnt[..., ::2] + cnt[..., 1::2])
        agg = torch.maximum(agg[..., ::2], agg[..., 1::2])
        levels.append(to_i32(torch.stack([h, cnt, agg], -1)))
    return levels


def plain(leaf, src):
    """Plain version: each tree of ``leaf`` folded once, and every internal
    level compared with its copy routed by ``src``. The root is always
    sent; every differing internal node fetches its two children."""
    nodes = torch.ones(src.shape, dtype=torch.int32, device=leaf.device)
    for level in merkle_levels(leaf)[1:]:        # internal levels + root
        diff = torch.any(level != level[src], dim=-1)    # [P, R, nodes]
        nodes = nodes + 2 * diff.sum(-1, dtype=torch.int32)
    return CHANNELS * nodes


def _launch(leaf, src):
    global launches
    B.check_cuda("merkle_descent", leaf, src)
    rows, nb = leaf.shape[0], leaf.shape[1]
    size = 1 << (nb - 1).bit_length()
    tree = torch.empty((rows, size - 1, 3), dtype=torch.int32,
                       device=leaf.device)
    out = torch.empty(src.shape, dtype=torch.int32, device=leaf.device)
    lib = B.library("merkle_descent", _SIGNATURE)
    label = LABEL.format(rows, nb, src.shape[0])
    with torch.profiler.record_function(label), \
            B.launching(leaf.device) as stream:
        err = lib.merkle_descent_launch(
            B.ptr(leaf), B.ptr(tree), B.ptr(src), B.ptr(out), rows, nb,
            src.numel(), stream)
    B.check_launch(lib, err, "merkle_descent")
    launches += 1
    return out


def merkle_descent(leaf, src):
    """Descent words of the trees of ``leaf`` int32 [R, nB, 3] (block
    digests) against their routed copies: ``src`` [P, R] the row each is
    compared with -> int32 [P, R]. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    if leaf.dim() != 3 or leaf.shape[-1] != 3 or leaf.dtype != torch.int32:
        raise ValueError(f"merkle_descent takes int32 [R, nB, 3] leaves, not "
                         f"{leaf.dtype} {tuple(leaf.shape)}")
    if src.dim() != 2 or src.shape[1] != leaf.shape[0]:
        raise ValueError(f"merkle_descent: src {tuple(src.shape)} does not "
                         f"route {leaf.shape[0]} rows")
    if B.is_cpu(leaf):
        return plain(leaf, src)
    return _launch(leaf.contiguous(), src.to(torch.int64).contiguous())
