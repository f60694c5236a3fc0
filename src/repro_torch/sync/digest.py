"""Hierarchical block digests over the universe axis, PyTorch counterpart of
``repro.sync.digest`` (DESIGN.md §14).

The digest layer of the ``digest_driven`` resync mode:

* **Digest layout** — the universe axis is cut into ``block_elems``-wide
  blocks; each block is summarised by three 32-bit channels
  ``[hash, count, agg]``: the position-weighted mixed sum of the block's
  values, the number of non-⊥ slots, and the block's unsigned max ("max"
  kinds) or or-fold ("bitor").
* **Merkle roll-up** — ``descent_words`` prices a digest message as the
  transcript of a Merkle descent (root first, recurse into differing
  subtrees).
* **Diff → mask → extract** — ``digest_diff`` turns a remote digest into a
  block mask and ``extract_blocks`` materialises Δ(state, block_mask).

The JAX package's digests are uint32. Torch has no unsigned 32-bit
arithmetic, so here a digest is an int32 bit-view of the same words, and
the arithmetic runs on int64 holding values in [0, 2³²): every product and
sum is reduced mod 2³² (``_mul32``, ``_mod32``), every max compares the
unsigned values. The CUDA ``digest_blocks`` kernel computes the same words
for one-tensor states. A tuple state (an LWWMap's lex pairs) digests each
leaf and combines them with odd per-leaf multipliers, as the JAX package
does (the identity for one leaf); such lattices run on the reference
engine.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.lattice import tree_leaves, tree_map

# Mixing constants (Knuth / murmur-style multiplicative hashing), the JAX
# package's; all arithmetic is mod 2³², so sums agree in any order.
WMUL = 0x85EBCA77
LEAF_MUL = 0x27D4EB2F   # per-leaf multiplier of multi-leaf states
PAIR_L = 0xC2B2AE35
PAIR_R = 0x165667B1
MIX1, MIX2 = 0x7FEB352D, 0x846CA68B

CHANNELS = 3  # [hash, count, agg] 32-bit words per block
M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class DigestSpec:
    """Digest geometry: how the universe axis is blocked. ``block_elems``
    must be a power of two ≥ 8."""

    block_elems: int = 32

    def __post_init__(self):
        be = self.block_elems
        if be < 8 or be & (be - 1):
            raise ValueError(
                f"block_elems must be a power of two >= 8, got {be}")

    def num_blocks(self, universe: int) -> int:
        return -(-universe // self.block_elems)

    def words(self, universe: int) -> int:
        """Flat wire size of one digest message in 32-bit words (the leaf
        layer; the Merkle descent cost model can only charge less)."""
        return CHANNELS * self.num_blocks(universe)


def state_universe(state) -> int:
    """Shared trailing universe extent of a digestable state's leaves.
    Raises ValueError for a state without one (a rank-0 leaf, or leaves
    whose trailing axes differ: linear sums, products of unequal maps)."""
    leaves = tree_leaves(state)
    dims = {leaf.shape[-1] if leaf.ndim else None for leaf in leaves}
    if None in dims or len(dims) != 1:
        raise ValueError(
            "digest sync needs map-like states whose leaves share one "
            "trailing universe axis; got leaf shapes "
            f"{[tuple(leaf.shape) for leaf in leaves]}")
    return dims.pop()


def digestable(lattice) -> bool:
    try:
        state_universe(lattice.bottom())
        return True
    except ValueError:
        return False


# -- exact mod-2³² arithmetic on int64 ------------------------------------------

def _u32(t: torch.Tensor) -> torch.Tensor:
    """Words (bool, uint8, int32 or int32 bit-views) as their unsigned
    32-bit values, held in int64."""
    return t.to(torch.int64) & M32


def _mod32(v: torch.Tensor) -> torch.Tensor:
    return v & M32


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """a · b mod 2³² for a in [0, 2³²) and b (a tensor or a constant) in
    [0, 2³²), in halves of 16 bits so no int64 product overflows."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & M32


def _to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2³²) -> int32 bit-views."""
    return (((v + 2**31) & M32) - 2**31).to(torch.int32)


def _mix64(v: torch.Tensor) -> torch.Tensor:
    v = v ^ (v >> 16)
    v = _mul32(v, MIX1)
    v = v ^ (v >> 15)
    v = _mul32(v, MIX2)
    return v ^ (v >> 16)


def mix(v: torch.Tensor) -> torch.Tensor:
    """Elementwise fmix32-style avalanche mix of int32 bit-views (the JAX
    package's uint32 ``mix``); returns int32 bit-views."""
    return _to_i32(_mix64(_u32(v)))


def or_fold(v: torch.Tensor) -> torch.Tensor:
    """Or-reduce the trailing (power-of-two) axis by halving."""
    while v.shape[-1] > 1:
        v = v[..., ::2] | v[..., 1::2]
    return v[..., 0]


def pos_weights(be: int, device=None) -> torch.Tensor:
    """Per-position odd multipliers (2·pos + 1)·WMUL mod 2³², shared by
    every block, as int64."""
    pos = torch.arange(be, dtype=torch.int64, device=device)
    return _mul32(2 * pos + 1, WMUL)


def _leaf_digest(leaf: torch.Tensor, spec: DigestSpec, kind: str):
    """``(hash, count, agg)`` of one leaf [..., U], each int64 [..., nB]
    holding 32-bit values."""
    be = spec.block_elems
    u = leaf.shape[-1]
    nb = spec.num_blocks(u)
    v = _u32(leaf)
    pad = nb * be - u
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
    v = v.reshape(v.shape[:-1] + (nb, be))
    # the position folds into the mix INPUT, so the block hash behaves
    # like a random subset-sum (see the JAX package's ``mix``)
    h = _mod32(_mix64(_mul32(_mod32(v + 1), pos_weights(be, v.device)))
               .sum(-1))
    cnt = (v != 0).sum(-1)
    agg = or_fold(v) if kind == "bitor" else v.amax(-1)
    return h, cnt, agg


def digest_state(state, spec: DigestSpec, kind: str = "max") -> torch.Tensor:
    """Digest states [..., U] -> int32 bit-views [..., num_blocks, 3]
    (channels hash, count, agg). The last block is zero-padded before
    hashing, so a position past U hashes as the value 0 (and adds nothing
    to count or agg). Leaf i of a tuple state adds its hash times the odd
    multiplier 1 (i = 0) or (2i + 1)·LEAF_MUL, its count, and its agg to
    the unsigned max, all mod 2³²."""
    state_universe(state)
    h = cnt = agg = None
    for i, leaf in enumerate(tree_leaves(state)):
        lh, lc, la = _leaf_digest(leaf, spec, kind)
        if h is None:
            h, cnt, agg = lh, lc, la
            continue
        h = _mod32(h + _mul32(lh, ((2 * i + 1) * LEAF_MUL) & M32))
        cnt = _mod32(cnt + lc)
        agg = torch.maximum(agg, la)
    return _to_i32(torch.stack([h, cnt, agg], -1))


def digest_diff(local: torch.Tensor, remote: torch.Tensor) -> torch.Tensor:
    """Block mask of *possible* divergence: True wherever any summary
    channel differs."""
    return torch.any(local != remote, dim=-1)


def block_mask_to_elems(mask: torch.Tensor, universe: int,
                        spec: DigestSpec) -> torch.Tensor:
    """bool [..., nB] block mask -> bool [..., U] slot mask."""
    return mask.repeat_interleave(spec.block_elems, dim=-1)[..., :universe]


def extract_blocks(state, elem_mask: torch.Tensor):
    """Δ(state, block_mask): the state restricted to masked slots (⊥
    outside); whole slots are kept or dropped, so the result is a valid
    sub-state of any map-like lattice (lex pairs included)."""
    return tree_map(lambda a: torch.where(elem_mask, a, a.new_zeros(())),
                    state)


# -- Merkle roll-up and the descent cost model ----------------------------------

def merkle_levels(leaf: torch.Tensor) -> list:
    """Fold the leaf layer [..., nB, 3] (int32 bit-views) pairwise up to the
    root. Returns ``[leaf_padded, ..., root]`` with level ℓ holding
    2^(L-ℓ) nodes; the leaf layer is zero-padded to a power of two. A parent
    mixes its children's hashes, adds their counts and takes the unsigned
    max of their aggs."""
    nb = leaf.shape[-2]
    size = 1
    while size < nb:
        size *= 2
    if size != nb:
        leaf = torch.nn.functional.pad(leaf, (0, 0, 0, size - nb))
    levels = [leaf]
    cur = _u32(leaf)
    while cur.shape[-2] > 1:
        left, right = cur[..., ::2, :], cur[..., 1::2, :]
        h = _mod32(_mul32(_mix64(left[..., 0]), PAIR_L)
                   + _mul32(_mix64(right[..., 0]), PAIR_R))
        cnt = _mod32(left[..., 1] + right[..., 1])
        agg = torch.maximum(left[..., 2], right[..., 2])
        cur = torch.stack([h, cnt, agg], -1)
        levels.append(_to_i32(cur))
    return levels


def descent_words(local_leaf: torch.Tensor,
                  remote_leaf: torch.Tensor) -> torch.Tensor:
    """Cost (32-bit words) of one digest message priced as a Merkle descent
    against the sender's latest view of the peer's tree: the root is always
    sent; every differing internal node fetches its two children. Equal
    trees cost one node. ``local_leaf`` broadcasts against
    ``remote_leaf`` ([..., nB, 3]); returns int32 with the block axes
    reduced away."""
    loc = merkle_levels(local_leaf)
    rem = merkle_levels(remote_leaf)
    shape = torch.broadcast_shapes(loc[-1].shape[:-2], rem[-1].shape[:-2])
    nodes = torch.ones(shape, dtype=torch.int32, device=local_leaf.device)
    for lv_l, lv_r in zip(loc[1:], rem[1:]):     # internal levels + root
        diff = torch.any(lv_l != lv_r, dim=-1)   # [..., nodes_at_level]
        nodes = nodes + 2 * diff.sum(-1, dtype=torch.int32)
    return CHANNELS * nodes
