"""Hierarchical block digests over the universe axis, PyTorch counterpart of
``repro.sync.digest`` (DESIGN.md §14).

The digest layer of the ``digest_driven`` resync mode:

* **Digest layout** — the universe axis is cut into ``block_elems``-wide
  blocks; each block is summarised by three 32-bit channels
  ``[hash, count, agg]``: the position-weighted mixed sum of the block's
  values, the number of non-⊥ slots, and the block's unsigned max ("max"
  kinds) or or-fold ("bitor").
* **Merkle roll-up** — ``merkle_levels`` folds a leaf layer up to its
  root; ``routed_descent_words`` prices every digest message of a resync
  round as the transcript of a Merkle descent (root first, recurse into
  differing subtrees), every tree against its routed copies. Both are the
  plain version of the CUDA kernel ``merkle_descent``
  (``kernels/merkle_descent.py``), which the kernel engines run.
  ``descent_words`` prices two broadcast leaf layers, as the JAX package's
  function of that name does.
* **Diff → mask → extract** — ``digest_diff`` turns a remote digest into a
  block mask and ``extract_blocks`` materialises Δ(state, block_mask).

A digest is an int32 bit-view of the JAX package's uint32 words, computed
with the exact mod-2³² arithmetic of ``kernels/mod32.py``. The CUDA
``digest_blocks`` kernel computes the same words for one-tensor states.
A tuple state (an LWWMap's lex pairs) digests each leaf and combines them
with odd per-leaf multipliers, as the JAX package does (the identity for
one leaf); such lattices run on the reference engine.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.lattice import tree_leaves, tree_map
from repro_torch.kernels.merkle_descent import merkle_levels
from repro_torch.kernels.merkle_descent import \
    plain as routed_descent_words  # noqa: F401
from repro_torch.kernels.mod32 import CHANNELS, LEAF_MUL, M32, WMUL
from repro_torch.kernels.mod32 import mix64 as _mix64
from repro_torch.kernels.mod32 import mod32 as _mod32
from repro_torch.kernels.mod32 import mul32 as _mul32
from repro_torch.kernels.mod32 import to_i32 as _to_i32
from repro_torch.kernels.mod32 import u32 as _u32


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


# -- block digests ------------------------------------------------------------

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


# -- the descent cost model ---------------------------------------------------

def descent_words(local_leaf: torch.Tensor,
                  remote_leaf: torch.Tensor) -> torch.Tensor:
    """Cost (32-bit words) of one digest message priced as a Merkle descent
    against the sender's latest view of the peer's tree: the root is always
    sent; every differing internal node fetches its two children. Equal
    trees cost one node. ``local_leaf`` broadcasts against
    ``remote_leaf`` ([..., nB, 3]); returns int32 with the block axes
    reduced away. The JAX package's API, kept for callers that price two
    leaf layers (the benchmark's reference is held to it); the resync
    round takes ``routed_descent_words``, which folds each tree once."""
    loc = merkle_levels(local_leaf)
    rem = merkle_levels(remote_leaf)
    shape = torch.broadcast_shapes(loc[-1].shape[:-2], rem[-1].shape[:-2])
    nodes = torch.ones(shape, dtype=torch.int32, device=local_leaf.device)
    for lv_l, lv_r in zip(loc[1:], rem[1:]):     # internal levels + root
        diff = torch.any(lv_l != lv_r, dim=-1)   # [..., nodes_at_level]
        nodes = nodes + 2 * diff.sum(-1, dtype=torch.int32)
    return CHANNELS * nodes
