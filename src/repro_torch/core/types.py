"""Concrete state-based CRDTs (paper §II-A, Appendix B), PyTorch counterpart
of ``repro.core.types``: GCounter, PNCounter, GSet, BitGSet, GMap, LWWMap
and LexCounter.

Each type bundles a ``Lattice`` with its mutators m and optimal δ-mutators
mᵟ(x) = Δ(m(x), x). States are plain tensors, or tuples of tensors for the
product (PNCounter) and the lex-pair maps (LWWMap, LexCounter); element,
key and replica identifiers are integer indices into a fixed universe,
indexing the trailing axis. Mutators never modify their arguments.

BitGSet words are uint32 in the JAX package. Torch has no unsigned 32-bit
arithmetic on the CPU, so here they are int32 bit-views of the same words:
``|``, ``&`` and ``~`` act on the bits alike, and counts go through
:func:`popcount32`.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import value_lattices as vl
from repro_torch.core.lattice import Lattice, MapLattice, product, weighted_sum

_M1, _M2, _M4 = 0x55555555, 0x33333333, 0x0F0F0F0F


def popcount32(t: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit count of int32 bit-views (SWAR). The words are
    widened to int64 and masked to their low 32 bits first, so a word with
    bit 31 set counts that bit once (an int32 ``>>`` would sign-extend)."""
    v = t.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class GCounter:
    """Grow-only counter: I ↪ ℕ under pointwise max."""

    num_replicas: int

    @property
    def lattice(self) -> Lattice:
        return MapLattice(self.num_replicas, vl.max_int(), "gcounter").build()

    def inc(self, p, i):
        """m: p{i ↦ p(i)+1}"""
        out = p.clone()
        out[..., i] += 1
        return out

    def inc_delta(self, p, i):
        """mᵟ: {i ↦ p(i)+1} — a single irreducible (optimal)."""
        d = torch.zeros_like(p)
        d[..., i] = p[..., i] + 1
        return d

    def value(self, p):
        return p.sum(-1)


@dataclasses.dataclass(frozen=True)
class PNCounter:
    """Increment/decrement counter: the product of two GCounters
    (Appendix B: A × B)."""

    num_replicas: int

    @property
    def lattice(self) -> Lattice:
        g = MapLattice(self.num_replicas, vl.max_int(), "g").build()
        return product("pncounter", (g, g))

    def inc(self, s, i):
        p, n = s
        p = p.clone()
        p[..., i] += 1
        return (p, n)

    def dec(self, s, i):
        p, n = s
        n = n.clone()
        n[..., i] += 1
        return (p, n)

    def inc_delta(self, s, i):
        p, n = s
        d = torch.zeros_like(p)
        d[..., i] = p[..., i] + 1
        return (d, torch.zeros_like(n))

    def dec_delta(self, s, i):
        p, n = s
        d = torch.zeros_like(n)
        d[..., i] = n[..., i] + 1
        return (torch.zeros_like(p), d)

    def value(self, s):
        p, n = s
        return p.sum(-1) - n.sum(-1)


@dataclasses.dataclass(frozen=True)
class GSet:
    """Grow-only set over a static universe, P(E) under union."""

    universe: int

    @property
    def lattice(self) -> Lattice:
        return MapLattice(self.universe, vl.or_bool(), "gset").build()

    def add(self, s, e):
        out = s.clone()
        out[..., e] = True
        return out

    def add_delta(self, s, e):
        """mᵟ: {e} if e ∉ s else ⊥ (the paper's optimal addᵟ)."""
        d = torch.zeros_like(s)
        d[..., e] = torch.logical_not(s[..., e])
        return d

    def add_mask(self, s, mask):
        return torch.logical_or(s, mask)

    def add_mask_delta(self, s, mask):
        return torch.logical_and(mask, torch.logical_not(s))

    def value(self, s):
        return s


@dataclasses.dataclass(frozen=True)
class BitGSet:
    """Grow-only set over a static universe, bit-packed 32 elements per
    word (int32 bit-views). Irreducibles are single bits: ``size`` counts
    them by popcount, while the pointwise mask views resolve at word
    granularity (use ``kernels.ops.unpack_bits`` for bit resolution)."""

    universe: int

    @property
    def num_words(self) -> int:
        return -(-self.universe // 32)

    @property
    def lattice(self) -> Lattice:
        w = self.num_words

        def bottom(device=None):
            return torch.zeros((w,), dtype=torch.int32, device=device)

        def delta(a, b):
            # a's bits absent from b — exact and optimal (one bit = one
            # irreducible)
            return torch.bitwise_and(a, torch.bitwise_not(b))

        def leq(a, b):
            return torch.all(delta(a, b) == 0, dim=-1)

        return Lattice(
            name="bitgset",
            bottom=bottom,
            join=torch.bitwise_or,
            leq=leq,
            delta=delta,
            size=lambda a: popcount32(a).sum(-1, dtype=torch.int32),
            is_bottom=lambda a: torch.all(a == 0, dim=-1),
            irreducible_mask=lambda a: a != 0,          # word-level view
            novel_mask=lambda a, b: delta(a, b) != 0,
            kernel_kind="bitor",
            # the bits of one word share its weight
            wsize=lambda a, wt: weighted_sum(popcount32(a), wt),
        )

    def add_mask(self, s, mask_words):
        """m: union in a packed word mask."""
        return torch.bitwise_or(s, mask_words)

    def add_mask_delta(self, s, mask_words):
        """mᵟ: only the bits not already present (optimal addᵟ)."""
        return torch.bitwise_and(mask_words, torch.bitwise_not(s))


@dataclasses.dataclass(frozen=True)
class GMap:
    """Table I GMap: keys ↪ max-versioned values (a version chain per key,
    which makes GCounter the particular case K=100)."""

    num_keys: int

    @property
    def lattice(self) -> Lattice:
        return MapLattice(self.num_keys, vl.max_int(), "gmap").build()

    def bump(self, m, key_mask):
        """m: inflate the value of every key in ``key_mask``."""
        return m + key_mask.to(m.dtype)

    def bump_delta(self, m, key_mask):
        """mᵟ: only the updated entries, at their new versions (optimal)."""
        return torch.where(key_mask, m + 1, torch.zeros_like(m))


@dataclasses.dataclass(frozen=True)
class LWWMap:
    """Keys ↪ lexicographic (timestamp, value) pairs — Retwis walls and
    timelines. States are ``(t, v)`` int32 tuples."""

    num_keys: int

    @property
    def lattice(self) -> Lattice:
        return MapLattice(self.num_keys, vl.lex_pair(), "lwwmap").build()

    def put(self, s, key, ts, val):
        t, v = s
        t, v = t.clone(), v.clone()
        t[..., key] = ts
        v[..., key] = val
        return (t, v)

    def put_delta(self, s, key, ts, val):
        t, v = s
        dt, dv = torch.zeros_like(t), torch.zeros_like(v)
        dt[..., key] = ts
        dv[..., key] = val
        return (dt, dv)


@dataclasses.dataclass(frozen=True)
class LexCounter:
    """Replicas ↪ (ℕ ⊠ ℕ) — a Cassandra-style counter (Appendix B: the
    single-writer principle keeps the lex product distributive: the first
    component is a chain and only the owner writes its own entry)."""

    num_replicas: int

    @property
    def lattice(self) -> Lattice:
        return MapLattice(self.num_replicas, vl.lex_pair(),
                          "lexcounter").build()

    def set_value(self, s, i, val):
        """Owner i sets its entry to an arbitrary value, bumping the
        version."""
        t, v = s
        t, v = t.clone(), v.clone()
        t[..., i] += 1
        v[..., i] = val
        return (t, v)

    def set_value_delta(self, s, i, val):
        t, v = s
        dt, dv = torch.zeros_like(t), torch.zeros_like(v)
        dt[..., i] = t[..., i] + 1
        dv[..., i] = val
        return (dt, dv)

    def value(self, s):
        return s[1].sum(-1)
