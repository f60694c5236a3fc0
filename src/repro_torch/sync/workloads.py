"""Reproducible op streams, PyTorch counterpart of ``repro.sync.workloads``:

* **Keyed store workloads** — the paper's Retwis macro-benchmark (§V-D,
  Table II) targets *objects* of a store by a Zipf distribution and draws
  op kinds (follow / post / read) from a fixed mix. :class:`WorkloadSpec`
  holds that shape (``zipf`` / ``uniform`` / ``hotset`` targeting, a mix
  with per-kind update counts, a seed) and compiles it to the dense
  per-round update-count table [T, N, B] that :func:`versioned_slot_op`
  turns into the store's op stream. The draws come from one
  ``np.random.default_rng(seed)`` in the JAX package's call order
  (targets, then kinds), so the tables equal its own array for array.
* **Table I micro-benchmark streams** (paper §V-A) — unique-element GSet
  adds, per-replica GCounter increments, disjoint GMap key blocks — and
  their sweep variants (the seed-permutation scheme: seed 0 is the
  paper-canonical stream).

Each builder returns ``op_fn(x, t) -> delta``: ``x`` is the [(B,) N, ...U]
state and ``t`` the round as a Python int. Index and value tables are built
once per device on first use, so a round issues device work only (no
host-to-device copy inside the round loop).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.slot_bump import slot_bump
from repro_torch.sync.scuttlebutt import DeltaCodec

# Retwis byte sizes (paper §V-D): tweet ids, tweet content, node/user ids.
ID_B, CONTENT_B, USER_B = 31, 270, 20
FOLLOW_B = USER_B                 # follower entry: one user id
WALL_B = ID_B + CONTENT_B         # wall entry: tweet id + content
TL_B = ID_B + 8                   # timeline entry: tweet id + timestamp

DISTS = ("zipf", "uniform", "hotset")


def _per_device(build: Callable[[torch.device], tuple]):
    """Memoize ``build(device)`` — the op's constant tables — per device."""
    cache = {}

    def get(device):
        if device not in cache:
            cache[device] = build(device)
        return cache[device]

    return get


def seed_perm(events: int, seed: int) -> np.ndarray:
    """The sweep seed convention: seed 0 is the identity permutation (the
    paper-canonical stream); another seed permutes which unique element
    lands each round."""
    if seed == 0:
        return np.arange(events)
    return np.random.default_rng(seed).permutation(events)


def gset_unique_op(nodes: int, events: int, seed: int = 0) -> Callable:
    """Table I GSet: one globally unique element per node and round — node
    n adds ``n·events + perm[min(t, events-1)]`` with ``perm`` the
    ``seed`` permutation (seed 0: the paper-canonical identity) — over a
    GSet of N·events elements."""
    ids = (np.arange(nodes)[None, :] * events
           + seed_perm(events, seed)[:, None])              # [events, N]
    tables = _per_device(lambda dev: (
        torch.arange(nodes, device=dev),
        torch.as_tensor(ids, dtype=torch.int64, device=dev)))

    def op_fn(x, t):
        rows, id_tab = tables(x.device)
        d = torch.zeros((nodes, nodes * events), dtype=torch.bool,
                        device=x.device)
        d[rows, id_tab[min(t, events - 1)]] = True
        return d

    return op_fn


def bitgset_unique_op(nodes: int, events: int, stride: int = 1) -> Callable:
    """The GSet stream on a BitGSet: node n adds bit
    ``(n·events + min(t, events-1)) · stride`` in round t. ``stride`` 1 packs
    the ids densely (``benchmarks/bench_engine.py``); a larger stride
    spreads them over a larger universe, one bit per word. Each bit is one
    irreducible, so every metric equals the GSet(N·events) run's."""
    ids = (np.arange(nodes)[None, :] * events
           + np.arange(events)[:, None]) * stride           # [events, N]
    words = (ids // 32).astype(np.int64)
    bits = (np.uint32(1) << (ids % 32).astype(np.uint32)).view(np.int32)
    tables = _per_device(lambda dev: (
        torch.arange(nodes, device=dev),
        torch.as_tensor(words, device=dev),
        torch.as_tensor(bits, device=dev)))

    def op_fn(x, t):
        rows, w_tab, b_tab = tables(x.device)
        tc = min(t, events - 1)
        m = torch.zeros_like(x)
        m[rows, w_tab[tc]] = b_tab[tc]
        return torch.bitwise_and(m, torch.bitwise_not(x))   # optimal addᵟ

    return op_fn


def gcounter_op(nodes: int) -> Callable:
    """Table I GCounter: one increment per node and round."""

    def op_fn(x, t):
        return torch.diag(torch.diagonal(x) + 1)

    return op_fn


def gmap_key_blocks(nodes: int, keys: int, k_pct: int) -> np.ndarray:
    """Table I GMap K%: disjoint per-node key blocks such that K% of all keys
    change per round; block widths are clamped to the per-node span so they
    never overlap. Returns bool [N, keys]."""
    span = keys // nodes
    per_node = min(max(int(round(keys * k_pct / 100.0 / nodes)), 1), span)
    blocks = np.zeros((nodes, keys), bool)
    for i in range(nodes):
        start = i * span
        blocks[i, start:start + per_node] = True
    return blocks


def gmap_block_op(nodes: int, keys: int, k_pct: int) -> Callable:
    """Table I GMap K%: each node bumps the versions of its key block."""
    blocks = _per_device(lambda dev: torch.as_tensor(
        gmap_key_blocks(nodes, keys, k_pct), device=dev))

    def op_fn(x, t):
        return torch.where(blocks(x.device), x + 1, 0).to(x.dtype)

    return op_fn


def gset_unique_sweep_op(nodes: int, events: int,
                         seeds: Sequence[int]) -> Callable:
    """Batched :func:`gset_unique_op`: cell b runs ``seeds[b]``'s
    permutation (one seed: every cell the same stream)."""
    perms = np.stack([seed_perm(events, s) for s in seeds])      # [S, T]
    tables = _per_device(lambda dev: (
        torch.arange(nodes, device=dev),
        torch.as_tensor(perms, dtype=torch.int64, device=dev)))

    def op_fn(x, t):
        b = x.shape[0]
        if b != len(seeds) and len(seeds) != 1:
            raise ValueError(
                f"op stream built for {len(seeds)} seeds cannot serve a "
                f"batch of {b} cells: pass one seed (broadcast) or one per "
                f"cell")
        rows, tab = tables(x.device)
        tc = min(t, events - 1)
        ids = rows[None, :] * events + tab[:, tc, None].expand(b, nodes) \
            if len(seeds) == b else \
            (rows * events + tab[0, tc]).expand(b, nodes)        # [B, N]
        d = torch.zeros((b, nodes, nodes * events), dtype=torch.bool,
                        device=x.device)
        d.scatter_(2, ids[..., None], True)
        return d

    if len(seeds) > 1:
        # a sharded sweep's block of cells runs its own seeds
        op_fn.for_block = lambda lo, hi: gset_unique_sweep_op(
            nodes, events, seeds[lo:hi])
    return op_fn


def gcounter_sweep_op(nodes: int) -> Callable:
    """Batched GCounter increments (every cell the same)."""

    def op_fn(x, t):
        return torch.diag_embed(torch.diagonal(x, dim1=-2, dim2=-1) + 1)

    return op_fn


# -- Scuttlebutt codecs (the fig7 / fig9 / fig10 baseline) ----------------------

def scuttlebutt_gset_codec(nodes: int, events: int) -> DeltaCodec:
    """Table I GSet as version vectors: delta (i, s) adds element
    i·events + s − 1."""

    def range_join(lo, hi):
        s_idx = torch.arange(events, device=lo.device)
        mask = (s_idx >= lo[..., :, None]) & (s_idx < hi[..., :, None])
        return mask.reshape(tuple(lo.shape[:-1]) + (nodes * events,))

    return DeltaCodec(range_join=range_join,
                      delta_elems=torch.ones(nodes, dtype=torch.int32),
                      state_size=lambda kv: kv.sum(-1, dtype=torch.int32))


def scuttlebutt_gcounter_codec(nodes: int) -> DeltaCodec:
    """Table I GCounter as version vectors: node i's entry is its
    sequence number."""
    return DeltaCodec(
        range_join=lambda lo, hi: torch.where(hi > lo, hi, 0),
        delta_elems=torch.ones(nodes, dtype=torch.int32),
        state_size=lambda kv: (kv > 0).sum(-1, dtype=torch.int32))


def scuttlebutt_gmap_codec(k_pct: int, nodes: int, keys: int) -> DeltaCodec:
    """Table I GMap K% as version vectors, over the same key blocks as
    :func:`gmap_block_op`: every key of node i's block holds i's sequence
    number. The join over origins folds one [.., U] plane an origin (not
    an [.., N, U] product: 3.8 GB at 4,194,304 keys and N = 15)."""
    blocks_np = gmap_key_blocks(nodes, keys, k_pct)
    per_node = int(blocks_np.sum(axis=1)[0])
    blocks = _per_device(lambda dev: torch.as_tensor(blocks_np, device=dev))

    def range_join(lo, hi):
        ver = torch.where(hi > lo, hi, 0)                  # [.., N]
        b = blocks(ver.device)
        out = None
        for i in range(nodes):
            v = torch.where(b[i], ver[..., i, None], 0)
            out = v if out is None else torch.maximum(out, v)
        return out

    return DeltaCodec(
        range_join=range_join,
        delta_elems=torch.full((nodes,), per_node, dtype=torch.int32),
        state_size=lambda kv: ((kv > 0).to(torch.int32) * per_node).sum(
            -1, dtype=torch.int32))


# -- keyed store workloads (Retwis) -----------------------------------------------

@dataclasses.dataclass(frozen=True)
class OpKind:
    """One op kind of a mix: drawn with probability ``prob``; each drawn op
    updates ``updates`` elements of its target object (0 = a read)."""

    name: str
    prob: float
    updates: int = 1


# Paper Table II: 15% follow (1 update), 35% post (1 update on the target
# wall/timeline object), 50% timeline read (no update).
RETWIS_MIX = (OpKind("follow", 0.15, 1),
              OpKind("post", 0.35, 1),
              OpKind("read", 0.50, 0))


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """A keyed-store workload: B objects targeted per (round, node, op) by
    ``dist``, op kinds drawn from ``mix``.

    ``zipf`` is the contention coefficient (rank probability ∝
    rank^-zipf); ``hotset`` puts ``hot_mass`` of the probability uniformly
    on the first ``ceil(hot_frac · B)`` objects. All draws come from ONE
    ``np.random.default_rng(seed)`` in a fixed order.
    """

    objects: int
    nodes: int
    rounds: int
    ops_per_node: int = 1
    dist: str = "zipf"
    zipf: float = 1.0
    hot_frac: float = 0.1
    hot_mass: float = 0.9
    mix: Tuple[OpKind, ...] = RETWIS_MIX
    seed: int = 0

    def __post_init__(self):
        if min(self.objects, self.nodes, self.rounds, self.ops_per_node) < 1:
            raise ValueError("objects/nodes/rounds/ops_per_node must be >= 1")
        if self.dist not in DISTS:
            raise ValueError(f"unknown dist {self.dist!r}; one of {DISTS}")
        if self.dist == "hotset" and not (0 < self.hot_frac <= 1
                                          and 0 <= self.hot_mass <= 1):
            raise ValueError("hotset needs 0 < hot_frac <= 1, "
                             "0 <= hot_mass <= 1")
        if not self.mix or any(k.prob < 0 for k in self.mix):
            raise ValueError("mix must be non-empty with prob >= 0")
        if sum(k.prob for k in self.mix) <= 0:
            raise ValueError("mix probabilities must not all be zero")

    def object_probs(self) -> np.ndarray:
        """Per-object targeting probabilities [B], float64, summing to 1."""
        b = self.objects
        if self.dist == "zipf":
            probs = np.arange(1, b + 1, dtype=np.float64) ** -self.zipf
        elif self.dist == "uniform":
            probs = np.ones(b, np.float64)
        else:                                            # hotset
            hot = max(int(np.ceil(self.hot_frac * b)), 1)
            probs = np.full(b, (1.0 - self.hot_mass) / max(b - hot, 1),
                            np.float64)
            probs[:hot] = self.hot_mass / hot
            if hot == b:                                 # all hot
                probs[:] = 1.0 / b
        return probs / probs.sum()

    def kind_probs(self) -> np.ndarray:
        p = np.asarray([k.prob for k in self.mix], np.float64)
        s = p.sum()
        # only a genuinely unnormalised mix is renormalised: dividing a
        # normalised one would move the sampling cdf by ULPs and could
        # change a seeded draw
        return p if abs(s - 1.0) <= 1e-9 else p / s

    def streams(self) -> Tuple[np.ndarray, np.ndarray]:
        """The raw schedule ``(targets, kinds)``, both [T, N, K]: targets
        first, then kinds, from one rng (the call order is the
        contract)."""
        rng = np.random.default_rng(self.seed)
        shape = (self.rounds, self.nodes, self.ops_per_node)
        targets = rng.choice(self.objects, size=shape, p=self.object_probs())
        kinds = rng.choice(len(self.mix), size=shape, p=self.kind_probs())
        return targets, kinds

    def update_counts(self) -> np.ndarray:
        """Dense update-count table [T, N, B] int32: how many updates node
        n applies to object b in round t (reads add nothing)."""
        targets, kinds = self.streams()
        upd = np.zeros((self.rounds, self.nodes, self.objects), np.int32)
        per_kind = np.asarray([k.updates for k in self.mix], np.int32)
        tt, nn, _ = np.indices(targets.shape)
        np.add.at(upd, (tt, nn, targets), per_kind[kinds])
        return upd


def retwis(objects: int, nodes: int, rounds: int, ops_per_node: int,
           zipf: float, seed: int = 0) -> WorkloadSpec:
    """The paper's Retwis macro-benchmark shape (§V-D, Table II)."""
    return WorkloadSpec(objects=objects, nodes=nodes, rounds=rounds,
                        ops_per_node=ops_per_node, dist="zipf", zipf=zipf,
                        mix=RETWIS_MIX, seed=seed)


def retwis_weights(objects: int) -> np.ndarray:
    """Per-object element byte weights [B]: the object classes cycle
    follower set / wall / timeline (20 B / 301 B / 39 B)."""
    return np.asarray([FOLLOW_B, WALL_B, TL_B], np.float64)[
        np.arange(objects) % 3]


def versioned_slot_op(counts: np.ndarray, slots: int) -> Callable:
    """Store op stream over versioned-slot objects (the Retwis model: each
    object is a ``MapLattice(slots, max_int)``).

    ``counts`` [T, N, B]: per-(round, node, object) update counts. Each
    node bumps ``cnt`` slots of the object starting at a rotating index
    derived from the object's current version, so concurrent updates from
    different nodes hit overlapping slots — the contention of the paper's
    Zipf workload. Returns an op_fn over stacked states [B, N, slots]
    (:func:`repro_torch.kernels.slot_bump.slot_bump`: one kernel launch a
    round on a card); the count table goes to a device once, as [T, B, N],
    at the op's first call there. Its ``for_block(lo, hi)`` is the op
    stream of objects [lo, hi) alone: a sharded store
    (``simulate_store(shard=True)``) runs it on each device's block; each
    block's op is built once and cuts its own [T, hi - lo, N] table
    straight from ``counts`` at its first call, so a sharded run never
    makes the whole store's table. ``counts`` (int32 is kept
    without a copy) is read when a table is made: leave it unchanged."""
    counts = np.asarray(counts, np.int32)
    op_fn = _slot_op(counts, 0, counts.shape[2], slots)
    blocks = {}

    def for_block(lo: int, hi: int) -> Callable:
        """The op stream of objects [lo, hi); rows at or past the table's
        objects (the shard pad) take no ops."""
        if (lo, hi) not in blocks:
            blocks[lo, hi] = _slot_op(counts, lo, hi, slots)
        return blocks[lo, hi]

    op_fn.for_block = for_block
    return op_fn


def _count_table(counts: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Objects [lo, hi) of the counts [T, N, B] as an update table [T, hi -
    lo, N]; rows at or past B take no ops."""
    t, n, b = counts.shape
    out = np.zeros((t, hi - lo, n), np.int32)
    out[:, :max(min(hi, b) - lo, 0)] = counts[:, :, lo:hi].transpose(0, 2, 1)
    return out


def _slot_op(counts: np.ndarray, lo: int, hi: int, slots: int) -> Callable:
    """:func:`versioned_slot_op` over objects [lo, hi) of ``counts``."""
    tables = _per_device(lambda dev: torch.as_tensor(
        _count_table(counts, lo, hi), device=dev))

    def op_fn(x, t):
        if x.shape[0] != hi - lo:
            raise ValueError(f"count table built for {hi - lo} objects "
                             f"cannot serve {x.shape[0]} object rows")
        return slot_bump(x, tables(x.device)[t], slots)

    return op_fn


def versioned_slot_cell_op(counts: np.ndarray, obj: int,
                           slots: int) -> Callable:
    """Single-object :func:`versioned_slot_op` of object ``obj``: an op_fn
    over [N, slots] states for a per-object ``simulate`` run."""
    upd = np.ascontiguousarray(np.asarray(counts, np.int32)[:, :, obj])
    tables = _per_device(lambda dev: torch.as_tensor(upd, device=dev))

    def op_fn(x, t):
        return slot_bump(x, tables(x.device)[t], slots)

    return op_fn
