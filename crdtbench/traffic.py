"""The one traffic generator: a mix file's parameters and a seed in, the
inputs a cell hands the program out.

Frozen copies of the repository's generators, so that a change to the
program cannot move the yardstick: the Retwis schedule (paper §V-D, Table
II; one ``numpy`` generator drawing targets, then kinds), its dense count
table [T, N, B] and per-object byte weights; the Table I GMap key blocks;
and the resync join's start (donors hold a quarter of every tile). Each
takes the seed's draws where the original has a fixed layout; seed 0 with
no rotation is the original.

A mix file (``mixes/<traffic>.json``) names its kind; ``kinds/<kind>.py``
makes one pool entry's inputs from these generators and the entry's seed.
"""

from __future__ import annotations

import numpy as np

from crdtbench import find

# Retwis (paper Table II): follow 15% (1 update), post 35% (1 update),
# timeline read 50% (none); byte sizes of §V-D.
RETWIS_MIX = ((0.15, 1), (0.35, 1), (0.50, 0))
ID_B, CONTENT_B, USER_B = 31, 270, 20
RETWIS_WEIGHTS = (USER_B, ID_B + CONTENT_B, ID_B + 8)  # follower, wall, timeline


def pool_seed(seed: int, entry: int) -> int:
    """The seed of pool entry ``entry`` of a run of ``seed`` (any
    non-negative integer)."""
    return int(np.random.SeedSequence([seed, entry]).generate_state(
        2, np.uint32).view(np.uint64)[0])


def zipf_probs(objects: int, zipf: float) -> np.ndarray:
    probs = np.arange(1, objects + 1, dtype=np.float64) ** -zipf
    return probs / probs.sum()


def retwis_streams(objects, nodes, rounds, ops, zipf, seed):
    """``(targets, kinds)`` [T, N, ops]: targets first, then kinds."""
    rng = np.random.default_rng(seed)
    shape = (rounds, nodes, ops)
    targets = rng.choice(objects, size=shape, p=zipf_probs(objects, zipf))
    kinds = rng.choice(len(RETWIS_MIX), size=shape,
                       p=np.asarray([p for p, _ in RETWIS_MIX]))
    return targets, kinds


def retwis_counts(objects, nodes, rounds, ops, zipf, seed) -> np.ndarray:
    """Updates node n applies to object b in round t, int32 [T, N, B]."""
    targets, kinds = retwis_streams(objects, nodes, rounds, ops, zipf, seed)
    counts = np.zeros((rounds, nodes, objects), np.int32)
    per_kind = np.asarray([u for _, u in RETWIS_MIX], np.int32)
    tt, nn, _ = np.indices(targets.shape)
    np.add.at(counts, (tt, nn, targets), per_kind[kinds])
    return counts


def retwis_weights(objects: int) -> np.ndarray:
    """Bytes an element of each object: the classes cycle follower set /
    wall / timeline."""
    return np.asarray(RETWIS_WEIGHTS, np.float64)[np.arange(objects) % 3]


def key_blocks(nodes: int, keys: int, k_pct: float,
               shift: int = 0) -> np.ndarray:
    """Table I GMap K%: disjoint per-node key blocks, K% of all keys
    together, each at the start of its node's span; rolled by ``shift``
    keys. bool [N, keys]."""
    span = keys // nodes
    per_node = min(max(int(round(keys * k_pct / 100.0 / nodes)), 1), span)
    blocks = np.zeros((nodes, keys), bool)
    for i in range(nodes):
        blocks[i, i * span:i * span + per_node] = True
    return np.roll(blocks, shift, axis=1)


def join_start(nodes: int, keys: int, tile: int, held: float, block: int,
               value: int, starts=None) -> np.ndarray:
    """The join's initial states int32 [N, keys]: replica 0 at ⊥, every
    other replica holding, in each ``tile``-key tile, ``held`` of its
    ``block``-key blocks, cyclically from block ``starts[tile]`` (0: the
    tile's first keys), at ``value``."""
    per_tile = tile // block
    tiles = keys // tile
    starts = np.zeros(tiles, np.int64) if starts is None else starts
    nheld = int(round(held * per_tile))
    blk = (np.arange(per_tile)[None, :] - starts[:, None]) % per_tile
    mask = np.repeat(blk < nheld, block, axis=1).reshape(-1)
    x0 = np.zeros((nodes, keys), np.int32)
    x0[1:] = np.where(mask, value, 0)
    return x0


def generate(mix: dict, config: dict, seed: int) -> list:
    """The pool of inputs of a run: one dict per pool entry, each made by
    the mix's kind from its own seed."""
    kind = find("kinds", mix["kind"])
    return [kind.entry(mix, config, pool_seed(seed, e))
            for e in range(mix.get("pool", 1))]
