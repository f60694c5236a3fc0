"""Table I micro-benchmark op streams (paper §V-A), PyTorch counterpart of the
Table I part of ``repro.sync.workloads``.

Each builder returns ``op_fn(x, t) -> delta`` for ``simulate``: ``x`` is the
[N, ...U] cluster state and ``t`` the round as a Python int. Index and value
tables are built once per device on first use, so a round issues device
work only (no host-to-device copy inside the round loop).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _per_device(build: Callable[[torch.device], tuple]):
    """Memoize ``build(device)`` — the op's constant tables — per device."""
    cache = {}

    def get(device):
        if device not in cache:
            cache[device] = build(device)
        return cache[device]

    return get


def gset_unique_op(nodes: int, events: int) -> Callable:
    """Table I GSet: one globally unique element per node and round — node
    n adds ``n·events + min(t, events-1)`` — over a GSet of N·events
    elements (the JAX package's seed-0, paper-canonical stream)."""
    ids = (np.arange(nodes)[None, :] * events
           + np.arange(events)[:, None])                    # [events, N]
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
