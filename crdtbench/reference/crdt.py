"""Algorithms 1-2 and the digest-driven resync, in plain PyTorch.

States are max-int32 maps: a stack of objects ``x[B, N, U]`` (B objects,
N replicas, U slots), join = elementwise max, ⊥ = 0, and the size of a
state = its non-zero slots (the paper's element count). Every round each
replica (1) applies its op's δ, (2) sends to each neighbour, (3) clears its
δ-buffer and (4) joins what it received, slot by slot in the order of its
neighbour list (ascending ids). The per-object round metrics are those of
the paper's §V: elements sent (``tx``), held (``mem``: state plus buffered
entries), processed (``cpu``: applied, sent, received and stored) and the
fullest replica's ``mem``.

Faults: ``loss`` (bool [T, N, P]) loses the message into receive slot q of
replica n in round t; a sender whose messages were not all delivered keeps
its δ-buffer (acknowledged eviction) and sends it again. ``drop=(node,
slot)`` loses the message on that receive slot every round while the
sender clears its buffer all the same: it breaks the delivery guarantee
and is the benchmark's control.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from crdtbench.reference import digest as dg

DELTA_ALGORITHMS = ("state", "classic", "bp", "rr", "bprr")


class Routes(NamedTuple):
    """Neighbour tables [N, P]: ``nbrs[n, q]`` is the sender on receive
    slot q of replica n, ``rev[n, q]`` that sender's slot for n; ``plan[q]``
    lists, for each sender slot s, the receivers whose slot q it feeds and
    their senders."""

    nbrs: torch.Tensor
    mask: torch.Tensor
    rev: torch.Tensor
    plan: tuple


def mesh_lists(nodes: int, degree: int) -> list:
    """The circulant partial mesh: replica n linked with n ± 1 .. n ±
    degree/2 (mod N); neighbours in ascending id order."""
    return [sorted({(n + s * o) % nodes for o in range(1, degree // 2 + 1)
                    for s in (1, -1)}) for n in range(nodes)]


def routes(lists: list, device="cpu") -> Routes:
    """The routes of a topology given by its neighbour lists (each in
    ascending id order, the order a replica joins what it received)."""
    nodes = len(lists)
    p = max(len(nb) for nb in lists)
    nbrs = torch.zeros((nodes, p), dtype=torch.long)
    mask = torch.zeros((nodes, p), dtype=torch.bool)
    rev = torch.zeros((nodes, p), dtype=torch.long)
    for n, nb in enumerate(lists):
        for q, m in enumerate(nb):
            nbrs[n, q], mask[n, q], rev[n, q] = m, True, lists[m].index(n)
    plan = tuple(tuple(
        (s, torch.nonzero(rev[:, q] == s).flatten().to(device),
         nbrs[rev[:, q] == s, q].to(device))
        for s in range(p) if bool((rev[:, q] == s).any())) for q in range(p))
    return Routes(nbrs.to(device), mask.to(device), rev.to(device), plan)


def mesh_routes(nodes: int, degree: int, device="cpu") -> Routes:
    return routes(mesh_lists(nodes, degree), device)


def size(a: torch.Tensor) -> torch.Tensor:
    """Non-⊥ slots over the last axis, int64."""
    return (a != 0).sum(-1)


def slot_bumps(x: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """The versioned-slot op: ``cnt[B, N]`` slots of each replica's object,
    from the slot at (the object's version mod U) on, cyclically, each
    raised to its value + 1; the δ holds those slots (⊥ elsewhere)."""
    u = x.shape[-1]
    start = x.amax(-1, keepdim=True) % u
    cols = torch.arange(u, device=x.device)
    sel = (cols - start) % u < cnt[..., None]
    return torch.where(sel, x + 1, 0).to(x.dtype)


def block_bumps(x: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """The GMap op: every key of a replica's block ``blocks[N, U]`` raised
    to its value + 1."""
    return torch.where(blocks, x + 1, 0).to(x.dtype)


def _recv_valid(routes: Routes, q: int, drop, lost=None) -> torch.Tensor:
    valid = routes.mask[:, q].clone()
    if lost is not None:
        valid &= ~lost[:, q]
    if drop is not None and drop[1] == q:
        valid[drop[0]] = False
    return valid


def _routed(sends, routes: Routes, q: int) -> torch.Tensor:
    """Receive slot q of every replica: ``sends[rev[n, q]][:, nbrs[n, q]]``
    as [B, N, U]."""
    out = torch.empty_like(sends[0])
    for s, receivers, senders in routes.plan[q]:
        out[:, receivers] = sends[s][:, senders]
    return out


def delta_round(algo: str, x, buf, buf_elems, delta, routes: Routes,
                drop=None, lost=None):
    """One round of ``algo`` over objects ``x[B, N, U]``. ``buf``: a list
    of P + 1 origin slots (slot P = local ops) for bp/bprr, one state for
    classic/rr, None for state; ``lost`` this round's losses [N, P] or
    None. Returns ``(x, buf, buf_elems, metrics)`` with metrics ``(tx,
    mem, cpu, max_mem_node)``, each int64 [B]."""
    p = routes.nbrs.shape[1]
    per_origin, extracts = algo in ("bp", "bprr"), algo in ("rr", "bprr")
    dsz = size(delta)
    cpu = dsz.sum(1)
    x = torch.maximum(x, delta)
    if algo != "state":
        if per_origin:
            buf[p] = torch.maximum(buf[p], delta)
        else:
            buf = torch.maximum(buf, delta)
        buf_elems = buf_elems + dsz

    if algo == "state":
        sends = [x] * p
    elif per_origin:                     # BP: never back to the origin
        sends = []
        for q in range(p):
            acc = buf[p]
            for o in range(p):
                if o != q:
                    acc = torch.maximum(acc, buf[o])
            sends.append(acc)
    else:
        sends = [buf] * p
    tx = sum((size(s) * routes.mask[:, q]).sum(1) for q, s in
             enumerate(sends))
    cpu = cpu + tx

    if algo != "state":                  # clear what was acknowledged
        if lost is None:
            kept = torch.zeros(x.shape[1], dtype=torch.bool, device=x.device)
        else:                            # sender j's send on slot s
            acked = ~lost[routes.nbrs, routes.rev] | ~routes.mask
            kept = ~acked.all(1)
        keep_buf = kept[None, :, None]
        buf = [torch.where(keep_buf, b, 0) for b in buf] if per_origin \
            else torch.where(keep_buf, buf, 0)
        buf_elems = torch.where(kept[None], buf_elems, 0)

    for q in range(p):
        valid = _recv_valid(routes, q, drop, lost)
        d = torch.where(valid[None, :, None], _routed(sends, routes, q), 0)
        cpu = cpu + size(d).sum(1)
        if algo == "state":
            x = torch.maximum(x, d)
            continue
        if extracts:                     # RR: only what x lacks
            stored = torch.where(d > x, d, 0)
            keep = (stored != 0).any(-1) & valid
        else:                            # the whole group, if it inflates
            stored = d
            keep = (d > x).any(-1) & valid
        ssz = size(stored) * keep
        cpu = cpu + ssz.sum(1)
        x = torch.maximum(x, d)
        cur = buf[q] if per_origin else buf
        new = torch.where(keep[..., None], torch.maximum(cur, stored), cur)
        if per_origin:
            buf[q] = new
        else:
            buf = new
        buf_elems = buf_elems + ssz
        del d, stored

    node_mem = size(x) + buf_elems
    return x, buf, buf_elems, (tx, node_mem.sum(1), cpu, node_mem.amax(1))


def run_delta(algo: str, x0: torch.Tensor, op: Callable, routes: Routes,
              active: int, quiet: int, drop=None, loss=None):
    """``active`` op + sync rounds and ``quiet`` sync-only rounds of
    ``algo`` from ``x0[B, N, U]``; ``op(x, t)`` is round t's δ; ``loss``
    bool [T', N, P] the rounds' lost messages (none past T'). Returns
    ``(metrics int64 [4, T, B], final x, uniform bool [T, B])``: tx, mem,
    cpu, max_mem_node per round and object, and whether every replica of
    an object held the same state at the round's end."""
    if algo not in DELTA_ALGORITHMS:
        raise ValueError(f"unknown algorithm {algo!r}")
    p = routes.nbrs.shape[1]
    x = x0
    buf = None if algo == "state" else \
        [torch.zeros_like(x) for _ in range(p + 1)] \
        if algo in ("bp", "bprr") else torch.zeros_like(x)
    buf_elems = torch.zeros(x.shape[:2], dtype=torch.long, device=x.device)
    rows, uni = [], []
    for t in range(active + quiet):
        delta = op(x, t) if t < active else torch.zeros_like(x)
        lost = None if loss is None or t >= len(loss) else loss[t]
        x, buf, buf_elems, m = delta_round(algo, x, buf, buf_elems, delta,
                                           routes, drop, lost)
        rows.append(torch.stack(m))
        uni.append((x == x[:, :1]).all(-1).all(-1))
    return torch.stack(rows, 1), x, torch.stack(uni)


def run_digest(x0: torch.Tensor, routes: Routes, rounds: int, block: int,
               drop=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``digest_driven`` resync of one object ``x0[N, U]`` for ``rounds``
    sync-only rounds with digest blocks of ``block`` slots. Every round a
    replica digests its state, sends each neighbour the blocks whose
    digest differs from the last digest it had from that neighbour, and
    pays the Merkle descent of its tree against the neighbour's (capped at
    the flat digest); it then joins what it received and keeps the
    neighbours' digests. Returns ``(metrics int64 [4, T], final x,
    uniform bool [T])``."""
    n, u = x0.shape
    p = routes.nbrs.shape[1]
    nb = -(-u // block)
    words = dg.CHANNELS * nb
    x = x0
    dig = torch.zeros((p, n, nb, dg.CHANNELS), dtype=torch.int32,
                      device=x.device)
    have = torch.zeros((p, n), dtype=torch.bool, device=x.device)
    send = routes.mask.T                                   # [P, N]
    rows, uni = [], []
    for _ in range(rounds):
        local = dg.digest(x, block)                        # [N, nB, 3]
        blocks = (local[None] != dig).any(-1) & have[..., None]
        em = blocks.repeat_interleave(block, -1)[..., :u]
        sends = torch.where(em, x[None], 0)                # [P, N, U]
        theirs = local[routes.nbrs.T]                      # [P, N, nB, 3]
        desc = torch.clamp_max(dg.descent_words(local[None], theirs), words)
        tx = (size(sends) * send).sum() + (desc * send).sum()
        cpu = tx.clone()
        recv = []
        for q in range(p):
            valid = _recv_valid(routes, q, drop)
            d = sends[routes.rev[:, q], routes.nbrs[:, q]]
            recv.append(torch.where(valid[:, None], d, 0))
        for q, d in enumerate(recv):
            cpu = cpu + size(d).sum()
            x = torch.maximum(x, d)
        valid = torch.stack([_recv_valid(routes, q, drop)
                             for q in range(p)])           # [P, N]
        dig = torch.where(valid[..., None, None], theirs, dig)
        have = have | valid
        cpu = cpu + n * u
        node_mem = size(x) + have.sum(0) * words
        rows.append(torch.stack([tx, node_mem.sum(), cpu, node_mem.max()]))
        uni.append((x == x[:1]).all())
    return torch.stack(rows, 1), x, torch.stack(uni)
