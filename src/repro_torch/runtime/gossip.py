"""Gossip runtime: BP+RR synchronization of registered CRDT stores,
PyTorch counterpart of ``repro.runtime.gossip``.

This is Algorithm 2 run as the *control plane* of a training fleet. Each
node hosts a ``GossipNode`` with named CRDT stores (membership, heartbeats,
shard ledger, checkpoint registry, metrics). Local mutations enqueue their
optimal deltas (δ-mutators); ``sync_round`` exchanges per-neighbour
leave-one-out joins with origin filtering and Δ-extraction on receive —
Algorithm 2, per store.

A node keeps every store's state and δ-buffer on its device (the card by
default, ``device="cpu"`` for the CPU). The host drives the protocol
message by message; it reads from the device once per store a node pushes
(every neighbour's payload size) and once per message it receives (the ⊥
test and the novel count) — the JAX runtime reads a size per send, the
size again on receive, and the ⊥ test apart. The iteration orders
(buffers in insertion order, sends in neighbour order, receives in mailbox
order) and the chaos hooks' draws are the JAX package's, so every count
comes out equal to its run.

``LocalTransport`` is an in-process message board used by tests and
examples (and by the elastic-churn simulation); the algorithmic layer is
transport-agnostic (state-based CRDTs tolerate drops, duplication and
reordering).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.lattice import Lattice
from repro_torch.sync import treeops as T
from repro_torch.sync.simulator import resolve_device


def _dense(lattice: Lattice) -> bool:
    """A map of scalar values under max (GSet, GCounter, GMap): ⊥ is 0 in
    every slot and every nonzero slot is one irreducible."""
    return lattice.kernel_kind == "max"


def _size(lattice: Lattice, a) -> torch.Tensor:
    """|⇓a| as an int64 0-d tensor on a's device (one launch for a dense
    map)."""
    if _dense(lattice):
        return torch.count_nonzero(a)
    return lattice.size(a).to(torch.int64)


@dataclasses.dataclass
class Store:
    name: str
    lattice: Lattice
    state: Any
    # origin-tagged δ-buffer: origin id -> joined delta (BP tags)
    buffer: Dict[int, Any] = dataclasses.field(default_factory=dict)

    def local_update(self, delta, self_id: int):
        self.state = self.lattice.join(self.state, delta)
        self._store(delta, self_id)

    def _store(self, delta, origin: int):
        if origin in self.buffer:
            self.buffer[origin] = self.lattice.join(self.buffer[origin], delta)
        else:
            self.buffer[origin] = delta

    def send_to(self, neighbor: int):
        """Leave-one-out join: every buffered delta except ones from
        ``neighbor`` (BP); None when nothing is left."""
        acc = None
        for origin, d in self.buffer.items():
            if origin == neighbor:
                continue
            acc = d if acc is None else self.lattice.join(acc, d)
        return acc

    def receive(self, d, origin: int) -> int:
        """RR: extract Δ(d, x); store only the novel part. Returns the
        novel element count (telemetry)."""
        lat = self.lattice
        if _dense(lat):
            # Δ keeps d's novel slots and is ⊥ elsewhere: its size is the
            # novel count, and it is ⊥ exactly when that count is 0
            keep = lat.novel_mask(d, self.state)
            novel = int(keep.sum())
            if novel == 0:
                return 0
            s = T.where_bot(keep, d)
        else:
            s = lat.delta(d, self.state)
            # one host read for the ⊥ test and the count together
            bottom, novel = torch.stack([
                lat.is_bottom(s).to(torch.int64),
                lat.size(s).to(torch.int64)]).tolist()
            if bottom:
                return 0
        self.state = lat.join(self.state, s)
        self._store(s, origin)
        return novel

    def clear(self):
        self.buffer.clear()


class LocalTransport:
    """In-process mailbox (tests and simulations). Messages may be dropped
    or duplicated by the chaos hooks (``drop_fn`` composes with
    ``sync.faults.FaultSchedule.drop_fn``); CRDT sync tolerates both.

    ``send`` returns whether the message was delivered — an acked
    transport, which lets the sender gate buffer eviction (the retention
    rule the round simulator applies). A message carries the size its
    sender computed, so the receiver does not read it from the device
    again."""

    def __init__(self):
        self.mail: Dict[int, List[Tuple[int, str, Any, int]]] = {}
        self.drop_fn: Optional[Callable[[int, int], bool]] = None
        self.dup_fn: Optional[Callable[[int, int], bool]] = None
        self.sent_elements = 0

    def send(self, src: int, dst: int, store: str, payload, size: int) -> bool:
        # the wire cost is paid whether or not the message survives the
        # link, as in the round simulator's tx
        self.sent_elements += size
        if self.drop_fn is not None and self.drop_fn(src, dst):
            return False
        self.mail.setdefault(dst, []).append((src, store, payload, size))
        if self.dup_fn is not None and self.dup_fn(src, dst):
            self.mail.setdefault(dst, []).append((src, store, payload, size))
            self.sent_elements += size
        return True

    def drain(self, node: int):
        msgs = self.mail.get(node, [])
        self.mail[node] = []
        return msgs


class GossipNode:
    """One replica of the control plane: named stores on ``device`` (the
    card unless ``device="cpu"``; a CUDA device without a card raises)."""

    def __init__(self, node_id: int, neighbors: List[int],
                 transport: LocalTransport, device="cuda"):
        self.id = node_id
        self.neighbors = list(neighbors)
        self.transport = transport
        self.device = resolve_device(device)
        self.stores: Dict[str, Store] = {}
        self.rx_novel = 0
        self.rx_redundant = 0

    def register(self, name: str, lattice: Lattice, state=None):
        self.stores[name] = Store(
            name=name, lattice=lattice,
            state=lattice.bottom(self.device) if state is None
            else T.to(state, self.device))

    def update(self, store: str, delta):
        self.stores[store].local_update(delta, self.id)

    def state(self, store: str):
        return self.stores[store].state

    def push(self):
        """Send buffered deltas to all neighbours (Alg 2 lines 9-13).

        Ack-gated eviction: the buffer is cleared only when every
        neighbour acked delivery; otherwise it is kept and re-sent next
        round. Without retention a δ-group dropped on its only path (any
        tree edge) would be lost forever; with it, retransmission costs
        little because receivers that already saw the data RR-extract it
        to ⊥ on arrival."""
        for st in self.stores.values():
            sends = [(j, st.send_to(j)) for j in self.neighbors]
            sends = [(j, d) for j, d in sends if d is not None]
            # every neighbour's payload size in one host read
            sizes = torch.stack([_size(st.lattice, d) for _, d in sends]) \
                .tolist() if sends else []
            all_acked = True
            for (j, d), size in zip(sends, sizes):
                if size == 0:
                    continue
                all_acked &= self.transport.send(self.id, j, st.name, d, size)
            if all_acked:
                st.clear()

    def pull(self):
        """Process received δ-groups (Alg 2 lines 14-17)."""
        for src, store, payload, total in self.transport.drain(self.id):
            st = self.stores.get(store)
            if st is None:
                continue
            novel = st.receive(payload, src)
            self.rx_novel += novel
            self.rx_redundant += total - novel


def bootstrap(joiner: GossipNode, peer: GossipNode) -> int:
    """State-driven sync on (re)join (paper §VI, Enes et al. PMLDC'16).

    Deltas only carry *new* changes; a node (re)joining after loss must
    exchange full states once with one peer: both sides RR-extract the
    novel part, buffer it with the partner's origin tag, and gossip
    propagates it onward. Returns the transmitted elements (the recovery
    cost)."""
    cost = 0
    for name, st in peer.stores.items():
        if name in joiner.stores:
            cost += int(st.lattice.size(st.state))
            joiner.stores[name].receive(st.state, peer.id)
    for name, st in joiner.stores.items():
        if name in peer.stores:
            cost += int(st.lattice.size(st.state))
            peer.stores[name].receive(st.state, joiner.id)
    return cost


def sync_round(nodes: Dict[int, GossipNode]):
    for n in nodes.values():
        n.push()
    for n in nodes.values():
        n.pull()


def converged(nodes: Dict[int, GossipNode], store: str) -> bool:
    vals = [n.stores[store] for n in nodes.values()]
    first = vals[0]
    for other in vals[1:]:
        le = first.lattice.leq(first.state, other.state)
        ge = first.lattice.leq(other.state, first.state)
        if not (bool(le) and bool(ge)):
            return False
    return True
