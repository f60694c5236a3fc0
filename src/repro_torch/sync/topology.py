"""Network topologies (paper §V-B, Figure 6), as fixed-degree neighbor tables:

* ``nbrs[N, P]`` — neighbor ids, padded (padding entries point at node 0)
* ``mask[N, P]`` — validity of each slot
* ``rev[N, P]``  — for receiver r and slot p with sender s = nbrs[r, p], the
                   slot q on s such that nbrs[s, q] == r (undirected graphs).

The tables are CPU tensors (int32, bool, int32), the same tables the JAX
package builds; ``on(device)`` moves them to where a simulation runs.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Topology:
    name: str
    num_nodes: int
    max_degree: int
    nbrs: torch.Tensor   # int32 [N, P]
    mask: torch.Tensor   # bool  [N, P]
    rev: torch.Tensor    # int32 [N, P]

    @property
    def num_edges(self) -> int:
        """Undirected edges: every one fills a slot at both ends."""
        return int(self.mask.sum()) // 2

    def on(self, device) -> "Topology":
        """The same topology with its tables on ``device``."""
        return dataclasses.replace(self, nbrs=self.nbrs.to(device),
                                   mask=self.mask.to(device),
                                   rev=self.rev.to(device))

    def neighbor_lists(self) -> list:
        """Each node's neighbour ids in slot order (host lists, padding
        dropped) — what a gossip node is built with."""
        nbrs, mask = self.nbrs.cpu().tolist(), self.mask.cpu().tolist()
        return [[j for j, ok in zip(row, ok_row) if ok]
                for row, ok_row in zip(nbrs, mask)]

    @functools.cached_property
    def routes(self):
        """Slot-major int64 gather indices ``(rev.T, nbrs.T)`` [P, N]:
        inbox[q, n] = sends[rev[n, q], nbrs[n, q]]. Built once per
        topology (a store's tiled tables hold millions of rows)."""
        return (self.rev.T.long().contiguous(),
                self.nbrs.T.long().contiguous())

    def tiled(self, copies: int) -> "Topology":
        """``copies`` disjoint copies of this topology as one topology of
        copies·N nodes: node b·N + i is node i of copy b, its neighbours
        are the copies of its neighbours in copy b, and the slots and
        their reverse slots are unchanged. A sweep's configs (or a store's
        objects) share the network but never exchange messages, so one
        round over the tiled topology is every copy's round side by
        side."""
        n = self.num_nodes
        off = (torch.arange(copies, dtype=torch.int32,
                            device=self.nbrs.device) * n)[:, None, None]

        def tile(a):
            return a.expand((copies,) + tuple(a.shape)).reshape(
                copies * n, self.max_degree)

        return Topology(f"{self.name}x{copies}", copies * n, self.max_degree,
                        (self.nbrs[None] + off).reshape(copies * n, -1),
                        tile(self.mask), tile(self.rev))


def from_tables(name: str, nbrs, mask, rev) -> Topology:
    """A topology from existing [N, P] tables (numpy or tensors)."""
    nbrs = torch.tensor(np.asarray(nbrs), dtype=torch.int32)
    n, p = nbrs.shape
    return Topology(name, n, p, nbrs,
                    torch.tensor(np.asarray(mask), dtype=torch.bool),
                    torch.tensor(np.asarray(rev), dtype=torch.int32))


def _from_adj(name: str, adj: np.ndarray) -> Topology:
    n = adj.shape[0]
    if not ((adj == adj.T).all() and not adj.diagonal().any()):
        raise ValueError("topology must be undirected without self-loops")
    lists = [np.nonzero(adj[i])[0].tolist() for i in range(n)]
    p = max(len(l) for l in lists)
    nbrs = np.zeros((n, p), np.int32)
    mask = np.zeros((n, p), bool)
    for i, l in enumerate(lists):
        nbrs[i, : len(l)] = l
        mask[i, : len(l)] = True
    rev = np.zeros((n, p), np.int32)
    for i, l in enumerate(lists):
        for q, j in enumerate(l):
            rev[i, q] = lists[j].index(i)
    return from_tables(name, nbrs, mask, rev)


def tree(num_nodes: int) -> Topology:
    """Binary tree: root has 2 neighbors, internal nodes 3, leaves 1 — the
    paper's 15-node tree (Figure 6, right)."""
    adj = np.zeros((num_nodes, num_nodes), bool)
    for i in range(1, num_nodes):
        parent = (i - 1) // 2
        adj[i, parent] = adj[parent, i] = True
    return _from_adj(f"tree{num_nodes}", adj)


def partial_mesh(num_nodes: int, degree: int = 4) -> Topology:
    """Circulant partial mesh: each node links with ``degree`` neighbors at
    ring offsets ±1..±degree/2 — the paper's 15-node partial mesh
    (Figure 6, left)."""
    if degree % 2 or degree >= num_nodes:
        raise ValueError("partial_mesh needs an even degree below num_nodes")
    adj = np.zeros((num_nodes, num_nodes), bool)
    for i in range(num_nodes):
        for off in range(1, degree // 2 + 1):
            j = (i + off) % num_nodes
            adj[i, j] = adj[j, i] = True
    return _from_adj(f"mesh{num_nodes}d{degree}", adj)


def ring(num_nodes: int) -> Topology:
    adj = np.zeros((num_nodes, num_nodes), bool)
    for i in range(num_nodes):
        adj[i, (i + 1) % num_nodes] = adj[(i + 1) % num_nodes, i] = True
    return _from_adj(f"ring{num_nodes}", adj)


def full(num_nodes: int) -> Topology:
    return _from_adj(f"full{num_nodes}", ~np.eye(num_nodes, dtype=bool))


def by_name(name: str, num_nodes: int, degree: int = 4) -> Topology:
    if name == "tree":
        return tree(num_nodes)
    if name == "mesh":
        return partial_mesh(num_nodes, degree)
    if name == "ring":
        return ring(num_nodes)
    if name == "full":
        return full(num_nodes)
    raise ValueError(f"unknown topology {name!r}")
