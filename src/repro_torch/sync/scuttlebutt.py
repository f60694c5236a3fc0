"""Scuttlebutt anti-entropy baseline (paper §V-C), PyTorch counterpart of
``repro.sync.scuttlebutt``.

Van Renesse et al.'s push-pull reconciliation adapted to CRDT deltas as the
paper describes it: values are the optimal deltas of δ-mutators, keys are
(origin, seq) version pairs, a node's knowledge is a version vector
I ↪ ℕ, and the paper's *safe-delete* extension has each node track the
last summary vector seen from every node (a map I ↪ (I ↪ ℕ), gossiped on
exchange) and delete a delta once every node has seen it.

Per-origin versions are delivered in order, so a node's whole CRDT state is
a function of its version vector: a :class:`DeltaCodec` rebuilds states and
sizes from vectors, and the simulator carries only the O(N²) knowledge and
O(N³) seen matrices, not per-delta stores.

Scuttlebutt treats values as opaque: every (i, s) delta travels on its own
even where consecutive deltas would compress under join — the paper's
explanation for its poor GCounter numbers (§V-C a).

The rounds are a host loop over device tensors that reads no device value;
the per-round metrics move to the host once, at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.sync.simulator import resolve_device
from repro_torch.sync.topology import Topology


@dataclasses.dataclass(frozen=True)
class DeltaCodec:
    """A benchmark type's reconstruction of states and sizes from
    version vectors."""

    # join of all deltas {(i, s) | lo[i] < s ≤ hi[i]} as a dense state:
    # (lo [.., N], hi [.., N]) -> state [.., U]
    range_join: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    # elements in one (i, ·) delta, per origin: int32 [N]
    delta_elems: torch.Tensor
    # lattice-state size of a knowledge vector: (kv [.., N]) -> int [..]
    state_size: Callable[[torch.Tensor], torch.Tensor]


class ScuttlebuttResult(NamedTuple):
    tx: np.ndarray        # [T] data elements sent per round
    meta_tx: np.ndarray   # [T] metadata entries sent per round (vectors+seen)
    mem: np.ndarray       # [T] elements held (state + retained deltas)
    cpu: np.ndarray       # [T] element-ops proxy
    max_mem_node: np.ndarray
    final_kv: np.ndarray  # [N, N]
    final_x: torch.Tensor  # [N, U] final states, on the run's device

    @property
    def total_tx(self) -> int:
        return int(self.tx.sum())


def simulate(codec: DeltaCodec, topo: Topology, active_rounds: int,
             quiet_rounds: int = 0, device="cuda") -> ScuttlebuttResult:
    """``active_rounds`` rounds in which every node makes one update and
    reconciles with each neighbour, then ``quiet_rounds`` of reconciliation
    only, on ``device`` (the card by default; ``"cpu"`` runs on the CPU).
    The metrics are exact integers (int64 on the device)."""
    dev = resolve_device(device)
    n, p = topo.num_nodes, topo.max_degree
    t_ = topo.on(dev)
    nbrs, mask = t_.nbrs.long(), t_.mask
    de = codec.delta_elems.to(device=dev, dtype=torch.int64)
    i64 = torch.int64
    eye = torch.eye(n, dtype=torch.int32, device=dev)
    diag = eye.bool()[:, :, None]                       # [N, N, 1]
    # seen[i, nbrs[i, q]] flattened: the direct-observation scatter index
    flat = (torch.arange(n, device=dev)[:, None] * n + nbrs).reshape(-1)
    flat = flat[:, None].expand(n * p, n)
    mask3 = mask[:, :, None]
    edges2 = mask.sum(dtype=i64)                        # 2 · live edges
    meta = (edges2 // 2) * 2 * (n + n * n)
    merge_cpu = edges2 * (n + n * n)

    kv = torch.zeros((n, n), dtype=torch.int32, device=dev)
    seen = torch.zeros((n, n, n), dtype=torch.int32, device=dev)
    rounds = []
    for t in range(active_rounds + quiet_rounds):
        # (1) local op: bump the own sequence number
        if t < active_rounds:
            kv = kv + eye
        seen = torch.where(diag, torch.maximum(seen, kv[:, None, :]), seen)

        # (2) per-edge push-pull on the vectors as the round starts (each
        # undirected edge reconciles once a round, data flowing both ways):
        # node i receives recv[i, q] elements from neighbour q
        kv_nbr = kv[nbrs]                                   # [N, P, N]
        missing = torch.clamp_min(kv_nbr - kv[:, None, :], 0)
        recv = (missing.to(i64) * de).sum(-1) * mask        # [N, P]
        tx = recv.sum()

        # (3) knowledge merge
        gain = torch.where(mask3, kv_nbr, 0)
        kv_new = torch.maximum(kv, gain.amax(1))

        # (4) seen-map merge: the neighbours' gossiped seen maps, then the
        # direct observation seen[i][j] ⊔= kv[j] for each neighbour j — a
        # scatter-max (padded slots repeat an index; max keeps them all)
        seen_gain = torch.where(mask[:, :, None, None], seen[nbrs], 0)
        seen_new = torch.maximum(seen, seen_gain.amax(1))
        seen_new = seen_new.reshape(n * n, n).scatter_reduce(
            0, flat, gain.reshape(n * p, n), reduce="amax",
            include_self=True).reshape(n, n, n)
        seen_new = torch.where(diag, torch.maximum(seen_new,
                                                   kv_new[:, None, :]),
                               seen_new)

        # (5) memory: the state plus the deltas not yet seen by all
        floor = seen_new.amin(1)                            # [N, N]
        retained = (torch.clamp_min(kv_new - floor, 0).to(i64) * de).sum(-1)
        node_mem = codec.state_size(kv_new).to(i64) + retained
        rounds.append(torch.stack((tx, meta, node_mem.sum(), tx + merge_cpu,
                                   node_mem.amax())))
        kv, seen = kv_new, seen_new

    host = torch.stack(rounds, 1).cpu().numpy() if rounds \
        else np.zeros((5, 0), np.int64)
    return ScuttlebuttResult(
        tx=host[0], meta_tx=host[1], mem=host[2], cpu=host[3],
        max_mem_node=host[4], final_kv=kv.cpu().numpy(),
        final_x=codec.range_join(torch.zeros_like(kv), kv))


def summary_vector_elems(num_edges: int, num_nodes: int, rounds: int) -> int:
    """Mandatory data-plane overhead of Scuttlebutt reconciliation (Fig 7):
    each undirected edge reconciles once a round and *both* directions
    ship an N-entry summary vector, so ``2 · E · N`` entries a round. (The
    seen-map gossip for safe deletes is metadata, reported in Fig 9.)

    ``rounds`` is the number of rounds *charged*: fig7 passes only the
    active rounds — quiescent reconciliations ship vectors too, but
    charging them would penalise Scuttlebutt for the drain length chosen,
    so the accounting stays conservative toward the baseline.
    """
    return 2 * num_edges * num_nodes * rounds


def metadata_bytes_per_node(num_nodes: int, degree: int,
                            id_bytes: int = 20) -> int:
    """Fig 9 analytic curve: Scuttlebutt metadata per node = N²·P·S."""
    return num_nodes * num_nodes * degree * id_bytes


def delta_metadata_bytes_per_node(degree: int, id_bytes: int = 20) -> int:
    """Fig 9 analytic curve: delta-based metadata per node = P·S."""
    return degree * id_bytes
