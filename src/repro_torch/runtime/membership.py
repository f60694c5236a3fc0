"""Cluster membership, heartbeats, failure detection, elastic rebuild,
PyTorch counterpart of ``repro.runtime.membership``.

Membership = GSet of node slots (grow-only; departures are *suspected* via
heartbeat staleness rather than removed — monotone, partition-safe).
Heartbeats = GMap node → monotone beat counter. Both gossip via BP+RR, with
their deltas built on the node's device.

``ElasticPlan`` derives the data-parallel assignment from the converged
view: alive nodes get contiguous DP ranks; a mesh-rebuild hook consumes the
plan (a real rebuild re-initialises the runtime with the survivor topology
and restores from the replicated checkpoint registry — exercised in-process
by the tests and ``repro_torch.elastic_churn``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core import GMap, GSet
from repro_torch.runtime.gossip import GossipNode

MEMBERS = "members"
HEARTBEATS = "heartbeats"


def register_membership(node: GossipNode, max_nodes: int):
    node.register(MEMBERS, GSet(universe=max_nodes).lattice)
    node.register(HEARTBEATS, GMap(num_keys=max_nodes).lattice)


def join_cluster(node: GossipNode, max_nodes: int):
    delta = torch.zeros((max_nodes,), dtype=torch.bool, device=node.device)
    delta[node.id] = True
    node.update(MEMBERS, delta)
    beat(node, max_nodes)


def beat(node: GossipNode, max_nodes: int):
    hb = node.state(HEARTBEATS)
    delta = torch.zeros_like(hb)
    delta[node.id] = hb[node.id] + 1
    node.update(HEARTBEATS, delta)


@dataclasses.dataclass
class FailureDetector:
    staleness_rounds: int = 3
    _last_seen: Dict[int, tuple] = dataclasses.field(default_factory=dict)

    def suspects(self, node: GossipNode, round_no: int) -> List[int]:
        members = np.nonzero(node.state(MEMBERS).cpu().numpy())[0]
        beats = node.state(HEARTBEATS).cpu().numpy()
        out = []
        for m in members:
            m = int(m)
            prev_beat, prev_round = self._last_seen.get(m, (-1, round_no))
            if beats[m] > prev_beat:
                self._last_seen[m] = (int(beats[m]), round_no)
            elif round_no - prev_round >= self.staleness_rounds:
                out.append(m)
        return out


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    alive: tuple
    dp_rank: Dict[int, int]
    dp_size: int

    @property
    def world_size(self) -> int:
        return len(self.alive)


def plan_from_view(node: GossipNode, suspects: List[int]) -> ElasticPlan:
    members = np.nonzero(node.state(MEMBERS).cpu().numpy())[0]
    alive = tuple(int(m) for m in members if int(m) not in set(suspects))
    return ElasticPlan(
        alive=alive,
        dp_rank={m: i for i, m in enumerate(alive)},
        dp_size=len(alive),
    )
