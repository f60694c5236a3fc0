"""The data plane's replicated bookkeeping, PyTorch counterpart of the
``ShardLedger`` and ``ProgressCounter`` of ``repro.data.pipeline``.

Shard accounting is a *grow-only versioned map* (GMap with max-join)
replicated on every node and synchronised with BP+RR gossip: a node claims
a shard by bumping ``shard → claim-version`` and the claim survives
arbitrary node loss without a coordinator; a progress counter (GCounter)
gives global tokens-consumed metrics with no barrier. Both keep their
state on ``device`` (the card unless ``device="cpu"``).

The synthetic token pipeline of the JAX module (``DataConfig``,
``synth_block``, ``batch_for_step``) feeds the model side's training and
comes with the training slice (ROADMAP A6b).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import GCounter, GMap
from repro_torch.sync.simulator import resolve_device


class ShardLedger:
    """Replicated shard-claim ledger (one per node, gossip-synchronised).

    State: GMap over shard ids; value = claim version. A claim is a
    δ-mutation whose optimal delta the gossip runtime ships; re-claims are
    idempotent in effect (a shard's data is a function of its id)."""

    def __init__(self, num_shards: int, device="cuda"):
        self.gmap = GMap(num_keys=num_shards)
        self.state = self.gmap.lattice.bottom(resolve_device(device))

    def claim(self, shard: int):
        """Returns the optimal delta of this claim (to hand to gossip)."""
        mask = torch.zeros((self.gmap.num_keys,), dtype=torch.bool,
                           device=self.state.device)
        mask[shard] = True
        delta = self.gmap.bump_delta(self.state, mask)
        self.state = self.gmap.lattice.join(self.state, delta)
        return delta

    def merge(self, delta):
        self.state = self.gmap.lattice.join(self.state, delta)

    def claimed(self) -> np.ndarray:
        return (self.state > 0).cpu().numpy()

    def next_unclaimed(self, start: int = 0) -> Optional[int]:
        free = np.nonzero(~self.claimed())[0]
        if len(free) == 0:
            return None
        after = free[free >= start]
        return int(after[0] if len(after) else free[0])


class ProgressCounter:
    """Cluster-wide tokens-consumed GCounter (barrier-free metrics)."""

    def __init__(self, num_nodes: int, node_id: int, device="cuda"):
        self.gc = GCounter(num_replicas=num_nodes)
        self.node_id = node_id
        self.state = self.gc.lattice.bottom(resolve_device(device))

    def add(self, tokens: int):
        delta = torch.zeros_like(self.state)
        delta[self.node_id] = self.state[self.node_id] + tokens
        self.state = self.gc.lattice.join(self.state, delta)
        return delta

    def merge(self, delta):
        self.state = self.gc.lattice.join(self.state, delta)

    @property
    def total(self) -> int:
        return int(self.gc.value(self.state))
