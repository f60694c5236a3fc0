"""Deterministic synthetic data and the data plane's replicated
bookkeeping, PyTorch port of ``repro.data.pipeline``.

Token blocks are a pure function of (seed, shard, position), drawn with
numpy from ``SeedSequence([seed, shard, index])`` as in the JAX package, so
the two packages train on the same tokens bit for bit and any node can
(re)produce any shard: re-training a shard after a failure is idempotent
because its content is a function of its id. ``batch_for_step`` builds one
global batch on ``device`` (the card unless ``device="cpu"``).

Shard accounting is a *grow-only versioned map* (GMap with max-join)
replicated on every node and synchronised with BP+RR gossip: a node claims
a shard by bumping ``shard → claim-version`` and the claim survives
arbitrary node loss without a coordinator; a progress counter (GCounter)
gives global tokens-consumed metrics with no barrier. Both keep their
state on ``device`` (the card unless ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import GCounter, GMap
from repro_torch.sync.simulator import resolve_device


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_shards: int = 1024
    seed: int = 1234


def synth_block(cfg: DataConfig, shard: int, index: int) -> np.ndarray:
    """Deterministic token block [seq_len + 1] for (shard, index)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, shard, index]))
    return rng.integers(0, cfg.vocab_size, size=cfg.seq_len + 1,
                        dtype=np.int32)


def _bf16(a: np.ndarray, dev) -> torch.Tensor:
    """float64 draws -> bf16 through float32: the two roundings of the JAX
    package's conversion."""
    return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)


def batch_for_step(cfg: DataConfig, shard: int, step: int,
                   frontend: Optional[str] = None, d_model: int = 0,
                   frontend_len: int = 0, device="cuda"):
    """One global batch from a shard on ``device``, shaped like the JAX
    package's: int32 ``tokens``/``labels``, a bf16 ``loss_mask``, and bf16
    ``embeds`` for the audio (frames, no tokens) and vision (patches, then
    the tokens after them) frontends."""
    dev = resolve_device(device)
    toks = np.stack([synth_block(cfg, shard, step * cfg.global_batch + i)
                     for i in range(cfg.global_batch)])
    tokens, labels = toks[:, :-1], toks[:, 1:]
    batch = {"labels": torch.from_numpy(np.ascontiguousarray(labels)).to(dev),
             "loss_mask": torch.ones(labels.shape, dtype=torch.bfloat16,
                                     device=dev)}
    if frontend == "audio":
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, shard, step, 7]))
        batch["embeds"] = _bf16(
            rng.normal(size=(cfg.global_batch, cfg.seq_len, d_model)), dev)
    elif frontend == "vision":
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, shard, step, 8]))
        batch["embeds"] = _bf16(
            rng.normal(size=(cfg.global_batch, frontend_len, d_model)), dev)
        batch["tokens"] = torch.from_numpy(
            np.ascontiguousarray(tokens[:, frontend_len:])).to(dev)
    else:
        batch["tokens"] = torch.from_numpy(np.ascontiguousarray(tokens)).to(dev)
    return batch


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
