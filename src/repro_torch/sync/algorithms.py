"""Synchronization algorithms (paper §IV, Algorithms 1 & 2), PyTorch
counterpart of the δ-family part of ``repro.sync.algorithms``:

* ``state``    — state-based full-state sync (baseline)
* ``classic``  — classic delta-based, Algorithm 1
* ``bp``       — + avoid back-propagation of δ-groups (origin tags)
* ``rr``       — + remove redundant state in received δ-groups (Δ-extract)
* ``bprr``     — Algorithm 2 (BP + RR), the paper's contribution

Buffers: entries with equal origin are kept joined in an origin-indexed slot
of a slot-major ``B[P+1, N, U]`` (slot P = local ops) for the BP flavours,
one flat ``[N, U]`` buffer for classic/rr; ``buf_elems`` tracks the entries'
sizes for the memory metric. The BP sends are a leave-one-out join across
slots, by prefix/suffix joins (``loo="prefix"``) or the direct O(P²) fold
(``"naive"``). Sends are slot-major too, ``[P, N, U]``: send ``q`` of node
``n`` is ``d_all[q, n]``. The JAX package keeps the node axis first;
``repro_torch.convert`` swaps the two axes of a carried buffer.

A round is one call of :meth:`SyncAlgorithm.round_step`; it never reads a
device value on the host, so a loop of rounds only queues device work.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core.lattice import Lattice
from repro_torch.sync import engine as engine_mod
from repro_torch.sync import treeops as T
from repro_torch.sync.topology import Topology

ALGORITHMS = ("state", "classic", "bp", "rr", "bprr")


class RoundMetrics(NamedTuple):
    tx: torch.Tensor            # elements sent this round (0-d)
    mem: torch.Tensor           # elements held (state + buffer entries)
    cpu: torch.Tensor           # element-ops processed this round (proxy)
    max_mem_node: torch.Tensor  # worst single-node memory


class AlgoCarry(NamedTuple):
    x: torch.Tensor                # [N, U] lattice states
    buf: Optional[torch.Tensor]    # None | [N, U] | [P+1, N, U]
    buf_elems: torch.Tensor        # int32 [N] buffered entry elements


@dataclasses.dataclass(frozen=True)
class SyncAlgorithm:
    """One δ-family algorithm over a topology whose tables lie on the
    device the simulation runs on."""

    name: str
    lattice: Lattice
    topo: Topology
    loo: str = "prefix"          # leave-one-out strategy of the BP sends
    engine: str = "reference"    # "reference" | "fused" | "mega"
    metric_dtype: torch.dtype = torch.int64   # round-metric accumulators

    def __post_init__(self):
        if self.name not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.name!r}; expected "
                             f"one of {ALGORITHMS}")
        if self.loo not in ("prefix", "naive"):
            raise ValueError(f"unknown loo strategy {self.loo!r}")

    @property
    def resolved_engine(self) -> str:
        """Requested engine after the dense-kernel fallback."""
        return engine_mod.resolve(self.engine, self.lattice)

    @property
    def device(self) -> torch.device:
        return self.topo.nbrs.device

    @property
    def has_buffer(self) -> bool:
        return self.name != "state"

    @property
    def per_origin(self) -> bool:
        return self.name in ("bp", "bprr")

    @property
    def extracts(self) -> bool:
        return self.name in ("rr", "bprr")

    @functools.cached_property
    def active(self) -> torch.Tensor:
        """int32 [1, N, P] receive mask of the kernels (topology padding)."""
        return self.topo.mask.to(torch.int32)[None].contiguous()

    @functools.cached_property
    def delivered(self) -> torch.Tensor:
        """int32 [1, N] ack mask of the kernels: every send is delivered."""
        return torch.ones((1, self.topo.num_nodes), dtype=torch.int32,
                          device=self.device)

    @staticmethod
    def msum(v: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
        """Metric sum over every axis, in the accumulator dtype."""
        return v.to(acc).sum(dtype=acc)

    # -- state ---------------------------------------------------------------

    def init(self, x0=None) -> AlgoCarry:
        n, p = self.topo.num_nodes, self.topo.max_degree
        bot = self.lattice.bottom(self.device)
        x = T.bcast(bot, (n,)) if x0 is None else x0.to(self.device)
        if not self.has_buffer:
            buf = None
        elif self.per_origin:
            buf = T.bcast(bot, (p + 1, n))
        else:
            buf = T.bcast(bot, (n,))
        return AlgoCarry(x=x, buf=buf, buf_elems=torch.zeros(
            n, dtype=torch.int32, device=self.device))

    # -- sends ---------------------------------------------------------------

    def _loo_sends(self, buf):
        """d[p, i] = ⊔ {B[o, i] | o ≠ p} for p in 0..P-1 (slot P always in)."""
        lat = self.lattice
        p = self.topo.max_degree
        if self.resolved_engine in engine_mod.KERNEL_ENGINES:
            return engine_mod.fused_loo_sends(buf, lat.kernel_kind)
        slots = [T.slot(buf, k) for k in range(p + 1)]
        if self.loo == "naive":
            outs = []
            for j in range(p):
                acc = None
                for o in range(p + 1):
                    if o != j:
                        acc = slots[o] if acc is None else lat.join(acc, slots[o])
                outs.append(acc)
        else:
            bot = torch.zeros_like(slots[0])
            prefix, suffix = [None] * (p + 1), [None] * (p + 1)
            acc = bot
            for k in range(p + 1):
                prefix[k] = acc
                acc = lat.join(acc, slots[k])
            acc = bot
            for k in range(p, -1, -1):
                suffix[k] = acc
                acc = lat.join(acc, slots[k])
            outs = [lat.join(prefix[j], suffix[j]) for j in range(p)]
        return torch.stack(outs)                           # [P, N, U]

    def _bcast_sends(self, state):
        """One per-node state over the P send slots: [N, U] -> [P, N, U]
        (a broadcast view)."""
        p = self.topo.max_degree
        return state.unsqueeze(0).expand((p,) + tuple(state.shape))

    # -- one synchronous round -----------------------------------------------

    def round_step(self, carry: AlgoCarry, op_delta):
        """One synchronous round; returns ``(carry, RoundMetrics)``."""
        lat, topo, acc = self.lattice, self.topo, self.metric_dtype
        p = topo.max_degree
        x, buf, buf_elems = carry

        if self.resolved_engine == "mega":
            x, buf, buf_elems, tx, cpu, state_elems = engine_mod.mega_round(
                self, x, buf, buf_elems, op_delta)
            return AlgoCarry(x, buf, buf_elems), self._metrics(
                tx, cpu, state_elems, buf_elems)

        # (1) local update: δ = mᵟ(xᵢ); store(δ, i)      [Alg 2, lines 6-8]
        dsz = lat.size(op_delta)                                   # [N]
        x = lat.join(x, op_delta)
        if self.has_buffer:
            if self.per_origin:
                buf = T.set_slot(buf, p, lat.join(T.slot(buf, p), op_delta))
            else:
                buf = lat.join(buf, op_delta)
            buf_elems = buf_elems + dsz
        cpu = self.msum(dsz, acc)

        # (2) sends                                        [Alg 2, lines 9-12]
        if not self.has_buffer:
            d_all = self._bcast_sends(x)
        elif self.per_origin:
            d_all = self._loo_sends(buf)
        else:
            d_all = self._bcast_sends(buf)
        tx = self.msum(lat.size(d_all) * topo.mask.T, acc)
        cpu = cpu + tx  # serialization cost ∝ elements sent

        # (3) clear buffer                                 [Alg 2, line 13]
        if self.has_buffer:
            buf = torch.zeros_like(buf)
            buf_elems = torch.zeros_like(buf_elems)

        # (4) receive all messages, sequentially per slot  [Alg 2, lines 14-17]
        if self.resolved_engine == "fused":
            x, buf, buf_elems, cpu = engine_mod.fused_receive(
                self, x, buf, buf_elems, cpu, d_all)
        else:
            x, buf, buf_elems, cpu = self._receive_reference(
                x, buf, buf_elems, cpu, d_all)

        # (5) metrics
        return AlgoCarry(x, buf, buf_elems), self._metrics(
            tx, cpu, lat.size(x), buf_elems)

    def _metrics(self, tx, cpu, state_elems, buf_elems) -> RoundMetrics:
        acc = self.metric_dtype
        node_mem = state_elems.to(acc) + buf_elems.to(acc)
        return RoundMetrics(tx=tx, mem=node_mem.sum(dtype=acc), cpu=cpu,
                            max_mem_node=node_mem.max())

    def _receive_reference(self, x, buf, buf_elems, cpu, d_all):
        """Reference receive: the sequential per-slot loop."""
        lat, topo, acc = self.lattice, self.topo, self.metric_dtype
        for q in range(topo.max_degree):
            valid = topo.mask[:, q]
            d = T.where_bot(valid, d_all[topo.rev[:, q].long(),
                                         topo.nbrs[:, q].long()])
            if self.name == "state":
                cpu = cpu + self.msum(lat.size(d), acc)
                x = lat.join(x, d)
                continue
            if self.extracts:
                stored = lat.delta(d, x)                       # RR: Δ(d, xᵢ)
                keep = torch.logical_not(lat.is_bottom(stored)) & valid
            else:
                stored = d                                     # whole group
                keep = torch.logical_not(lat.leq(d, x)) & valid  # inflation
            ssz = lat.size(stored) * keep
            cpu = cpu + self.msum(lat.size(d), acc) + self.msum(ssz, acc)
            x = lat.join(x, d)
            if self.per_origin:
                cur = T.slot(buf, q)
                buf = T.set_slot(buf, q, T.where(keep, lat.join(cur, stored),
                                                 cur))
            else:
                buf = T.where(keep, lat.join(buf, stored), buf)
            buf_elems = buf_elems + ssz
        return x, buf, buf_elems, cpu
