"""Per-round telemetry channels, PyTorch counterpart of
``repro.obs.telemetry``.

Aggregate tx totals cannot show the paper's central claim — classic delta
propagation ships state the receiver already holds (§I, Fig. 1). These
channels measure the mechanism per round and per node, on the device,
beside the round's metrics:

* ``recv_elems`` / ``novel_elems`` — delivered payload elements and the
  part that was new at join time (|Δ(d, x_running)| per received slot, in
  slot order: the kernels' ``cnt`` tally). The **redundancy ratio** is
  ``1 − novel/recv``.
* ``stale_rounds`` — rounds since the node's state last grew (an own op or
  a novel delivery resets it).
* ``buf_elems`` — δ-buffer occupancy at round end.
* ``ack_lag`` — rounds since the node's sends were last all delivered (0
  without faults and for bufferless algorithms).
* ``div_gap`` — the node's element gap to the running cluster-wide join
  ``Y_t = ⊔_n x_n``: ``|Δ(Y_t, x_n)|``; once ops cease ``Y_t`` is the
  converged state, so this is the distance left to convergence.

Digest and descent words (``digest_driven``'s metadata) are not payload
and stay out of ``recv_elems``; tx prices them.

``alg`` is duck-typed (``lattice``, ``topo``, ``lead``, ``batched``,
``has_buffer``, ``device``), so this module imports nothing of
``repro_torch.sync``. The channels ride the round loop as a
:class:`TelemetryCarry` (two int32 per-node counters) and one
:class:`TelemetryChannels` a round; the per-round values stay on the device
and reach the host with the round metrics. With ``telemetry=None`` the
round loop queues no extra work, which keeps every other result
bit-identical.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.lattice import tree_map


@dataclasses.dataclass(frozen=True)
class TelemetrySpec:
    """Which channel groups to compute (all on by default). A disabled
    group's channel comes back as zeros: ``redundancy`` the per-slot
    novelty counts (free on the kernel engines, whose kernels count them;
    one Δ + size pass a slot on the reference engine), ``staleness`` one
    leq pass, ``buffer`` nothing (occupancy is in the carry),
    ``divergence`` an N-way join fold and one Δ + size pass."""

    redundancy: bool = True
    staleness: bool = True
    buffer: bool = True
    divergence: bool = True

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


class TelemetryCarry(NamedTuple):
    stale: torch.Tensor   # int32 [(B,) N] rounds since the state last grew
    ack: torch.Tensor     # int32 [(B,) N] rounds since sends last delivered


class TelemetryChannels(NamedTuple):
    """One round's channel values, each [(B,) N] int32 (the store's
    reduced-aggregate mode: [1, N] in the metric accumulator dtype,
    summed or maxed over the objects)."""

    recv_elems: torch.Tensor
    novel_elems: torch.Tensor
    stale_rounds: torch.Tensor
    ack_lag: torch.Tensor
    buf_elems: torch.Tensor
    div_gap: torch.Tensor


def init_carry(alg) -> TelemetryCarry:
    """Zero counters, two distinct tensors."""
    return TelemetryCarry(
        stale=torch.zeros(alg.lead, dtype=torch.int32, device=alg.device),
        ack=torch.zeros(alg.lead, dtype=torch.int32, device=alg.device))


def _cluster_join(lat, x, n: int, ax: int):
    """⊔ over the node axis (at ``ax``) of a stacked state: a fold of N−1
    joins (N is small)."""
    acc = tree_map(lambda a: a.select(ax, 0), x)
    for i in range(1, n):
        acc = lat.join(acc, tree_map(lambda a, i=i: a.select(ax, i), x))
    return acc


def cluster_gap(lat, x, n: int, batched: bool) -> torch.Tensor:
    """Per-node element gap to the cluster-wide join, |Δ(⊔_m x_m, x_n)|,
    int32 [(B,) N]."""
    ax = 1 if batched else 0
    y = _cluster_join(lat, x, n, ax)
    yb = tree_map(lambda yl, xl: yl.unsqueeze(ax).expand_as(xl), y, x)
    return lat.size(lat.delta(yb, x)).to(torch.int32)


def round_channels(spec: TelemetrySpec, alg, tele: TelemetryCarry,
                   x_before, carry, recv, faults):
    """One round's channels from the round's output carry: ``x_before``
    is the state at round start (before the op), ``recv`` the ``(recv,
    novel)`` pair of ``round_step(recv_counts=True)`` (None when
    redundancy is off), ``faults`` the round's ``RoundFaults`` as the
    round took them ([N, P], per config [B, N, P] or store-shared
    [1, N, P]) or None. Returns ``(TelemetryCarry, TelemetryChannels)``."""
    lat = alg.lattice
    z = torch.zeros_like(carry.buf_elems)                 # int32 [(B,) N]
    zero = z.new_zeros(())

    if spec.redundancy and recv is not None:
        recv_e, novel_e = (r.to(torch.int32) for r in recv)
    else:
        recv_e, novel_e = z, z

    stale = tele.stale
    if spec.staleness:
        grew = torch.logical_not(lat.leq(carry.x, x_before))
        stale = torch.where(grew, zero, tele.stale + 1)

    ack = tele.ack
    if spec.buffer and alg.has_buffer and faults is not None:
        delivered = torch.all(faults.send_ok | ~alg.topo.mask, dim=-1) \
            & faults.up
        ack = torch.where(delivered, zero, tele.ack + 1)

    buf_occ = carry.buf_elems.to(torch.int32) if spec.buffer else z
    gap = cluster_gap(lat, carry.x, alg.topo.num_nodes, alg.batched) \
        if spec.divergence else z
    return TelemetryCarry(stale=stale, ack=ack), TelemetryChannels(
        recv_elems=recv_e, novel_elems=novel_e,
        stale_rounds=stale if spec.staleness else z,
        ack_lag=ack if spec.buffer else z,
        buf_elems=buf_occ, div_gap=gap)


class TelemetryResult(NamedTuple):
    """Host-side channels: [T, N] arrays ([B, T, N] for sweeps and
    stores; a store's reduced-aggregate mode holds one partial, B = 1:
    sums for recv/novel/buf, maxes for stale/ack/gap)."""

    recv_elems: np.ndarray
    novel_elems: np.ndarray
    stale_rounds: np.ndarray
    ack_lag: np.ndarray
    buf_elems: np.ndarray
    div_gap: np.ndarray
    spec: TelemetrySpec

    @property
    def batch(self) -> Optional[int]:
        return int(self.recv_elems.shape[0]) \
            if self.recv_elems.ndim == 3 else None

    def cell(self, b: int) -> "TelemetryResult":
        if self.batch is None:
            raise ValueError("not a batched telemetry result")
        return TelemetryResult(*(a[b] for a in self[:6]), spec=self.spec)

    def take_lead(self, b: int) -> "TelemetryResult":
        """The first ``b`` entries of the batch axis."""
        if self.batch is None:
            raise ValueError("not a batched telemetry result")
        return TelemetryResult(*(a[:b] for a in self[:6]), spec=self.spec)

    @classmethod
    def cat(cls, parts) -> "TelemetryResult":
        """Batched results of consecutive blocks of the batch axis as one:
        every channel concatenated, the spec shared."""
        return cls(**{f: np.concatenate([getattr(p, f) for p in parts])
                      for f in cls._fields if f != "spec"},
                   spec=parts[0].spec)

    @property
    def redundant_elems(self) -> np.ndarray:
        """Received-but-already-known elements per (round, node)."""
        return self.recv_elems.astype(np.int64) \
            - self.novel_elems.astype(np.int64)

    def redundancy_over_time(self) -> np.ndarray:
        """[T] ([B, T]) share of the round's received payload that was
        redundant, nodes summed; NaN for rounds that received nothing."""
        recv = self.recv_elems.astype(np.float64).sum(axis=-1)
        red = self.redundant_elems.astype(np.float64).sum(axis=-1)
        return np.divide(red, recv, out=np.full_like(recv, np.nan),
                         where=recv > 0)

    def total_redundancy(self):
        """The run's redundancy ratio 1 − Σnovel/Σrecv (a float; [B]
        batched)."""
        ax = (-2, -1)
        recv = self.recv_elems.astype(np.float64).sum(axis=ax)
        red = self.redundant_elems.astype(np.float64).sum(axis=ax)
        out = np.divide(red, recv, out=np.full_like(recv, np.nan),
                        where=recv > 0)
        return float(out) if out.ndim == 0 else out


def collect(spec: TelemetrySpec, channels, batched: bool) -> TelemetryResult:
    """Time-major host channels ([T, (B,) N] numpy arrays) as a
    :class:`TelemetryResult` (batch-major when ``batched``), after the
    overflow check: the channels are tallies, so a negative value means
    an accumulator wrapped."""
    arrays = [np.ascontiguousarray(a.swapaxes(0, 1) if batched else a)
              for a in channels]
    for name, a in zip(TelemetryChannels._fields, arrays):
        if (a < 0).any():
            raise OverflowError(
                f"telemetry counter {name!r} overflowed its accumulator "
                f"(negative tallies): rerun with wide_metrics=True")
    return TelemetryResult(*arrays, spec=spec)
