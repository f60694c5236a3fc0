"""Fault injection for the synchronous-round simulator, PyTorch counterpart
of ``repro.sync.faults`` (DESIGN.md §12).

A ``FaultSchedule`` models the three failure modes every scenario composes
from:

* **message loss**   — per-directed-edge Bernoulli drops,
* **partitions**     — deterministic windows cutting all edges across a
                       node grouping,
* **node churn**     — down/up windows (piecewise-constant down-sets).

All three compile, on the host with numpy, to two boolean tables — the same
draws as the JAX package, so the masks are bit-identical to its own:

* ``link_ok[T, N, P]`` — delivery of the directed message arriving at node
  ``n``'s receive slot ``q`` in round ``t`` (receiver-slot view),
* ``up[T, N]``         — node liveness per round.

:meth:`FaultSchedule.views` folds them into the per-round masks a run
reads, uploaded to the simulation's device once; the round loop slices
them (:meth:`FaultViews.at_round`) and never reads one on the host.

Fault semantics (every engine honours them identically):

* a *down* node executes no ops, sends nothing, receives nothing; its state
  and δ-buffer are frozen;
* ``tx`` counts every element an *up* node puts on the wire, delivered or
  not;
* a node whose sends were not all delivered in a round **retains** its
  δ-buffer instead of clearing it, and re-sends it next round.

With an all-ok schedule every mask is identity, so results are bit-equal to
the schedule-free simulator.

Batches: a sweep gives each config its own schedule, stacked by
:func:`stacked_views` into [T, B, N, P] / [T, B, N] masks; a keyed store
shares one schedule across its objects (a partition cuts the whole
store), viewed by :func:`shared_views` with a singleton object axis,
[T, 1, N, P] / [T, 1, N], that broadcasts to every object. Both are
uploaded once per run, as a single run's views are.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.sync.topology import Topology


class RoundFaults(NamedTuple):
    """One round's fault masks (device tensors); a batch's carry a leading
    [B] (per config) or [1] (store-shared) axis."""

    recv_ok: torch.Tensor   # bool [N, P] — message into slot (n, q) delivered
    send_ok: torch.Tensor   # bool [N, P] — send on (n, q)'s edge delivered
    up: torch.Tensor        # bool [N]


class FaultViews(NamedTuple):
    """Whole-run fault masks, [T, N, P] / [T, N] device tensors.

    ``recv_ok``/``send_ok`` are fully folded: a message is delivered iff
    the link is up AND both endpoints are up. ``send_ok[t, i, j]`` is the
    sender-side view of the same delivery bit (``recv_ok`` re-indexed
    through ``nbrs``/``rev``), so both sides of an edge agree.
    """

    recv_ok: torch.Tensor
    send_ok: torch.Tensor
    up: torch.Tensor

    def at_round(self, t: int) -> RoundFaults:
        """Round ``t``'s masks: views into the whole-run tensors."""
        return RoundFaults(recv_ok=self.recv_ok[t], send_ok=self.send_ok[t],
                           up=self.up[t])


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Per-round fault tables bound to one topology (host-side numpy)."""

    topo: Topology
    link_ok: np.ndarray    # bool [T, N, P], receiver-slot view
    up: np.ndarray         # bool [T, N]

    def __post_init__(self):
        t, n, p = self.link_ok.shape
        if (n, p) != (self.topo.num_nodes, self.topo.max_degree) \
                or self.up.shape != (t, n):
            raise ValueError(
                f"fault tables {self.link_ok.shape} / {self.up.shape} do not "
                f"match topology {self.topo.name!r} "
                f"({self.topo.num_nodes} nodes, degree {self.topo.max_degree})")

    @property
    def num_rounds(self) -> int:
        return self.link_ok.shape[0]

    @functools.cached_property
    def _mask(self) -> np.ndarray:
        return self.topo.mask.cpu().numpy()

    @functools.cached_property
    def _nbrs(self) -> np.ndarray:
        return self.topo.nbrs.cpu().numpy()

    @property
    def is_trivial(self) -> bool:
        return bool(self.link_ok[:, self._mask].all() and self.up.all())

    @property
    def last_fault_round(self) -> int:
        """Last round with any fault, or -1 for an all-ok schedule."""
        faulty = ~self.link_ok[:, self._mask].all(axis=-1) \
            | ~self.up.all(axis=-1)
        hits = np.nonzero(faulty)[0]
        return int(hits[-1]) if hits.size else -1

    # -- constructors --------------------------------------------------------

    @staticmethod
    def none(topo: Topology, rounds: int) -> "FaultSchedule":
        n, p = topo.num_nodes, topo.max_degree
        return FaultSchedule(topo=topo, link_ok=np.ones((rounds, n, p), bool),
                             up=np.ones((rounds, n), bool))

    @staticmethod
    def bernoulli(topo: Topology, rounds: int, rate: float,
                  seed: int = 0) -> "FaultSchedule":
        """IID per-directed-message loss at ``rate`` (each valid (round,
        receiver, slot) triple is one directed message)."""
        n, p = topo.num_nodes, topo.max_degree
        drop = np.random.default_rng(seed).random((rounds, n, p)) < rate
        sched = FaultSchedule.none(topo, rounds)
        link = sched.link_ok & ~(drop & topo.mask.cpu().numpy()[None])
        return dataclasses.replace(sched, link_ok=link)

    @staticmethod
    def partition(topo: Topology, rounds: int, start: int, stop: int,
                  groups: Sequence[int]) -> "FaultSchedule":
        """Cut every edge whose endpoints lie in different ``groups`` during
        rounds ``[start, stop)`` — a deterministic network partition."""
        groups = np.asarray(groups)
        if groups.shape != (topo.num_nodes,):
            raise ValueError(f"groups {groups.shape} != ({topo.num_nodes},)")
        cross = groups[:, None] != groups[topo.nbrs.cpu().numpy()]  # [N, P]
        window = np.zeros((rounds, 1, 1), bool)
        window[start:stop] = True
        sched = FaultSchedule.none(topo, rounds)
        link = sched.link_ok & ~(window & cross[None])
        return dataclasses.replace(sched, link_ok=link)

    @staticmethod
    def churn(topo: Topology, rounds: int,
              down_windows: Sequence[Tuple[int, int, int]]) -> "FaultSchedule":
        """Node down/up epochs: ``down_windows`` is a sequence of
        ``(node, start, stop)`` — node is down during ``[start, stop)``."""
        sched = FaultSchedule.none(topo, rounds)
        up = sched.up.copy()
        for node, start, stop in down_windows:
            up[start:stop, node] = False
        return dataclasses.replace(sched, up=up)

    @staticmethod
    def from_epochs(topo: Topology, rounds: int,
                    epochs: Sequence[Tuple[int, Sequence[int]]]
                    ) -> "FaultSchedule":
        """Churn from membership epochs: a piecewise-constant timeline
        ``[(start_round, down_set), ...]`` — each epoch's down-set holds
        until the next epoch begins. Rounds before the first epoch have
        everyone up."""
        sched = FaultSchedule.none(topo, rounds)
        up = sched.up.copy()
        ordered = sorted(epochs, key=lambda e: e[0])
        for i, (start, down) in enumerate(ordered):
            stop = ordered[i + 1][0] if i + 1 < len(ordered) else rounds
            for node in down:
                up[start:stop, node] = False
        return dataclasses.replace(sched, up=up)

    def same_topology(self, topo: Topology) -> bool:
        """Structural match: name and neighbour tables."""
        return (self.topo.name == topo.name
                and torch.equal(self.topo.nbrs.cpu(), topo.nbrs.cpu())
                and torch.equal(self.topo.mask.cpu(), topo.mask.cpu()))

    def compose(self, other: "FaultSchedule") -> "FaultSchedule":
        """Intersection of two schedules over the same topology (shorter
        schedule padded with all-ok)."""
        if not self.same_topology(other.topo):
            raise ValueError("schedules bound to different topologies")
        t = max(self.num_rounds, other.num_rounds)
        a, b = self._padded(t), other._padded(t)
        return FaultSchedule(topo=self.topo, link_ok=a.link_ok & b.link_ok,
                             up=a.up & b.up)

    def _padded(self, rounds: int) -> "FaultSchedule":
        t = self.num_rounds
        if t >= rounds:
            return self
        n, p = self.topo.num_nodes, self.topo.max_degree
        return FaultSchedule(
            topo=self.topo,
            link_ok=np.concatenate([self.link_ok,
                                    np.ones((rounds - t, n, p), bool)]),
            up=np.concatenate([self.up, np.ones((rounds - t, n), bool)]))

    # -- the run's masks -----------------------------------------------------

    def host_views(self, total_rounds: int) -> tuple:
        """Fold node liveness into per-edge delivery and derive the sender
        view; pad with all-ok up to ``total_rounds`` (rounds past the
        schedule are fault-free — the "eventually connected" tail). Returns
        the numpy ``(recv_ok, send_ok, up)`` tables."""
        s = self._padded(total_rounds)
        nbrs = self.topo.nbrs.cpu().numpy()
        rev = self.topo.rev.cpu().numpy()
        link_ok = s.link_ok[:total_rounds]
        up = s.up[:total_rounds]
        recv_ok = link_ok & up[:, nbrs] & up[:, :, None]
        send_ok = recv_ok[:, nbrs, rev]                    # sender's view
        return recv_ok, send_ok, up

    def views(self, total_rounds: int, device="cpu") -> FaultViews:
        """:meth:`host_views` uploaded to ``device`` once."""
        return _upload(self.host_views(total_rounds), device)

    # -- host-side queries ---------------------------------------------------

    def up_at(self, t: int, node: int) -> bool:
        if t >= self.num_rounds:
            return True
        return bool(self.up[t, node])

    def delivers(self, t: int, src: int, dst: int) -> bool:
        """Delivery of the directed message src → dst at round ``t`` (folds
        link state and both endpoints' liveness). Non-edges of the topology
        never deliver, at any round."""
        nbrs = self._nbrs[dst]
        slots = np.nonzero((nbrs == src) & self._mask[dst])[0]
        if slots.size == 0:
            return False
        if t >= self.num_rounds:
            return True
        if not (self.up[t, src] and self.up[t, dst]):
            return False
        return bool(self.link_ok[t, dst, slots[0]])

    def drop_fn(self, clock):
        """A ``runtime.LocalTransport.drop_fn`` driven by this schedule:
        ``clock`` is a zero-argument callable returning the current
        round."""
        return lambda src, dst: not self.delivers(clock(), src, dst)


def _upload(tables, device) -> FaultViews:
    return FaultViews(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                        for a in tables))


def stacked_views(schedules, topo: Topology, total_rounds: int,
                  device="cpu") -> FaultViews:
    """A sweep's per-config schedules (None: fault-free) as time-major
    stacked masks ``recv_ok``/``send_ok`` [T, B, N, P] and ``up``
    [T, B, N], uploaded to ``device`` once. Every schedule must be bound
    to ``topo``."""
    per_cell = []
    for b, sched in enumerate(schedules):
        if sched is None:
            sched = FaultSchedule.none(topo, total_rounds)
        elif not sched.same_topology(topo):
            raise ValueError(f"faults[{b}] was built for topology "
                             f"{sched.topo.name!r}, not {topo.name!r}")
        per_cell.append(sched.host_views(total_rounds))
    return _upload([np.stack([v[f] for v in per_cell], axis=1)
                    for f in range(3)], device)


def shared_views(schedule: FaultSchedule, total_rounds: int,
                 device="cpu") -> FaultViews:
    """One schedule for a whole store: its masks with a singleton object
    axis, [T, 1, N, P] / [T, 1, N], which broadcast to every object
    (O(T·N·P) memory, not O(T·B·N·P))."""
    return _upload([a[:, None] for a in schedule.host_views(total_rounds)],
                   device)
