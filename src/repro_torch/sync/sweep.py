"""One-program sweep engine: a whole experiment grid over a leading config
axis, PyTorch counterpart of ``repro.sync.sweep``.

The paper's evaluation figures are grids over {algorithm × topology × seed ×
fault level}. A sweep runs B configurations that share one algorithm,
lattice and topology as one batched run:

* states gain a leading config axis ([B, N, ...U]), slot-major buffers
  become [K, B, N, ...U], fault masks stack to [T, B, N, P];
* each round is the same ``SyncAlgorithm.round_step`` a single run takes,
  over the B disjoint copies of the topology (``Topology.tiled``): every
  per-node operation is the same and only the metric sums reduce per
  config, so **every cell is bit-identical (states and all metrics) to its
  single ``simulate`` run** on every engine;
* metrics come back per config ([B, T]), with per-config
  ``convergence_round()`` and ``SimResult.cell(b)`` single-run views.

What cannot batch: the algorithm (buffers differ in shape), the topology
and the lattice. A figure grid loops over those and sweeps the rest.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core.lattice import Lattice
from repro_torch.obs import provenance as prv
from repro_torch.obs import telemetry as tel
from repro_torch.sync import treeops as T
from repro_torch.sync.algorithms import SyncAlgorithm
from repro_torch.sync.digest import DigestSpec
from repro_torch.sync.faults import FaultSchedule, FaultViews, stacked_views
from repro_torch.sync.simulator import (SimResult, check_obs,
                                        collect_result, resolve_device,
                                        run_rounds, wrap_carry)
from repro_torch.sync.topology import Topology


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """The per-config ingredients of one sweep.

    ``op_fn(x, t) -> delta`` sees the stacked states [B, N, ...U] and
    returns stacked deltas: the config axis is where per-cell seeds, op
    rates and workload variants live. :meth:`stack_op` builds one from B
    single-run op_fns.

    ``x0``: optional stacked initial states [B, N, ...U] (None = all-⊥).

    ``faults``: optional per-cell schedules, one entry per config (None:
    a fault-free cell), all bound to the shared topology; they are folded
    once into stacked [T, B, N, P] masks (:meth:`stacked_views`).
    """

    batch: int
    op_fn: Callable
    x0: object = None
    faults: Optional[Sequence[Optional[FaultSchedule]]] = None

    def __post_init__(self):
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")
        if self.faults is not None and len(self.faults) != self.batch:
            raise ValueError(
                f"faults has {len(self.faults)} entries for batch "
                f"{self.batch}: one schedule (or None) per config")

    @property
    def has_faults(self) -> bool:
        return self.faults is not None and any(
            f is not None for f in self.faults)

    @staticmethod
    def stack_op(op_fns: Sequence[Callable]) -> Callable:
        """B single-run op_fns as one batched op_fn: cell b's delta is
        ``op_fns[b]`` of cell b's states."""

        def op_fn(x, t):
            return T.stack([fn(T.tree_map(lambda a: a[b], x), t)
                            for b, fn in enumerate(op_fns)])

        return op_fn

    def stacked_views(self, topo: Topology, total_rounds: int,
                      device="cpu") -> Optional[FaultViews]:
        """The per-cell schedules as time-major stacked masks
        ``recv_ok``/``send_ok`` [T, B, N, P] and ``up`` [T, B, N] on
        ``device`` (None without faults)."""
        if not self.has_faults:
            return None
        return stacked_views(self.faults, topo, total_rounds, device)


def simulate_sweep(
    algo: str,
    lattice: Lattice,
    topo: Topology,
    spec: SweepSpec,
    active_rounds: int,
    quiet_rounds: int = 0,
    loo: str = "prefix",
    engine: str = "reference",
    wide_metrics: bool = True,
    track_convergence: Optional[bool] = None,
    shard: bool = False,
    digest: Optional[DigestSpec] = None,
    telemetry: Optional[tel.TelemetrySpec] = None,
    provenance: Optional[prv.ProvenanceSpec] = None,
    device="cuda",
) -> SimResult:
    """Run ``spec.batch`` configurations of ``algo`` over the shared
    ``topo``/``lattice`` as one batched run on ``device`` (the card by
    default; ``"cpu"`` runs on the CPU).

    Returns [B, T] metrics and [B, N, ...U] final states; ``res.cell(b)``
    is bit-identical to the single ``simulate`` run of cell b's op stream,
    initial state and fault schedule, on any ``engine``.
    ``track_convergence`` defaults on exactly when a cell has a fault
    schedule.

    ``telemetry`` and ``provenance`` attach the observability results as
    ``simulate`` does, batched ([B, T, N] channels, [B, N, E] matrices):
    ``res.telemetry.cell(b)`` and ``res.provenance.cell(b)`` are cell b's
    single run's.

    ``shard=True`` (the config axis over several devices) waits for
    ROADMAP A4's ``torch.distributed`` mesh and raises
    ``NotImplementedError``.
    """
    if shard:
        raise NotImplementedError(
            "simulate_sweep(shard=True): the config axis over several "
            "devices waits for torch.distributed (ROADMAP A4, launch/mesh)")
    check_obs(telemetry, provenance)
    dev = resolve_device(device)
    alg = SyncAlgorithm(
        name=algo, lattice=lattice, topo=topo.on(dev), loo=loo,
        engine=engine,
        metric_dtype=torch.int64 if wide_metrics else torch.int32,
        digest=digest, batch=spec.batch)
    total = active_rounds + quiet_rounds
    views = spec.stacked_views(topo, total, dev)
    if track_convergence is None:
        track_convergence = views is not None
    carry, ys = run_rounds(
        alg, wrap_carry(alg, alg.init(spec.x0), telemetry, provenance),
        spec.op_fn, active_rounds, views, track_convergence, 0, total,
        telemetry=telemetry, provenance=provenance)
    return collect_result(carry, ys, batched=True, telemetry=telemetry,
                          provenance=provenance, nbrs=topo.nbrs)
