"""Sync algorithms, engines, topologies, fault schedules, digests,
workloads, the round simulator, sweeps, the keyed object store and the
Scuttlebutt baseline (PyTorch)."""

from repro_torch.obs.telemetry import TelemetryResult, TelemetrySpec
from repro_torch.sync import (digest, engine, faults, scuttlebutt, topology,
                              workloads)
from repro_torch.sync.algorithms import (ALGORITHMS, RESYNC_ALGORITHMS,
                                         AlgoCarry, RoundMetrics,
                                         SyncAlgorithm)
from repro_torch.sync.digest import DigestSpec
from repro_torch.sync.engine import ENGINES, KERNEL_ENGINES
from repro_torch.sync.faults import FaultSchedule, RoundFaults
from repro_torch.sync.simulator import (SimResult, cluster_uniform,
                                        converged, first_stable_round,
                                        simulate)
from repro_torch.sync.store import (StoreResult, StoreSpec, resume_store,
                                    simulate_store)
from repro_torch.sync.sweep import SweepSpec, simulate_sweep
from repro_torch.sync.topology import (Topology, by_name, full, partial_mesh,
                                       ring, tree)

__all__ = ["ALGORITHMS", "AlgoCarry", "DigestSpec", "ENGINES",
           "FaultSchedule", "KERNEL_ENGINES", "RESYNC_ALGORITHMS",
           "RoundFaults", "RoundMetrics", "SimResult", "StoreResult",
           "StoreSpec", "SweepSpec", "SyncAlgorithm", "TelemetryResult",
           "TelemetrySpec", "Topology", "by_name", "cluster_uniform",
           "converged", "digest", "engine", "faults", "first_stable_round",
           "full", "partial_mesh", "resume_store", "ring", "scuttlebutt",
           "simulate", "simulate_store", "simulate_sweep", "topology",
           "tree", "workloads"]
