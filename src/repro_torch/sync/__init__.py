"""Sync algorithms, engines, topologies, fault schedules, digests,
workloads, the round simulator, sweeps and the keyed object store
(PyTorch)."""

from repro_torch.sync import topology, workloads
from repro_torch.sync.algorithms import (ALGORITHMS, RESYNC_ALGORITHMS,
                                         AlgoCarry, RoundMetrics,
                                         SyncAlgorithm)
from repro_torch.sync.digest import DigestSpec
from repro_torch.sync.engine import ENGINES, KERNEL_ENGINES
from repro_torch.sync.faults import FaultSchedule
from repro_torch.sync.simulator import (SimResult, cluster_uniform,
                                        converged, first_stable_round,
                                        simulate)
from repro_torch.sync.store import (StoreResult, StoreSpec, resume_store,
                                    simulate_store)
from repro_torch.sync.sweep import SweepSpec, simulate_sweep

__all__ = ["ALGORITHMS", "AlgoCarry", "DigestSpec", "ENGINES",
           "FaultSchedule", "KERNEL_ENGINES", "RESYNC_ALGORITHMS",
           "RoundMetrics", "SimResult", "StoreResult", "StoreSpec",
           "SweepSpec", "SyncAlgorithm", "cluster_uniform", "converged",
           "first_stable_round", "resume_store", "simulate",
           "simulate_store", "simulate_sweep", "topology", "workloads"]
