"""Sync algorithms, engines, topologies, fault schedules, digests, Table I
workloads and the round simulator (PyTorch)."""

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

__all__ = ["ALGORITHMS", "AlgoCarry", "DigestSpec", "ENGINES",
           "FaultSchedule", "KERNEL_ENGINES", "RESYNC_ALGORITHMS",
           "RoundMetrics", "SimResult", "SyncAlgorithm", "cluster_uniform",
           "converged", "first_stable_round", "simulate", "topology",
           "workloads"]
