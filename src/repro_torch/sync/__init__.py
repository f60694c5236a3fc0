"""Sync algorithms, engines, topologies, Table I workloads and the round
simulator (PyTorch)."""

from repro_torch.sync import topology, workloads
from repro_torch.sync.algorithms import (ALGORITHMS, AlgoCarry, RoundMetrics,
                                         SyncAlgorithm)
from repro_torch.sync.engine import ENGINES, KERNEL_ENGINES
from repro_torch.sync.simulator import (SimResult, cluster_uniform,
                                        converged, first_stable_round,
                                        simulate)

__all__ = ["ALGORITHMS", "AlgoCarry", "ENGINES", "KERNEL_ENGINES",
           "RoundMetrics", "SimResult", "SyncAlgorithm", "cluster_uniform",
           "converged", "first_stable_round", "simulate", "topology",
           "workloads"]
