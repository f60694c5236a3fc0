"""Synchronous-round network simulator (paper §V micro-benchmark harness),
PyTorch counterpart of ``repro.sync.simulator``.

Each round, every node (i) executes one update via its δ-mutator and (ii)
synchronizes with all neighbors, like the paper's 1 Hz op+sync tick. The
rounds are a Python loop (the JAX package's ``lax.scan``): the round index
is a Python int, the active/quiet gate is a host branch, and nothing in the
loop reads a device value, so the host only queues work. The per-round
metrics stay on the device and reach the host once, in
:func:`collect_result`.

``op_fn(x, t) -> delta`` returns the δ-mutator output of round ``t`` for
the current states ``x`` [N, ...U]; rounds ``t >= active_rounds`` take no
ops (the quiescent drain that lets convergence be asserted).

Faults: an optional ``FaultSchedule`` is folded into per-round device masks
once (``FaultSchedule.views``); round ``t`` reads its slice, down nodes
execute no ops, and every engine honours the masks identically. An all-ok
schedule is bit-identical to none.

Metrics accumulate in int64 (``wide_metrics=True``), or in int32 with a
negative-count overflow check.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.lattice import Lattice
from repro_torch.sync import treeops as T
from repro_torch.sync.algorithms import AlgoCarry, SyncAlgorithm
from repro_torch.sync.digest import DigestSpec
from repro_torch.sync.faults import FaultSchedule
from repro_torch.sync.topology import Topology


class SimResult(NamedTuple):
    tx: np.ndarray                 # [T] elements sent per round
    mem: np.ndarray                # [T] elements held (cluster total)
    cpu: np.ndarray                # [T] element-ops per round
    max_mem_node: np.ndarray       # [T] worst single-node memory
    final_x: object                # [N, ...U] final states (a tensor, or a
                                   # tuple for tuple states), on the sim device
    uniform: Optional[np.ndarray]  # [T] bool all nodes identical at round
                                   # end (None when tracking was off)

    @property
    def total_tx(self) -> int:
        return int(self.tx.sum())

    @property
    def total_cpu(self) -> int:
        return int(self.cpu.sum())

    @property
    def avg_mem(self) -> float:
        return float(self.mem.mean())

    def convergence_round(self) -> int:
        """First round t such that every round ≥ t ended with all nodes
        holding identical states (−1 if never)."""
        if self.uniform is None:
            raise ValueError("per-round convergence was not tracked; pass "
                             "simulate(track_convergence=True)")
        return first_stable_round(self.uniform)


def first_stable_round(uniform):
    """First round t such that every round ≥ t has ``uniform`` true (−1 if
    never), over the trailing (time) axis."""
    uni = np.asarray(uniform, bool)
    stay = np.flip(np.logical_and.accumulate(np.flip(uni, -1), -1), -1)
    out = np.where(uni[..., -1], stay.argmax(-1), -1)
    return int(out) if out.ndim == 0 else out


def cluster_uniform(lattice: Lattice, x) -> torch.Tensor:
    """All nodes hold the same state: ⊑ both ways against node 0. A 0-d
    bool tensor (no host read)."""
    xb = T.tree_map(lambda a: a[:1].expand_as(a), x)
    return torch.all(lattice.leq(x, xb) & lattice.leq(xb, x))


def converged(lattice: Lattice, final_x) -> bool:
    """All nodes hold the same state (pairwise ⊑ both ways vs node 0)."""
    return bool(cluster_uniform(lattice, final_x))


def resolve_device(device) -> torch.device:
    """The device a run asked for. A CUDA device without a card raises:
    the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def collect_result(carry: AlgoCarry, metrics, uniform,
                   track_convergence: bool) -> SimResult:
    """Device → host, once: stack the per-round metrics, run the overflow
    check, and assemble the SimResult."""
    if metrics:
        stacked = torch.stack([torch.stack(m) for m in metrics], 1).cpu()
        tx, mem, cpu, mmax = (a.numpy() for a in stacked)
    else:
        tx = mem = cpu = mmax = np.zeros((0,), np.int64)
    # Wrap-around in the metric accumulators shows up as negative counts —
    # impossible for element tallies, so fail loudly instead of reporting
    # garbage (int32 accumulators only, at extreme scale).
    if (tx < 0).any() or (mem < 0).any() or (cpu < 0).any():
        raise OverflowError(
            "round-metric accumulator overflow: rerun with wide_metrics=True")
    uni = torch.stack(uniform).cpu().numpy() \
        if track_convergence and uniform else None
    if track_convergence and uni is None:
        uni = np.zeros((0,), bool)
    return SimResult(tx=tx, mem=mem, cpu=cpu, max_mem_node=mmax,
                     final_x=carry.x, uniform=uni)


def simulate(
    algo: str,
    lattice: Lattice,
    topo: Topology,
    op_fn: Callable,
    active_rounds: int,
    quiet_rounds: int = 0,
    x0=None,
    loo: str = "prefix",
    engine: str = "reference",
    wide_metrics: bool = True,
    faults: Optional[FaultSchedule] = None,
    track_convergence: Optional[bool] = None,
    digest: Optional[DigestSpec] = None,
    device="cuda",
) -> SimResult:
    """Run ``active_rounds`` op+sync rounds plus ``quiet_rounds`` sync-only
    drain rounds of ``algo`` over ``topo``, on ``device`` (the card by
    default; pass ``"cpu"`` to run on the CPU).

    ``engine``: ``"reference"`` (the torch per-slot loop), ``"fused"``
    (``round_recv`` + ``buffer_fold`` kernels) or ``"mega"`` (one
    ``round_step`` launch per round); all three are bit-identical, and the
    kernel engines fall back to the reference for lattices without a dense
    kernel kind.

    ``faults`` injects message loss / partitions / node churn (rounds past
    the schedule run fault-free). ``track_convergence`` records per-round
    cluster agreement (``SimResult.uniform`` / ``convergence_round()``);
    the default None turns it on exactly when a fault schedule is given.
    ``digest`` sets the block geometry of ``digest_driven`` (ignored by
    the other algorithms).
    """
    dev = resolve_device(device)
    if faults is not None and not faults.same_topology(topo):
        raise ValueError(
            f"FaultSchedule was built for topology {faults.topo.name!r}, "
            f"not {topo.name!r}: its edge masks would land on the wrong slots")
    if track_convergence is None:
        track_convergence = faults is not None
    alg = SyncAlgorithm(
        name=algo, lattice=lattice, topo=topo.on(dev), loo=loo,
        engine=engine,
        metric_dtype=torch.int64 if wide_metrics else torch.int32,
        digest=digest)
    carry = alg.init(x0)
    total = active_rounds + quiet_rounds
    views = None if faults is None else faults.views(total, dev)
    metrics, uniform = [], []
    for t in range(total):
        rf = None if views is None else views.at_round(t)
        if t < active_rounds:
            delta = T.cast_like(op_fn(carry.x, t), carry.x)
            if rf is not None:                  # a down node executes no ops
                delta = T.where_bot(rf.up, delta)
        else:
            delta = T.zeros_like(carry.x)
        carry, m = alg.round_step(carry, delta, rf)
        metrics.append(m)
        if track_convergence:
            uniform.append(cluster_uniform(lattice, carry.x))
    return collect_result(carry, metrics, uniform, track_convergence)
