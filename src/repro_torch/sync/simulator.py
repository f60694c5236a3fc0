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

The same round loop (:func:`run_rounds`) drives ``simulate``, the sweep
engine (``sync/sweep.py``: a leading [B] config axis) and the keyed store
(``sync/store.py``: B objects). It runs in chunks of rounds: the metrics of
a chunk go to the host at its end, so device memory holds the carry and one
chunk's metrics whatever the number of rounds — the counterpart of the JAX
package's ``run_scan_chunked``. ``simulate`` runs one chunk.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.lattice import Lattice
from repro_torch.sync import treeops as T
from repro_torch.sync.algorithms import AlgoCarry, SyncAlgorithm
from repro_torch.sync.digest import DigestSpec
from repro_torch.sync.faults import FaultSchedule
from repro_torch.sync.topology import Topology


class SimResult(NamedTuple):
    tx: np.ndarray                 # [T] elements sent per round ([B, T]
                                   # for a batch)
    mem: np.ndarray                # [T] elements held (cluster total)
    cpu: np.ndarray                # [T] element-ops per round
    max_mem_node: np.ndarray       # [T] worst single-node memory
    final_x: object                # [(B,) N, ...U] final states (a tensor,
                                   # or a tuple for tuple states), on the
                                   # sim device
    uniform: Optional[np.ndarray]  # [(B,) T] bool all nodes identical at
                                   # round end (None when tracking was off)

    @property
    def batch(self) -> Optional[int]:
        """The config axis B of a sweep's or store's result, None for a
        single run."""
        return int(self.tx.shape[0]) if self.tx.ndim == 2 else None

    @property
    def total_tx(self) -> int:
        return int(self.tx.sum())

    @property
    def total_cpu(self) -> int:
        return int(self.cpu.sum())

    @property
    def avg_mem(self) -> float:
        return float(self.mem.mean())

    def cell(self, b: int) -> "SimResult":
        """Config ``b`` of a batched result as a single run's result — the
        view a sweep cell's bit-identity with its single run is stated
        over."""
        if self.batch is None:
            raise ValueError("not a sweep result (no config axis)")
        return SimResult(
            tx=self.tx[b], mem=self.mem[b], cpu=self.cpu[b],
            max_mem_node=self.max_mem_node[b],
            final_x=T.tree_map(lambda a: a[b], self.final_x),
            uniform=None if self.uniform is None else self.uniform[b])

    def convergence_round(self):
        """First round t such that every round ≥ t ended with all nodes
        holding identical states (−1 if never); an int array [B] for a
        batched result."""
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


def cluster_uniform(lattice: Lattice, x, batched: bool = False):
    """All nodes hold the same state: ⊑ both ways against node 0. A 0-d
    bool tensor, or [B] with ``batched`` (no host read)."""
    idx = (slice(None), slice(0, 1)) if batched else (slice(0, 1),)
    xb = T.tree_map(lambda a: a[idx].expand_as(a), x)
    return torch.all(lattice.leq(x, xb) & lattice.leq(xb, x), dim=-1)


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


class Chunk(NamedTuple):
    """Rounds [t0, t1)'s metrics on the host, time-major: ``metrics`` four
    arrays [t, ...] (tx, mem, cpu, max_mem_node; a trailing [B] batched),
    ``uniform`` [t, ...] or None."""

    metrics: tuple
    uniform: Optional[np.ndarray]


def run_rounds(alg: SyncAlgorithm, carry: AlgoCarry, op_fn: Callable,
               active_rounds: int, views, track_convergence: bool,
               start: int, stop: int, reduce: Optional[Callable] = None):
    """Rounds [start, stop) of a run from ``carry``: round t applies
    ``op_fn(x, t)`` while t < active_rounds (⊥ after; a down node executes
    no ops), then one ``alg.round_step`` under round t's fault masks.
    ``reduce(metrics, uniform)`` may fold each round's per-config metrics
    before they are kept (the store's in-loop object reduction). Returns
    ``(carry, Chunk)``: the metrics reach the host once, at the end."""
    lattice = alg.lattice
    metrics: List = []
    uniform: List = []
    for t in range(start, stop):
        rf = None if views is None else views.at_round(t)
        if t < active_rounds:
            delta = T.cast_like(op_fn(carry.x, t), carry.x)
            if rf is not None:                  # a down node executes no ops
                delta = T.where_bot(rf.up, delta)
        else:
            delta = T.zeros_like(carry.x)
        carry, m = alg.round_step(carry, delta, rf)
        uni = cluster_uniform(lattice, carry.x, alg.batched) \
            if track_convergence else None
        if reduce is not None:
            m, uni = reduce(m, uni)
        metrics.append(m)
        if track_convergence:
            uniform.append(uni)
    lead = () if not alg.batched or reduce is not None else (alg.batch,)
    return carry, to_host(metrics, uniform, track_convergence, lead,
                          alg.metric_dtype)


def to_host(metrics, uniform, track_convergence: bool, lead: tuple = (),
            dtype=torch.int64) -> Chunk:
    """A list of rounds' device metrics (and ``uniform`` flags) as one
    host Chunk, in one transfer each; ``lead`` and ``dtype`` shape an
    empty list's arrays."""
    if metrics:
        host = torch.stack([torch.stack(tuple(m)) for m in metrics],
                           1).cpu().numpy()                # [4, t, ...]
    else:
        host = np.zeros((4, 0) + tuple(lead),
                        torch.empty((), dtype=dtype).numpy().dtype)
    uni = torch.stack(uniform).cpu().numpy() if uniform else (
        np.zeros(host.shape[1:], bool) if track_convergence else None)
    return Chunk(metrics=tuple(host), uniform=uni)


def cat_chunks(chunks) -> Chunk:
    """Chunks of consecutive rounds as one (time-major)."""
    metrics = tuple(np.concatenate([c.metrics[i] for c in chunks])
                    for i in range(4))
    uni = None if chunks[0].uniform is None \
        else np.concatenate([c.uniform for c in chunks])
    return Chunk(metrics, uni)


def collect_result(carry: AlgoCarry, metrics, uniform=None,
                   track_convergence: bool = False,
                   batched: bool = False) -> SimResult:
    """The metrics of a whole run — a host :class:`Chunk` (time-major), or
    a list of rounds' device metrics with their ``uniform`` flags — as a
    SimResult ([B, T] when ``batched``), after the overflow check."""
    ys = metrics if isinstance(metrics, Chunk) \
        else to_host(metrics, uniform, track_convergence)
    tx, mem, cpu, mmax = (a.T if batched else a for a in ys.metrics)
    # Wrap-around in the metric accumulators shows up as negative counts —
    # impossible for element tallies, so fail loudly instead of reporting
    # garbage (int32 accumulators only, at extreme scale).
    if (tx < 0).any() or (mem < 0).any() or (cpu < 0).any():
        raise OverflowError(
            "round-metric accumulator overflow: rerun with wide_metrics=True")
    uni = ys.uniform
    if uni is not None and batched:
        uni = uni.T
    return SimResult(tx=np.ascontiguousarray(tx), mem=np.ascontiguousarray(mem),
                     cpu=np.ascontiguousarray(cpu),
                     max_mem_node=np.ascontiguousarray(mmax),
                     final_x=carry.x,
                     uniform=None if uni is None else np.ascontiguousarray(uni))


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
    total = active_rounds + quiet_rounds
    views = None if faults is None else faults.views(total, dev)
    carry, ys = run_rounds(alg, alg.init(x0), op_fn, active_rounds, views,
                           track_convergence, 0, total)
    return collect_result(carry, ys)
