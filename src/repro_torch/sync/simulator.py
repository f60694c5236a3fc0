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

Observability (``repro_torch.obs``): ``telemetry=TelemetrySpec()`` adds
per-round, per-node channels (redundancy, staleness, buffer occupancy,
divergence gap) and ``provenance=ProvenanceSpec()`` the per-element
lineage record; both ride the round loop as carries of their own, wrapped
around the algorithm's carry in the JAX package's order — telemetry inner,
provenance outermost: ``(prov, (tele, carry))``. Their channels reach the
host with the metrics. With both None the loop queues nothing extra.

The same round loop (:func:`run_rounds`) drives ``simulate``, the sweep
engine (``sync/sweep.py``: a leading [B] config axis) and the keyed store
(``sync/store.py``: B objects). It runs in chunks of rounds: the metrics of
a chunk go to the host at its end, so device memory holds the carry and one
chunk's metrics whatever the number of rounds — the counterpart of the JAX
package's ``run_scan_chunked``. ``simulate`` runs one chunk.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.lattice import Lattice
from repro_torch.obs import provenance as prv
from repro_torch.obs import telemetry as tel
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
    telemetry: object = None       # obs.TelemetryResult with telemetry=
    provenance: object = None      # obs.ProvenanceResult with provenance=

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
            uniform=None if self.uniform is None else self.uniform[b],
            telemetry=None if self.telemetry is None
            else self.telemetry.cell(b),
            provenance=None if self.provenance is None
            else self.provenance.cell(b))

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


def check_obs(telemetry, provenance) -> None:
    """Refuse an observability argument of the wrong type up front."""
    if telemetry is not None and not isinstance(telemetry,
                                                tel.TelemetrySpec):
        raise TypeError(f"telemetry must be an obs.TelemetrySpec or None, "
                        f"got {type(telemetry).__name__}")
    if provenance is not None and not isinstance(provenance,
                                                 prv.ProvenanceSpec):
        raise TypeError(f"provenance must be an obs.ProvenanceSpec or None, "
                        f"got {type(provenance).__name__}")


def wrap_carry(alg: SyncAlgorithm, carry: AlgoCarry, telemetry=None,
               provenance=None):
    """The run's first carry: the algorithm's, wrapped in fresh carries of
    the observability it asks for."""
    return rewrap(carry, None if telemetry is None else tel.init_carry(alg),
                  None if provenance is None
                  else prv.init_carry(provenance, alg, carry.x))


def rewrap(carry: AlgoCarry, tele=None, prov=None):
    """``carry`` wrapped in the observability carries that are not None:
    telemetry inner, provenance outermost, ``(prov, (tele, carry))``."""
    if tele is not None:
        carry = (tele, carry)
    return carry if prov is None else (prov, carry)


def unwrap_carry(carry, telemetry=None, provenance=None):
    """``(algorithm carry, telemetry carry, provenance carry)`` of a
    wrapped carry (None for what was not asked for)."""
    prov = tele = None
    if provenance is not None:
        prov, carry = carry
    if telemetry is not None:
        tele, carry = carry
    return carry, tele, prov


class Chunk(NamedTuple):
    """Rounds [t0, t1)'s results on the host, time-major: ``metrics`` four
    arrays [t, ...] (tx, mem, cpu, max_mem_node; a trailing [B] batched),
    ``uniform`` [t, ...] or None, ``tele`` the six telemetry channels and
    ``prov`` the three provenance channels [t, ..., N] (None when not
    asked for)."""

    metrics: tuple
    uniform: Optional[np.ndarray]
    tele: Optional[tuple] = None
    prov: Optional[tuple] = None


class RoundLoop:
    """One run's round loop from ``carry`` (wrapped by :func:`wrap_carry`
    when ``telemetry``/``provenance`` are asked for): :meth:`step` queues
    round t — ``op_fn(x, t)`` while t < active_rounds (⊥ after; a down node
    executes no ops), then one ``alg.round_step`` under round t's fault
    masks, then the observability updates — and keeps its metrics on the
    device; :meth:`finish` moves the rounds stepped so far to the host.
    ``reduce(metrics, uniform, channels)`` may fold each round's per-config
    metrics (and telemetry channels) before they are kept (the store's
    in-loop object reduction).

    A sharded sweep or store steps one loop per block, each on its own
    device, round by round (:func:`run_blocks`)."""

    def __init__(self, alg: SyncAlgorithm, carry, op_fn: Callable,
                 active_rounds: int, views, track_convergence: bool,
                 reduce: Optional[Callable] = None, telemetry=None,
                 provenance=None):
        self.alg, self.op_fn, self.active_rounds = alg, op_fn, active_rounds
        self.views, self.track_convergence = views, track_convergence
        self.reduce, self.telemetry, self.provenance = \
            reduce, telemetry, provenance
        self.carry, self.tele, self.prov = unwrap_carry(carry, telemetry,
                                                        provenance)
        self.want_recv = telemetry is not None and telemetry.redundancy
        self._reset()

    def _reset(self):
        self.metrics: List = []
        self.uniform: List = []
        self.tchans: List = []
        self.pchans: List = []

    def step(self, t: int) -> None:
        alg, x_before = self.alg, self.carry.x
        rf = None if self.views is None else self.views.at_round(t)
        if t < self.active_rounds:
            delta = T.cast_like(self.op_fn(x_before, t), x_before)
            if rf is not None:                  # a down node executes no ops
                delta = T.where_bot(rf.up, delta)
        else:
            delta = T.zeros_like(x_before)
        out = alg.round_step(self.carry, delta, rf, self.want_recv,
                             self.provenance is not None)
        # drop the old carry (buffers and all) before the round's other
        # passes allocate
        self.carry, m = out[:2]
        carry = self.carry
        uni = cluster_uniform(alg.lattice, carry.x, alg.batched) \
            if self.track_convergence else None
        ch = None
        if self.telemetry is not None:
            self.tele, ch = tel.round_channels(
                self.telemetry, alg, self.tele, x_before, carry,
                out[2] if self.want_recv else None, rf)
        if self.provenance is not None:
            self.prov, pch = prv.round_update(self.provenance, alg,
                                              self.prov, x_before, delta,
                                              out[-1], t)
            self.pchans.append(pch)
        del out
        if self.reduce is not None:
            m, uni, ch = self.reduce(m, uni, ch)
        self.metrics.append(m)
        if self.track_convergence:
            self.uniform.append(uni)
        if ch is not None:
            self.tchans.append(ch)

    def finish(self):
        """``(wrapped carry, Chunk)``: the carry after the rounds stepped so
        far and their metrics and channels on the host, in one transfer
        each; the loop goes on from there."""
        alg = self.alg
        lead = () if not alg.batched else (1,) if self.reduce is not None \
            else (alg.batch,)
        ys = to_host(self.metrics, self.uniform, self.track_convergence,
                     lead, alg.metric_dtype)
        node = lead + (alg.topo.num_nodes,)
        if self.telemetry is not None:
            tdt = torch.int32 if self.reduce is None else alg.metric_dtype
            ys = ys._replace(tele=stack_host(self.tchans, 6, node, tdt))
        if self.provenance is not None:
            ys = ys._replace(prov=stack_host(self.pchans, 3, node,
                                             torch.int32))
        self._reset()
        return rewrap(self.carry, self.tele, self.prov), ys


def run_rounds(alg: SyncAlgorithm, carry, op_fn: Callable,
               active_rounds: int, views, track_convergence: bool,
               start: int, stop: int, reduce: Optional[Callable] = None,
               telemetry=None, provenance=None):
    """Rounds [start, stop) of a run from ``carry`` (see
    :class:`RoundLoop`). Returns ``(carry, Chunk)``: the metrics and
    channels reach the host once, at the end."""
    loop = RoundLoop(alg, carry, op_fn, active_rounds, views,
                     track_convergence, reduce, telemetry, provenance)
    del carry                   # the loop holds the only reference
    for t in range(start, stop):
        loop.step(t)
    return loop.finish()


def run_blocks(loops: Sequence[RoundLoop], start: int, stop: int) -> list:
    """Rounds [start, stop) of several blocks' loops, issued round by round
    (every block's round t before any block's round t + 1) with no host
    read in between, so blocks on different devices overlap. Returns each
    block's ``(carry, Chunk)``."""
    for t in range(start, stop):
        for loop in loops:
            loop.step(t)
    return [loop.finish() for loop in loops]


def stack_host(rounds, k: int, shape: tuple, dtype) -> tuple:
    """A list of rounds' k-tuples of device tensors as k host arrays
    [t, *shape], in one transfer; ``shape`` and ``dtype`` shape an empty
    list's arrays."""
    if rounds:
        return tuple(torch.stack([torch.stack(tuple(r)) for r in rounds],
                                 1).cpu().numpy())
    return tuple(np.zeros((0,) + tuple(shape),
                          torch.empty((), dtype=dtype).numpy().dtype)
                 for _ in range(k))


def to_host(metrics, uniform, track_convergence: bool, lead: tuple = (),
            dtype=torch.int64) -> Chunk:
    """A list of rounds' device metrics (and ``uniform`` flags) as one
    host Chunk, in one transfer each; ``lead`` and ``dtype`` shape an
    empty list's arrays."""
    host = stack_host(metrics, 4, lead, dtype)
    uni = torch.stack(uniform).cpu().numpy() if uniform else (
        np.zeros(host[0].shape, bool) if track_convergence else None)
    return Chunk(metrics=host, uniform=uni)


def cat_chunks(chunks) -> Chunk:
    """Chunks of consecutive rounds as one (time-major)."""

    def cat(arrays):
        return None if arrays[0] is None else tuple(
            np.concatenate([a[i] for a in arrays])
            for i in range(len(arrays[0])))

    uni = None if chunks[0].uniform is None \
        else np.concatenate([c.uniform for c in chunks])
    return Chunk(cat([c.metrics for c in chunks]), uni,
                 cat([c.tele for c in chunks]), cat([c.prov for c in chunks]))


def cat_results(parts: Sequence[SimResult], device) -> SimResult:
    """Batched results of consecutive blocks of a batch axis as one result
    over the whole axis: host arrays concatenated, final states and
    provenance matrices gathered on ``device``."""
    if len(parts) == 1:
        return parts[0]
    first = parts[0]

    def host(get):
        return np.concatenate([get(p) for p in parts])

    def gather(tensors):
        return torch.cat([t.to(device) for t in tensors])

    return SimResult(
        tx=host(lambda p: p.tx), mem=host(lambda p: p.mem),
        cpu=host(lambda p: p.cpu),
        max_mem_node=host(lambda p: p.max_mem_node),
        final_x=T.tree_map(lambda *a: gather(a), first.final_x,
                           *(p.final_x for p in parts[1:])),
        uniform=None if first.uniform is None
        else host(lambda p: p.uniform),
        telemetry=None if first.telemetry is None
        else tel.TelemetryResult.cat([p.telemetry for p in parts]),
        provenance=None if first.provenance is None
        else prv.ProvenanceResult.cat([p.provenance for p in parts],
                                      device))


def collect_result(carry, metrics, uniform=None,
                   track_convergence: bool = False,
                   batched: bool = False, telemetry=None, provenance=None,
                   nbrs=None) -> SimResult:
    """The results of a whole run — a host :class:`Chunk` (time-major),
    or a list of rounds' device metrics with their ``uniform`` flags — as
    a SimResult ([B, T] when ``batched``), after the overflow check.
    ``carry`` is the run's final (wrapped) carry; ``telemetry`` and
    ``provenance`` (their specs) attach their results from the chunk's
    channels, and ``nbrs`` names provenance's edges."""
    ys = metrics if isinstance(metrics, Chunk) \
        else to_host(metrics, uniform, track_convergence)
    carry, _, prov = unwrap_carry(carry, telemetry, provenance)
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
    return SimResult(
        tx=np.ascontiguousarray(tx), mem=np.ascontiguousarray(mem),
        cpu=np.ascontiguousarray(cpu),
        max_mem_node=np.ascontiguousarray(mmax), final_x=carry.x,
        uniform=None if uni is None else np.ascontiguousarray(uni),
        telemetry=None if telemetry is None
        else tel.collect(telemetry, ys.tele, batched),
        provenance=None if provenance is None
        else prv.collect(provenance, prov, ys.prov, nbrs, batched))


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
    telemetry: Optional[tel.TelemetrySpec] = None,
    provenance: Optional[prv.ProvenanceSpec] = None,
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

    ``telemetry=obs.TelemetrySpec()`` returns ``SimResult.telemetry``, an
    ``obs.TelemetryResult`` of per-round, per-node channels;
    ``provenance=obs.ProvenanceSpec()`` returns ``SimResult.provenance``,
    an ``obs.ProvenanceResult`` (lineage matrices, first deliveries per
    edge, waste by cause; dense and bit-packed states only). Either leaves
    every other field bit-identical to a run without it.
    """
    check_obs(telemetry, provenance)
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
    carry, ys = run_rounds(
        alg, wrap_carry(alg, alg.init(x0), telemetry, provenance), op_fn,
        active_rounds, views, track_convergence, 0, total,
        telemetry=telemetry, provenance=provenance)
    return collect_result(carry, ys, telemetry=telemetry,
                          provenance=provenance, nbrs=topo.nbrs)
