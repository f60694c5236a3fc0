"""Keyed object store: B independent CRDT objects as one batched run,
PyTorch counterpart of ``repro.sync.store``.

The paper's flagship macro-benchmark (§V-D, Retwis, Figs 11–12) is a
*store*: many independent CRDT objects — follower sets, walls, timelines —
each synchronised per object under Zipf contention. Every object is its own
small simulation (its own δ-buffers, inflation checks and digests), but all
share one lattice shape, one algorithm and one cluster topology: the shape
the sweep engine's config axis batches, here with **B = objects**:

* states stack to [B, N, ...U], slot-major buffers to [K, B, N, ...U]; each
  round is the single run's round over B disjoint copies of the network,
  so **every object is bit-identical (states and all metrics) to its own
  ``simulate`` run** on every engine;
* the *network* is shared: one optional ``FaultSchedule`` hits every object
  alike (a partition partitions the whole store), as [T, 1, N, P] masks
  that broadcast over the objects;
* metrics come back per object ([B, T]) with store-level aggregates and
  weighted accounting: per-object byte weights (Retwis's 20 B user ids,
  301 B wall entries, 39 B timeline entries) turn element counts into
  bytes (``StoreResult.*_bytes``, float64 from the same integers);
* ``layout`` is the JAX package's kernel tiling of the object axis ("rows",
  the default, or "grid"). It is checked and otherwise ignored: the port's
  kernels take the (object, node) rows as one row axis, which is "rows".

Scale knobs, all bit-identical to the plain run:

* ``chunk_rounds=k`` runs the rounds in chunks of k; each chunk's metrics
  go to the host at its end, so device memory is the carry plus one chunk;
* ``object_metrics=False`` reduces the per-object metrics inside the round
  loop (masked sums and maxes, exact on integers): O(T) metrics, not
  O(B·T); the ``store_*`` aggregates stay exact, per-object views raise;
* ``checkpoint=`` (with ``chunk_rounds``) saves the carry and the metrics so
  far at every chunk boundary, and :func:`resume_store` continues from one
  bit-identically, after checking the bundle was written by the same run
  (a fingerprint of its configuration).

Observability: ``telemetry=`` gives per-object [B, T, N] channels (with
``object_metrics=False``, one [1, T, N] partial reduced in the loop: sums
for recv/novel/buf, maxes for stale/ack/gap, in the metric dtype);
``provenance=`` the per-object lineage (it needs ``object_metrics=True``);
both carries and their channels ride the checkpoints, and a resume under
another observability configuration is refused. ``trace=`` takes an
``obs.TraceLog`` and records the run as a ``store_scan`` span, with a
``chunk_boundary`` instant at every chunk end of a chunked run and a
``checkpoint_save`` span around every save.

``shard=True`` (the object axis over several devices) and ``pad_to`` (its
pad multiple) wait for ROADMAP A4's ``torch.distributed`` mesh and raise
``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.lattice import BatchWeights, Lattice, tree_leaves
from repro_torch.obs import provenance as prv
from repro_torch.obs import telemetry as tel
from repro_torch.sync import treeops as T
from repro_torch.sync.algorithms import RoundMetrics, SyncAlgorithm
from repro_torch.sync.digest import DigestSpec
from repro_torch.sync.faults import FaultSchedule, FaultViews, shared_views
from repro_torch.sync.simulator import (Chunk, SimResult, cat_chunks,
                                        check_obs, collect_result,
                                        first_stable_round, resolve_device,
                                        run_rounds, wrap_carry)
from repro_torch.sync.topology import Topology


@dataclasses.dataclass(frozen=True)
class StoreSpec:
    """The ingredients of one store run.

    ``op_fn(x, t) -> deltas`` sees the stacked states [B, N, ...U] (the
    object axis leads) and returns stacked deltas; per-object op streams
    live in the object axis (``workloads.versioned_slot_op``).

    ``weights``: optional per-object element byte weights [B].

    ``x0``: optional stacked initial states [B, N, ...U] (None = all-⊥);
    the leading axis of every leaf is checked here, the full shape by
    ``simulate_store`` before anything runs.

    ``faults``: one optional schedule for the whole store.
    """

    objects: int
    op_fn: Callable
    weights: Optional[np.ndarray] = None
    x0: object = None
    faults: Optional[FaultSchedule] = None

    def __post_init__(self):
        if self.objects < 1:
            raise ValueError(f"objects must be >= 1, got {self.objects}")
        if self.weights is not None:
            w = np.asarray(self.weights, np.float64)
            if w.shape != (self.objects,):
                raise ValueError(
                    f"weights must be [objects]=[{self.objects}], got shape "
                    f"{w.shape}")
            object.__setattr__(self, "weights", w)
        if self.x0 is not None:
            for leaf in tree_leaves(self.x0):
                shape = tuple(np.shape(leaf))
                if len(shape) < 1 or shape[0] != self.objects:
                    raise ValueError(
                        f"StoreSpec.x0 must stack objects on the leading "
                        f"axis of every leaf: expected leading extent "
                        f"objects={self.objects}, got leaf shape {shape}; "
                        f"build x0 as [objects, nodes, ...universe]")

    def shared_views(self, topo: Topology, total_rounds: int,
                     device="cpu") -> Optional[FaultViews]:
        """The store-wide schedule as [T, 1, N, P] / [T, 1, N] masks on
        ``device`` (None without faults)."""
        if self.faults is None:
            return None
        if not self.faults.same_topology(topo):
            raise ValueError(
                f"StoreSpec.faults was built for topology "
                f"{self.faults.topo.name!r}, not {topo.name!r}")
        return shared_views(self.faults, total_rounds, device)


class StoreResult(NamedTuple):
    """Per-object metrics plus store-level (optionally byte-weighted)
    aggregates. ``sim`` is the batched result: [B, T] metrics, [B, N, ...U]
    final states. With ``object_metrics=False`` the run reduced the object
    axis in the loop: ``sim`` holds [1, T] sums (maxes for
    ``max_mem_node``), the ``store_*`` aggregates are exact and the
    per-object views raise."""

    sim: SimResult
    weights: Optional[np.ndarray] = None            # [B] bytes per element
    final_state_bytes: Optional[np.ndarray] = None  # [B, N] weighted elems
    object_metrics: bool = True
    num_objects: Optional[int] = None

    def _per_object(self, what: str):
        if not self.object_metrics:
            raise ValueError(
                f"{what} is a per-object view, but this run reduced the "
                f"object axis in the loop (object_metrics=False): only the "
                f"store_* aggregates and final states are available; rerun "
                f"with object_metrics=True for per-object metrics")

    @property
    def objects(self) -> int:
        return self.num_objects if self.num_objects is not None \
            else self.sim.batch

    @property
    def tx(self) -> np.ndarray:          # [B, T]
        self._per_object("tx")
        return self.sim.tx

    @property
    def mem(self) -> np.ndarray:
        self._per_object("mem")
        return self.sim.mem

    @property
    def cpu(self) -> np.ndarray:
        self._per_object("cpu")
        return self.sim.cpu

    @property
    def max_mem_node(self) -> np.ndarray:
        self._per_object("max_mem_node")
        return self.sim.max_mem_node

    @property
    def uniform(self):
        self._per_object("uniform")
        return self.sim.uniform

    @property
    def final_x(self):
        return self.sim.final_x

    @property
    def telemetry(self):
        """The run's ``obs.TelemetryResult`` (None unless asked for):
        [B, T, N] per-object channels, or with ``object_metrics=False`` one
        [1, T, N] partial (sums for recv/novel/buf, maxes for
        stale/ack/gap)."""
        return self.sim.telemetry

    @property
    def provenance(self):
        """The run's ``obs.ProvenanceResult`` (None unless asked for),
        per object."""
        return self.sim.provenance

    def object_result(self, b: int) -> SimResult:
        """Object b as a single run's result."""
        self._per_object("object_result")
        return self.sim.cell(b)

    def convergence_round(self):
        """Per-object first round after which all nodes stayed identical
        ([B] int, −1 = never; needs ``track_convergence``)."""
        self._per_object("convergence_round")
        return self.sim.convergence_round()

    # -- store-level aggregates (both metric modes) --------------------------

    @property
    def store_tx(self) -> np.ndarray:    # [T] elements, all objects
        return self.sim.tx.sum(axis=0)

    @property
    def store_mem(self) -> np.ndarray:
        return self.sim.mem.sum(axis=0)

    @property
    def store_cpu(self) -> np.ndarray:
        return self.sim.cpu.sum(axis=0)

    @property
    def store_max_mem_node(self) -> np.ndarray:  # [T] worst node anywhere
        return self.sim.max_mem_node.max(axis=0)

    @property
    def total_cpu(self) -> int:
        return int(self.sim.cpu.sum())

    @property
    def store_uniform(self) -> Optional[np.ndarray]:
        """[T] bool: every object's cluster agreed at round end (None when
        convergence was not tracked)."""
        if self.sim.uniform is None:
            return None
        return np.all(np.asarray(self.sim.uniform, bool), axis=0)

    def store_convergence_round(self) -> int:
        """First round after which EVERY object's cluster stayed identical
        (−1 = never; needs ``track_convergence``)."""
        if self.sim.uniform is None:
            raise ValueError("per-round convergence was not tracked; pass "
                             "simulate_store(track_convergence=True)")
        return int(first_stable_round(self.store_uniform))

    # -- weighted (byte) accounting -------------------------------------------

    def _w(self) -> np.ndarray:
        if self.weights is None:
            raise ValueError("no per-object weights: pass "
                             "StoreSpec(weights=...)")
        return self.weights

    @property
    def tx_bytes(self) -> np.ndarray:    # [B, T]
        self._per_object("tx_bytes")
        return np.asarray(self.sim.tx, np.float64) * self._w()[:, None]

    @property
    def mem_bytes(self) -> np.ndarray:
        self._per_object("mem_bytes")
        return np.asarray(self.sim.mem, np.float64) * self._w()[:, None]

    @property
    def store_tx_bytes(self) -> np.ndarray:   # [T]
        return self.tx_bytes.sum(axis=0)

    @property
    def store_mem_bytes(self) -> np.ndarray:
        return self.mem_bytes.sum(axis=0)

    @property
    def total_tx_bytes(self) -> float:
        return float(self.store_tx_bytes.sum())


def _as_checkpointer(checkpoint) -> Optional[Checkpointer]:
    if checkpoint is None or isinstance(checkpoint, Checkpointer):
        return checkpoint
    return Checkpointer(checkpoint)


def _validate_x0(x0, lattice: Lattice, n: int, objects: int):
    """The full [B, N, ...U] shape of a stacked initial state."""
    bot = lattice.bottom("meta")
    if isinstance(x0, tuple) != isinstance(bot, tuple) or \
            len(tree_leaves(x0)) != len(tree_leaves(bot)):
        raise ValueError("StoreSpec.x0 does not have the lattice state's "
                         "tree structure")
    for leaf, b in zip(tree_leaves(x0), tree_leaves(bot)):
        want = (objects, n) + tuple(b.shape)
        got = tuple(np.shape(leaf))
        if got != want:
            raise ValueError(
                f"StoreSpec.x0 leaf has shape {got} but this "
                f"{lattice.name!r} store over {n} nodes needs [objects, "
                f"nodes, ...universe] = {want}")


def _validate_op_fn(op_fn, x, objects: int, n: int):
    """Call ``op_fn`` once on the initial stacked state (round 0) and check
    its output before anything runs: a mis-shaped delta would otherwise
    surface deep in a round, or broadcast into wrong semantics."""
    try:
        out = op_fn(x, 0)
    except Exception as e:  # noqa: BLE001 - re-raised as a refusal
        raise ValueError(
            f"StoreSpec.op_fn failed on the stacked state [objects="
            f"{objects}, nodes={n}, ...universe]: {e}") from e
    if isinstance(out, tuple) != isinstance(x, tuple) or \
            len(tree_leaves(out)) != len(tree_leaves(x)):
        raise ValueError("StoreSpec.op_fn must return one delta leaf per "
                         "state leaf, in the state's tree structure")
    for o, a in zip(tree_leaves(out), tree_leaves(x)):
        if tuple(o.shape) != tuple(a.shape):
            raise ValueError(
                f"StoreSpec.op_fn returned a delta leaf of shape "
                f"{tuple(o.shape)} for a state leaf of shape "
                f"{tuple(a.shape)}: deltas must match the stacked [objects, "
                f"nodes, ...universe] state exactly")


def _reduce_objects(m: RoundMetrics, uni, ch=None):
    """The in-loop object reduction of ``object_metrics=False``: each
    round's per-object metrics folded to one [1] partial (sums; the max for
    ``max_mem_node``); ``uniform`` the [1] all-objects agreement; the
    telemetry channels ``ch`` (None without telemetry) to [1, N] in the
    metric dtype — sums for the payload tallies, maxes for the lag and gap
    channels — so store-scale sums cannot wrap int32."""
    out = RoundMetrics(
        tx=m.tx.sum(0, keepdim=True), mem=m.mem.sum(0, keepdim=True),
        cpu=m.cpu.sum(0, keepdim=True),
        max_mem_node=m.max_mem_node.amax(0, keepdim=True))
    uni = None if uni is None else torch.all(uni, 0, keepdim=True)
    if ch is not None:
        mdt = m.tx.dtype

        def rsum(v):
            return v.to(mdt).sum(0, keepdim=True, dtype=mdt)

        def rmax(v):
            return v.to(mdt).amax(0, keepdim=True)

        ch = tel.TelemetryChannels(
            recv_elems=rsum(ch.recv_elems), novel_elems=rsum(ch.novel_elems),
            stale_rounds=rmax(ch.stale_rounds), ack_lag=rmax(ch.ack_lag),
            buf_elems=rsum(ch.buf_elems), div_gap=rmax(ch.div_gap))
    return out, uni, ch


def simulate_store(
    algo: str,
    lattice: Lattice,
    topo: Topology,
    spec: StoreSpec,
    active_rounds: int,
    quiet_rounds: int = 0,
    loo: str = "prefix",
    engine: str = "reference",
    wide_metrics: bool = True,
    track_convergence: Optional[bool] = None,
    shard: bool = False,
    digest: Optional[DigestSpec] = None,
    layout: str = "rows",
    chunk_rounds: Optional[int] = None,
    checkpoint: Union[Checkpointer, str, Path, None] = None,
    object_metrics: bool = True,
    pad_to: Optional[int] = None,
    telemetry=None,
    provenance=None,
    trace=None,
    device="cuda",
) -> StoreResult:
    """Run ``spec.objects`` independent CRDT objects of one ``algo`` ×
    ``lattice`` × ``topo`` as one batched run on ``device`` (the card by
    default; ``"cpu"`` runs on the CPU).

    ``res.object_result(b)`` is bit-identical to the single run of object
    b's op stream and initial state, under the store-shared fault
    schedule, on any ``engine``. ``track_convergence`` defaults on exactly
    when a fault schedule is given. ``layout``, the scale knobs
    (``chunk_rounds``, ``checkpoint``, ``object_metrics``) and the
    observability (``telemetry``, ``provenance``, ``trace``) are described
    in the module docstring; ``shard`` and ``pad_to`` raise
    ``NotImplementedError``.
    """
    return _simulate_store(
        algo, lattice, topo, spec, active_rounds, quiet_rounds, loo=loo,
        engine=engine, wide_metrics=wide_metrics,
        track_convergence=track_convergence, shard=shard, digest=digest,
        layout=layout, chunk_rounds=chunk_rounds, checkpoint=checkpoint,
        object_metrics=object_metrics, pad_to=pad_to, telemetry=telemetry,
        provenance=provenance, trace=trace, device=device, resume=None)


def resume_store(
    algo: str,
    lattice: Lattice,
    topo: Topology,
    spec: StoreSpec,
    active_rounds: int,
    quiet_rounds: int = 0,
    *,
    checkpoint: Union[Checkpointer, str, Path],
    step: Optional[int] = None,
    chunk_rounds: Optional[int] = None,
    loo: str = "prefix",
    engine: str = "reference",
    wide_metrics: bool = True,
    track_convergence: Optional[bool] = None,
    shard: bool = False,
    digest: Optional[DigestSpec] = None,
    layout: str = "rows",
    object_metrics: bool = True,
    pad_to: Optional[int] = None,
    telemetry=None,
    provenance=None,
    trace=None,
    device="cuda",
) -> StoreResult:
    """Restore a chunk-boundary checkpoint and run the remaining rounds.

    Pass the same ``spec`` and configuration the interrupted
    ``simulate_store`` ran with: the bundle's run fingerprint is checked
    and a mismatch raises before anything is restored. ``step`` picks a
    saved round boundary (default: the newest); ``chunk_rounds`` defaults
    to the one recorded. The result is bit-identical to the uninterrupted
    run, and checkpointing continues from the restored boundary.
    """
    ckpt = _as_checkpointer(checkpoint)
    steps = ckpt.available_steps()
    if not steps:
        raise ValueError(f"no checkpoints under {ckpt.dir}")
    if step is None:
        step = steps[-1]
    if step not in steps:
        raise ValueError(f"no checkpoint for round {step} under {ckpt.dir}: "
                         f"available {steps}")
    extra = ckpt.manifest(step).get("extra", {})
    if chunk_rounds is None:
        chunk_rounds = extra.get("chunk_rounds")
        if chunk_rounds is None:
            raise ValueError(f"checkpoint step {step} under {ckpt.dir} "
                             f"records no chunk_rounds: pass chunk_rounds=")
    return _simulate_store(
        algo, lattice, topo, spec, active_rounds, quiet_rounds, loo=loo,
        engine=engine, wide_metrics=wide_metrics,
        track_convergence=track_convergence, shard=shard, digest=digest,
        layout=layout, chunk_rounds=chunk_rounds, checkpoint=ckpt,
        object_metrics=object_metrics, pad_to=pad_to, telemetry=telemetry,
        provenance=provenance, trace=trace, device=device,
        resume=(ckpt, step, extra))


def _simulate_store(algo, lattice, topo, spec, active_rounds, quiet_rounds,
                    *, loo, engine, wide_metrics, track_convergence, shard,
                    digest, layout, chunk_rounds, checkpoint, object_metrics,
                    pad_to, telemetry, provenance, trace, device,
                    resume) -> StoreResult:
    if shard or pad_to is not None:
        raise NotImplementedError(
            "simulate_store(shard=True, pad_to=): the object axis over "
            "several devices and its padding wait for torch.distributed "
            "(ROADMAP A4, launch/mesh)")
    check_obs(telemetry, provenance)
    if provenance is not None and not object_metrics:
        raise ValueError(
            "provenance= requires object_metrics=True: lineage matrices "
            "are per-object [B, N, E] views and cannot be reduced to one "
            "partial in the loop")
    if layout not in ("grid", "rows"):
        raise ValueError(f"unknown layout {layout!r}; one of "
                         f"('grid', 'rows')")
    if chunk_rounds is not None and chunk_rounds < 1:
        raise ValueError(f"chunk_rounds must be >= 1, got {chunk_rounds}")
    ckpt = _as_checkpointer(checkpoint)
    if ckpt is not None and chunk_rounds is None:
        raise ValueError("checkpoint= requires chunk_rounds: bundles are "
                         "written at chunk boundaries")
    dev = resolve_device(device)
    b, n = spec.objects, topo.num_nodes
    total = active_rounds + quiet_rounds

    # -- eager validation (before anything runs) --------------------------------
    if spec.x0 is not None:
        _validate_x0(spec.x0, lattice, n, b)
    x0 = None if spec.x0 is None else T.to(spec.x0, dev)
    x_first = x0 if x0 is not None else \
        T.bcast(lattice.bottom(dev), (b, n))
    _validate_op_fn(spec.op_fn, x_first, b, n)
    del x_first

    alg = SyncAlgorithm(
        name=algo, lattice=lattice, topo=topo.on(dev), loo=loo,
        engine=engine,
        metric_dtype=torch.int64 if wide_metrics else torch.int32,
        digest=digest, batch=b)
    views = spec.shared_views(topo, total, dev)
    if track_convergence is None:
        track_convergence = views is not None
    reduce = None if object_metrics else _reduce_objects
    fp = _run_fingerprint(algo, engine, lattice, topo, loo, b,
                          total, chunk_rounds, object_metrics,
                          track_convergence, wide_metrics, digest,
                          telemetry, provenance)

    carry = wrap_carry(alg, alg.init(x0), telemetry, provenance)
    start, chunks = 0, []
    if resume is not None:
        ckpt_r, at, extra = resume
        bad = [k for k, v in fp.items() if extra.get(k) != v]
        if bad:
            detail = ", ".join(f"{k}: saved {extra.get(k)!r} vs requested "
                               f"{fp[k]!r}" for k in bad)
            raise ValueError(f"checkpoint round {at} under {ckpt_r.dir} was "
                             f"written by a different store run: {detail}")
        if at > total:
            raise ValueError(f"checkpoint round {at} is past total rounds "
                             f"{total}")
        mdt = np.int64 if wide_metrics else np.int32
        lead = (at, b if object_metrics else 1)
        cdt = np.int32 if object_metrics else mdt
        like = {"carry": carry,
                "ys": Chunk(tuple(np.zeros(lead, mdt) for _ in range(4)),
                            np.zeros(lead, bool) if track_convergence
                            else None,
                            None if telemetry is None else tuple(
                                np.zeros(lead + (n,), cdt)
                                for _ in range(6)),
                            None if provenance is None else tuple(
                                np.zeros(lead + (n,), np.int32)
                                for _ in range(3)))}
        bundle = ckpt_r.restore(at, like)
        carry, start = bundle["carry"], at
        chunks.append(bundle["ys"])
        del like, bundle

    step = chunk_rounds or max(total - start, 1)
    span = trace.span("store_scan", algo=algo, engine=engine, objects=b,
                      rounds=total) if trace is not None \
        else contextlib.nullcontext()
    with span:
        for t0 in range(start, total, step):
            t1 = min(t0 + step, total)
            carry, ys = run_rounds(alg, carry, spec.op_fn, active_rounds,
                                   views, track_convergence, t0, t1, reduce,
                                   telemetry, provenance)
            chunks.append(ys)
            if trace is not None and chunk_rounds is not None:
                trace.instant("chunk_boundary", rounds_done=t1)
            if ckpt is not None:
                save = trace.span("checkpoint_save", rounds_done=t1) \
                    if trace is not None else contextlib.nullcontext()
                with save:
                    ckpt.save(t1, {"carry": carry, "ys": cat_chunks(chunks)},
                              extra=fp)
    if not chunks:
        raise ValueError(f"nothing to run: start={start} >= total={total}")
    sim = collect_result(carry, cat_chunks(chunks), batched=True,
                         telemetry=telemetry, provenance=provenance,
                         nbrs=topo.nbrs)
    del carry

    fsb = None
    if spec.weights is not None:
        # weighted final-state footprint [B, N]: every irreducible of
        # object b priced at weights[b] bytes, aligned per leaf
        w = torch.as_tensor(spec.weights, dtype=torch.float64, device=dev)
        fsb = lattice.wsize(sim.final_x, BatchWeights(w)).cpu().numpy()
    return StoreResult(sim=sim, weights=spec.weights, final_state_bytes=fsb,
                       object_metrics=object_metrics, num_objects=b)


def _run_fingerprint(algo, engine, lattice, topo, loo, objects,
                     total_rounds, chunk_rounds, object_metrics,
                     track_convergence, wide_metrics, digest,
                     telemetry=None, provenance=None) -> dict:
    """JSON-safe identity of a store run, written into every chunk
    checkpoint's manifest and checked on resume: restoring a bundle into a
    differently configured run would fit the same carry shapes for many
    configurations but break bit-identity silently."""
    return {
        "kind": "store",
        "algo": algo,
        "engine": engine,
        "lattice": lattice.name,
        "topology": topo.name,
        "loo": loo,
        "objects": objects,
        "total_rounds": total_rounds,
        "chunk_rounds": chunk_rounds,
        "object_metrics": bool(object_metrics),
        "track_convergence": bool(track_convergence),
        "wide_metrics": bool(wide_metrics),
        "digest": None if digest is None else digest.block_elems,
        # observability changes the carry and the channels a bundle holds
        "telemetry": None if telemetry is None else telemetry.asdict(),
        "provenance": None if provenance is None else provenance.asdict(),
    }
