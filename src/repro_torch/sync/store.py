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
  bytes (``StoreResult.*_bytes``, float64 from the same integers).

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
``object_metrics=False``, [S, T, N] per-shard partials reduced in the
loop: sums for recv/novel/buf, maxes for stale/ack/gap, in the metric
dtype);
``provenance=`` the per-object lineage (it needs ``object_metrics=True``);
both carries and their channels ride the checkpoints, and a resume under
another observability configuration is refused. ``trace=`` takes an
``obs.TraceLog`` and records the run as a ``store_scan`` span, with a
``chunk_boundary`` instant at every chunk end of a chunked run, a
``checkpoint_save`` span around every save, and one ``results_to_host``
counter: ``bytes``, the results the run brought to the host (its metrics,
convergence flags, channels and weighted footprint; on the CPU they are
there already), and ``pinned_bytes``, the pinned host memory newly
allocated for them (0 when PyTorch's caching host allocator reused its
blocks, as it does from a store's second run of a size on). A sharded run
also records one ``store_blocks`` counter: ``blocks``,
``objects_per_block`` and ``gathered_bytes``, the final states copied onto
the first device from the others. Three phases carry
``torch.profiler`` labels (``obs.annotate``; no cost outside a profile):
``store.check`` (the checks before anything runs), ``store.collect``
(every block's results to the host) and ``store.gather`` (the blocks
gathered on the first device, the pad masked out, the footprint's copy).

Sharding and padding: ``shard=True`` splits the object axis into equal
blocks over the devices of ``device`` (``launch.mesh.store_mesh``: every
card for ``"cuda"``, or an explicit list such as ``["cpu"] * 4`` or
``["cuda:0"] * 4``). Each block is its own batched run on its device,
stepped round by round beside the others (objects never communicate). An
object count the blocks cannot split is padded with ⊥ objects to the
shard multiple (``pad_to`` forces a multiple, which the shard count must
divide). With one block the op stream sees exactly the unpadded objects;
over several, each block runs ``op_fn.for_block(lo, hi)`` when the op_fn
has one (``workloads.versioned_slot_op``), else ``op_fn`` itself, which
must then derive the object extent from ``x``. Over several blocks the op
stream is checked block by block, each on its own initial states on its own
device (no device holds a whole-store state or op table); one block checks
it on the whole store. The pad is sliced off the
per-object results and masked out of the in-loop reductions: with
``object_metrics=False``, ``sim`` holds [S, T] per-shard partials (S the
block count), through chunks, checkpoints (a bundle holds a carry and a
metrics prefix a block) and ``resume_store`` (the fingerprint records the
shard count).
One block is the unsharded run, launch for launch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from pathlib import Path
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.lattice import BatchWeights, Lattice, tree_leaves
from repro_torch.launch import mesh
from repro_torch.obs import provenance as prv
from repro_torch.obs import telemetry as tel
from repro_torch.obs.trace import annotate
from repro_torch.sync import treeops as T
from repro_torch.sync.algorithms import RoundMetrics, SyncAlgorithm
from repro_torch.sync.digest import DigestSpec
from repro_torch.sync.faults import FaultSchedule, FaultViews, shared_views
from repro_torch.sync.simulator import (Chunk, RoundLoop, SimResult,
                                        cat_chunks, cat_results, check_obs,
                                        collect_result, first_stable_round,
                                        host_copy, host_sync, pinned_bytes,
                                        run_blocks, wrap_carry)
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
    axis in the loop: ``sim`` holds [S, T] per-shard partial sums (maxes
    for ``max_mem_node``; S = 1 unsharded), the ``store_*`` aggregates are
    exact and the per-object views raise."""

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
        [B, T, N] per-object channels, or with ``object_metrics=False``
        [S, T, N] per-shard partials (sums for recv/novel/buf, maxes for
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
    _check_delta(out, x)


def _check_delta(out, x):
    """Refuse a delta ``out`` that is not shaped as the state ``x``."""
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


def _validate_block_op(op_fn, x, shards: int):
    """Call one block's op stream once on the block's initial states ``x``
    (round 0), on the block's device, and check its output before anything
    runs. A call that raises, or deltas of another object extent than the
    block's, are refused as an op stream that cannot be sharded (it closes
    over whole-store tables); other mis-shaped deltas as
    :func:`_validate_op_fn` refuses them."""
    rows = tree_leaves(x)[0].shape[0]
    try:
        out = op_fn(x, 0)
    except Exception as e:  # noqa: BLE001 - re-raised as a refusal
        raise mesh.unshardable_op("StoreSpec.op_fn", mesh.STORE_AXIS, shards,
                                  rows, e) from e
    if any(o.ndim == 0 or o.shape[0] != rows for o in tree_leaves(out)):
        raise mesh.unshardable_op("StoreSpec.op_fn", mesh.STORE_AXIS, shards,
                                  rows)
    _check_delta(out, x)


def _block_x0(x0, lattice: Lattice, block: mesh.Block, objects: int, n: int):
    """Objects [lo, hi) of the stacked initial states (⊥ where ``x0`` is
    None) on the block's device; those at or past ``objects`` (the shard
    pad) at ⊥."""
    rows = block.hi - block.lo
    if x0 is None:
        return T.bcast(lattice.bottom(block.device), (rows, n))
    real = max(min(block.hi, objects) - block.lo, 0)
    out = T.to(T.tree_map(lambda a: a[block.lo:block.lo + real], x0),
               block.device)
    return _pad_tree(out, lattice, rows - real, n) if real < rows else out


def _reduce_objects(m: RoundMetrics, uni, ch=None, keep=None):
    """The in-loop object reduction of ``object_metrics=False``: each
    round's per-object metrics folded to one [1] partial (sums; the max for
    ``max_mem_node``); ``uniform`` the [1] all-objects agreement; the
    telemetry channels ``ch`` (None without telemetry) to [1, N] in the
    metric dtype — sums for the payload tallies, maxes for the lag and gap
    channels — so store-scale sums cannot wrap int32. ``keep`` [B] bool
    masks the shard pad's objects out (None: every object counts); a
    padded ``digest_driven`` object still pays the Merkle floor, so
    dropping its rows after the run would not be enough."""

    def kept(v):
        if keep is None:
            return v
        return torch.where(keep.view((-1,) + (1,) * (v.ndim - 1)), v, 0)

    out = RoundMetrics(
        tx=kept(m.tx).sum(0, keepdim=True),
        mem=kept(m.mem).sum(0, keepdim=True),
        cpu=kept(m.cpu).sum(0, keepdim=True),
        max_mem_node=kept(m.max_mem_node).amax(0, keepdim=True))
    if uni is not None:
        uni = torch.all(uni if keep is None else uni | ~keep, 0,
                        keepdim=True)
    if ch is not None:
        mdt = m.tx.dtype

        def rsum(v):
            return kept(v.to(mdt)).sum(0, keepdim=True, dtype=mdt)

        def rmax(v):
            return kept(v.to(mdt)).amax(0, keepdim=True)

        ch = tel.TelemetryChannels(
            recv_elems=rsum(ch.recv_elems), novel_elems=rsum(ch.novel_elems),
            stale_rounds=rmax(ch.stale_rounds), ack_lag=rmax(ch.ack_lag),
            buf_elems=rsum(ch.buf_elems), div_gap=rmax(ch.div_gap))
    return out, uni, ch


def _host_bytes(ys: Chunk) -> int:
    """The bytes of a chunk's arrays."""
    return sum(a.nbytes for part in (ys.metrics, (ys.uniform,), ys.tele,
                                     ys.prov) if part is not None
               for a in part if a is not None)


def _pad_tree(tree, lattice: Lattice, pad: int, n: int):
    """Append ``pad`` ⊥ objects [pad, n, ...U] on the leading (object) axis
    of every leaf."""
    bot = lattice.bottom(tree_leaves(tree)[0].device)
    return T.tree_map(
        lambda a, bl: torch.cat([a, bl.to(a.dtype).expand(
            (pad, n) + tuple(bl.shape))]), tree, bot)


def _object_blocks(b: int, shard: bool, pad_to: Optional[int], device):
    """The padded object count and its blocks: one block on ``device``
    unsharded, else one a device of the store mesh over ``device``."""
    m = mesh.batch_mesh(mesh.STORE_AXIS, shard, device)
    nshard = mesh.axis_shards(m, mesh.STORE_AXIS)
    mult = nshard if pad_to is None else pad_to
    if mult < 1:
        raise ValueError(f"pad_to must be >= 1, got {pad_to}")
    b_pad = mesh.padded_size(b, mult)
    if b_pad % nshard:
        raise ValueError(
            f"pad_to={pad_to} pads {b} objects to {b_pad}, which the "
            f"{nshard}-shard object mesh cannot split — use a multiple of "
            f"{nshard} (or drop pad_to and let the engine pad)")
    return b_pad, mesh.shard_store_scan(b_pad, m)


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
    when a fault schedule is given. The scale knobs (``chunk_rounds``,
    ``checkpoint``, ``object_metrics``), the observability (``telemetry``,
    ``provenance``, ``trace``), ``shard`` and ``pad_to`` are described in
    the module docstring. With ``shard``, ``device`` may be a list of
    devices; the final states are gathered on the first.
    """
    return _simulate_store(
        algo, lattice, topo, spec, active_rounds, quiet_rounds, loo=loo,
        engine=engine, wide_metrics=wide_metrics,
        track_convergence=track_convergence, shard=shard, digest=digest,
        chunk_rounds=chunk_rounds, checkpoint=checkpoint,
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
        chunk_rounds=chunk_rounds, checkpoint=ckpt,
        object_metrics=object_metrics, pad_to=pad_to, telemetry=telemetry,
        provenance=provenance, trace=trace, device=device,
        resume=(ckpt, step, extra))


def _simulate_store(algo, lattice, topo, spec, active_rounds, quiet_rounds,
                    *, loo, engine, wide_metrics, track_convergence, shard,
                    digest, chunk_rounds, checkpoint, object_metrics,
                    pad_to, telemetry, provenance, trace, device,
                    resume) -> StoreResult:
    check_obs(telemetry, provenance)
    if provenance is not None and not object_metrics:
        raise ValueError(
            "provenance= requires object_metrics=True: lineage matrices "
            "are per-object [B, N, E] views and cannot be reduced to one "
            "partial in the loop")
    if chunk_rounds is not None and chunk_rounds < 1:
        raise ValueError(f"chunk_rounds must be >= 1, got {chunk_rounds}")
    ckpt = _as_checkpointer(checkpoint)
    if ckpt is not None and chunk_rounds is None:
        raise ValueError("checkpoint= requires chunk_rounds: bundles are "
                         "written at chunk boundaries")
    b, n = spec.objects, topo.num_nodes
    total = active_rounds + quiet_rounds

    # -- object-axis padding geometry and the device blocks -----------------
    b_pad, blocks = _object_blocks(b, shard, pad_to, device)
    nshard, pad, dev = len(blocks), b_pad - b, blocks[0].device

    def block_op(blk):
        if nshard > 1:
            # each block runs its own rows; the pad's rows are masked out
            # of the results (objects never interact)
            return mesh.block_op(spec.op_fn, blk, nshard)
        if not pad:
            return spec.op_fn

        def op_fn(x, t):
            # one block: the op stream sees exactly the unpadded objects,
            # and ⊥ deltas keep the pad at bottom
            return _pad_tree(spec.op_fn(T.tree_map(lambda a: a[:b], x), t),
                             lattice, pad, n)

        return op_fn

    # -- eager validation (before anything runs) ----------------------------
    # One block: the op stream on the whole store. Several: each block's
    # own op stream on its own initial states, on its own device, so that
    # no device holds a whole-store state or op table.
    if spec.x0 is not None:
        _validate_x0(spec.x0, lattice, n, b)
    with annotate("store.check"):
        if nshard == 1:
            x0 = None if spec.x0 is None else T.to(spec.x0, dev)
            x_first = x0 if x0 is not None else \
                T.bcast(lattice.bottom(dev), (b, n))
            _validate_op_fn(spec.op_fn, x_first, b, n)
            del x_first
            if pad and x0 is not None:
                x0 = _pad_tree(x0, lattice, pad, n)
            x0s = [x0]
            del x0
        else:
            x0s = []
            for blk in blocks:
                x_blk = _block_x0(spec.x0, lattice, blk, b, n)
                _validate_block_op(block_op(blk), x_blk, nshard)
                x0s.append(None if spec.x0 is None else x_blk)
                del x_blk

    if track_convergence is None:
        track_convergence = spec.faults is not None
    mdt = torch.int64 if wide_metrics else torch.int32
    algs, carries, views = [], [], {}
    for blk, x0_blk in zip(blocks, x0s):
        alg = SyncAlgorithm(
            name=algo, lattice=lattice, topo=topo.on(blk.device), loo=loo,
            engine=engine, metric_dtype=mdt, digest=digest,
            batch=blk.hi - blk.lo)
        if str(blk.device) not in views:      # one upload a device
            views[str(blk.device)] = spec.shared_views(topo, total,
                                                       blk.device)
        algs.append(alg)
        carries.append(wrap_carry(alg, alg.init(x0_blk), telemetry,
                                  provenance))
    del x0s, x0_blk
    fp = _run_fingerprint(algo, engine, lattice, topo, loo, b, b_pad,
                          nshard, total, chunk_rounds, object_metrics,
                          track_convergence, wide_metrics, digest,
                          telemetry, provenance)

    start, chunks = 0, [[] for _ in blocks]
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
        hdt = np.int64 if wide_metrics else np.int32
        cdt = np.int32 if object_metrics else hdt
        likes = []
        for blk in blocks:
            lead = (at, blk.hi - blk.lo if object_metrics else 1)
            likes.append(Chunk(
                tuple(np.zeros(lead, hdt) for _ in range(4)),
                np.zeros(lead, bool) if track_convergence else None,
                None if telemetry is None else tuple(
                    np.zeros(lead + (n,), cdt) for _ in range(6)),
                None if provenance is None else tuple(
                    np.zeros(lead + (n,), np.int32) for _ in range(3))))
        # a bundle holds one carry and one metrics prefix a block
        bundle = ckpt_r.restore(at, {"carry": carries, "ys": likes})
        carries, start = bundle["carry"], at
        chunks = [[ys] for ys in bundle["ys"]]
        del likes, bundle

    loops = []
    for blk, alg, carry in zip(blocks, algs, carries):
        keep = None if object_metrics or blk.hi <= b else \
            torch.arange(blk.lo, blk.hi, device=blk.device) < b
        reduce = None if object_metrics else \
            functools.partial(_reduce_objects, keep=keep)
        loops.append(RoundLoop(alg, carry, block_op(blk), active_rounds,
                               views[str(blk.device)], track_convergence,
                               reduce, telemetry, provenance))
    # the loops hold the only references: an initial carry kept alive
    # would double the buffers' memory for the whole run
    del carries, carry

    step = chunk_rounds or max(total - start, 1)
    span = trace.span("store_scan", algo=algo, engine=engine, objects=b,
                      rounds=total) if trace is not None \
        else contextlib.nullcontext()
    copied = 0
    pinned = pinned_bytes(dev) if trace is not None else 0
    with span:
        for t0 in range(start, total, step):
            t1 = min(t0 + step, total)
            outs = run_blocks(loops, t0, t1)
            for c, (_, ys) in zip(chunks, outs):
                c.append(ys)
                copied += _host_bytes(ys)
            if trace is not None and chunk_rounds is not None:
                trace.instant("chunk_boundary", rounds_done=t1)
            if ckpt is not None:
                save = trace.span("checkpoint_save", rounds_done=t1) \
                    if trace is not None else contextlib.nullcontext()
                with save:
                    ckpt.save(t1, {"carry": [c for c, _ in outs],
                                   "ys": [cat_chunks(c) for c in chunks]},
                              extra=fp)
            del outs
    if not chunks[0]:
        raise ValueError(f"nothing to run: start={start} >= total={total}")
    parts = []
    with annotate("store.collect"):
        while loops:
            # one block's carry at a time: a collected block frees its
            # buffers
            carry, _ = loops.pop(0).finish()
            parts.append(collect_result(
                carry, cat_chunks(chunks.pop(0)), batched=True,
                telemetry=telemetry, provenance=provenance, nbrs=topo.nbrs))
            del carry
    with annotate("store.gather"):
        if trace is not None and nshard > 1:
            trace.counter("store_blocks", {
                "blocks": nshard, "objects_per_block": b_pad // nshard,
                "gathered_bytes": sum(
                    a.numel() * a.element_size() for part in parts
                    for a in tree_leaves(part.final_x) if a.device != dev)})
        sim = cat_results(parts, dev)
        del parts

        # -- mask the pad back out ------------------------------------------
        if pad:
            fx = T.tree_map(lambda a: a[:b], sim.final_x)
            if object_metrics:
                sim = sim._replace(
                    tx=sim.tx[:b], mem=sim.mem[:b], cpu=sim.cpu[:b],
                    max_mem_node=sim.max_mem_node[:b], final_x=fx,
                    uniform=None if sim.uniform is None else sim.uniform[:b],
                    telemetry=None if sim.telemetry is None
                    else sim.telemetry.take_lead(b),
                    provenance=None if sim.provenance is None
                    else sim.provenance.take_lead(b))
            else:
                sim = sim._replace(final_x=fx)  # metrics masked in the loop

        fsb = None
        if spec.weights is not None:
            # weighted final-state footprint [B, N]: every irreducible of
            # object b priced at weights[b] bytes, aligned per leaf
            w = torch.as_tensor(spec.weights, dtype=torch.float64,
                                device=dev)
            fsb = host_copy(lattice.wsize(sim.final_x, BatchWeights(w)))
            host_sync(dev)
            fsb = fsb.numpy()
            copied += fsb.nbytes
    if trace is not None:
        trace.counter("results_to_host", {
            "bytes": copied, "pinned_bytes": pinned_bytes(dev) - pinned})
    return StoreResult(sim=sim, weights=spec.weights, final_state_bytes=fsb,
                       object_metrics=object_metrics, num_objects=b)


def _run_fingerprint(algo, engine, lattice, topo, loo, objects, padded,
                     shards, total_rounds, chunk_rounds, object_metrics,
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
        "padded": padded,
        "shards": shards,
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
