"""Synchronization algorithms (paper §IV, Algorithms 1 & 2, and the
anti-entropy resync modes), PyTorch counterpart of
``repro.sync.algorithms``:

* ``state``    — state-based full-state sync (baseline)
* ``classic``  — classic delta-based, Algorithm 1
* ``bp``       — + avoid back-propagation of δ-groups (origin tags)
* ``rr``       — + remove redundant state in received δ-groups (Δ-extract)
* ``bprr``     — Algorithm 2 (BP + RR), the paper's contribution
* ``state_driven``  — per edge, the lower id ships its full state and the
  other end replies with the optimal Δ(its state, received state)
* ``digest_driven`` — every node ships a block digest of its state and,
  per neighbour, the blocks whose summaries disagree with that
  neighbour's last digest (``sync/digest.py``); digest messages are priced
  as Merkle descents

Buffers: entries with equal origin are kept joined in an origin-indexed slot
of a slot-major ``B[P+1, N, U]`` (slot P = local ops) for the BP flavours,
one flat ``[N, U]`` buffer for classic/rr; ``buf_elems`` tracks the entries'
sizes for the memory metric. The BP sends are a leave-one-out join across
slots, by prefix/suffix joins (``loo="prefix"``) or the direct O(P²) fold
(``"naive"``). Sends are slot-major too, ``[P, N, U]``: send ``q`` of node
``n`` is ``d_all[q, n]``. The JAX package keeps the node axis first;
``repro_torch.convert`` swaps the two axes of a carried buffer.

States are one tensor (the dense lattices) or a tuple of tensors (lex
pairs, products); the reference round acts on every leaf through
``sync/treeops.py``. Lattices without a dense kernel kind (every tuple
state) run on the reference engine whatever engine is asked for.

Faults (``sync/faults.py``): ``round_step`` optionally takes one round's
``RoundFaults``. Down nodes send and receive nothing; a node whose sends
were not all delivered *retains* its δ-buffer instead of clearing it. The
resync modes retain nothing: requests repeat every round, so a lost message
only delays the next handshake.

Batches (sweeps and the keyed store): ``batch=B`` prepends a config axis to
every carry leaf — states [B, N, U], slot-major buffers [K, B, N, U],
``buf_elems`` [B, N], the digest ``aux`` [P, B, N, nB, 3] / [P, B, N] — and
the round's metrics come back per config ([B] instead of 0-d). Configs
share the topology but never exchange a message, so a batched round is the
unbatched round over :meth:`Topology.tiled`: B disjoint copies of the
network, whose B·N nodes are the rows of the flattened (config, node) axes.
Every per-node operation is the same, so each config is bit-identical to
its single run; only the metric sums and maxes reduce per config. The
kernels take the (config, node) rows as one row axis (``round_step`` the
configs as its ``nb`` axis), the JAX package's "rows" layout; the port has
no "grid" layout.

A round is one call of :meth:`SyncAlgorithm.round_step`; it never reads a
device value on the host, so a loop of rounds only queues device work.

A resync round carries ``torch.profiler`` labels (``obs.annotate``; no
cost outside a profile), each once a round on every engine:
``resync.digest`` (the local digests and their diff against the stored
remote digests), ``resync.extract`` (Δ(state, blocks) for every slot),
``resync.descent`` (the Merkle-descent price of every digest message) and
``resync.receive`` (the gather, the mask and the join fold, then the
stored digests' update or ``state_driven``'s responses). ``state_driven``
carries ``resync.receive`` alone; the δ rounds carry none.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core.lattice import Lattice
from repro_torch.obs.trace import annotate
from repro_torch.sync import digest as D
from repro_torch.sync import engine as engine_mod
from repro_torch.sync import treeops as T
from repro_torch.sync.digest import DigestSpec
from repro_torch.sync.topology import Topology

ALGORITHMS = ("state", "classic", "bp", "rr", "bprr", "state_driven",
              "digest_driven")
# The anti-entropy modes; they take the resync round instead of the
# Algorithm 1/2 δ-buffer round.
RESYNC_ALGORITHMS = ("state_driven", "digest_driven")


class RoundMetrics(NamedTuple):
    tx: torch.Tensor            # elements sent this round (0-d; [B] batched)
    mem: torch.Tensor           # elements held (state + buffer entries)
    cpu: torch.Tensor           # element-ops processed this round (proxy)
    max_mem_node: torch.Tensor  # worst single-node memory


class AlgoCarry(NamedTuple):
    x: object                      # [(B,) N, U] lattice states (or a tuple)
    buf: object                    # None | [(B,) N, U] | [P+1, (B,) N, U]
                                   # | [P, (B,) N, U]
    buf_elems: torch.Tensor        # int32 [(B,) N] buffered entry elements
    aux: Optional[tuple] = None    # digest_driven: (int32 [P, (B,) N, nB, 3]
                                   # remote digests, bool [P, (B,) N])


@dataclasses.dataclass(frozen=True)
class SyncAlgorithm:
    """One sync algorithm over a topology whose tables lie on the
    device the simulation runs on."""

    name: str
    lattice: Lattice
    topo: Topology
    loo: str = "prefix"          # leave-one-out strategy of the BP sends
    engine: str = "reference"    # "reference" | "fused" | "mega"
    metric_dtype: torch.dtype = torch.int64   # round-metric accumulators
    digest: Optional[DigestSpec] = None       # digest_driven's geometry
                                              # (None = the default spec)
    batch: Optional[int] = None  # config axis B (None: a single run)

    def __post_init__(self):
        if self.name not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.name!r}; expected "
                             f"one of {ALGORITHMS}")
        if self.loo not in ("prefix", "naive"):
            raise ValueError(f"unknown loo strategy {self.loo!r}")
        if self.batch is not None and self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")

    @property
    def resolved_engine(self) -> str:
        """Requested engine after the dense-kernel fallback."""
        return engine_mod.resolve(self.engine, self.lattice)

    @property
    def device(self) -> torch.device:
        return self.topo.nbrs.device

    @functools.cached_property
    def bottom_shape(self):
        """The lattice's ⊥ on the meta device: the shapes (and so the
        universe ranks) of its leaves, which align masks per leaf, without
        memory."""
        return self.lattice.bottom("meta")

    @property
    def batched(self) -> bool:
        return self.batch is not None

    @property
    def lead(self) -> tuple:
        """Leading axes of a per-node array: (N,) or (B, N)."""
        n = self.topo.num_nodes
        return (n,) if self.batch is None else (self.batch, n)

    @functools.cached_property
    def rows(self) -> Topology:
        """The topology one round routes over: ``topo``, or its
        :meth:`Topology.tiled` B copies when batched."""
        return self.topo if self.batch is None else self.topo.tiled(self.batch)

    @property
    def is_resync(self) -> bool:
        return self.name in RESYNC_ALGORITHMS

    @property
    def digest_spec(self) -> DigestSpec:
        return self.digest if self.digest is not None else DigestSpec()

    @property
    def has_buffer(self) -> bool:
        # digest_driven holds digests (in aux); state_driven's buffer holds
        # the per-neighbour Δ-responses awaiting their send round
        return self.name not in ("state", "digest_driven")

    @property
    def per_origin(self) -> bool:
        return self.name in ("bp", "bprr")

    @property
    def extracts(self) -> bool:
        return self.name in ("rr", "bprr")

    # The round's masks and tables are over the rows of :attr:`rows`
    # (R = N, or B·N batched); ``faults`` are one round's masks over the
    # same rows (:meth:`rows_faults`).

    def send_live(self, faults) -> torch.Tensor:
        """bool [R, P]: the sends an up node puts on the wire."""
        mask = self.rows.mask
        return mask if faults is None else mask & faults.up[:, None]

    def recv_valid(self, faults) -> torch.Tensor:
        """bool [R, P]: the receive slots that take a message this round
        (topology padding ∧ delivery)."""
        mask = self.rows.mask
        return mask if faults is None else mask & faults.recv_ok

    def delivered(self, faults) -> Optional[torch.Tensor]:
        """bool [R]: nodes whose sends were all delivered and which are up
        (their buffers clear); None without faults (every buffer clears)."""
        if faults is None:
            return None
        return torch.all(faults.send_ok | ~self.rows.mask, dim=-1) & faults.up

    def rows_faults(self, faults):
        """One round's masks over the rows: per-config [B, N, P] / [B, N]
        masks (a sweep's stacks) or store-shared [1, N, P] / [1, N] ones
        (broadcast to every object) flattened to [B·N, P] / [B·N]."""
        if faults is None or self.batch is None:
            return faults
        b = self.batch
        return type(faults)(*(
            a.expand((b,) + tuple(a.shape[1:])).reshape(
                (-1,) + tuple(a.shape[2:])) for a in faults))

    def msum(self, v: torch.Tensor) -> torch.Tensor:
        """Metric sum, in the accumulator dtype, of a tally whose LAST axis
        is the rows: over every axis (0-d), or per config ([B])."""
        acc = self.metric_dtype
        if self.batch is None:
            return v.to(acc).sum(dtype=acc)
        v = v.reshape(tuple(v.shape[:-1]) + (self.batch,
                                             self.topo.num_nodes))
        dims = tuple(d for d in range(v.ndim) if d != v.ndim - 2)
        return v.to(acc).sum(dim=dims, dtype=acc)

    # -- state ---------------------------------------------------------------

    def init(self, x0=None) -> AlgoCarry:
        p = self.topo.max_degree
        lead = self.lead
        bot = self.lattice.bottom(self.device)
        x = T.bcast(bot, lead) if x0 is None else T.to(x0, self.device)
        aux = None
        if self.name == "digest_driven":
            nb = self.digest_spec.num_blocks(D.state_universe(bot))
            buf = None
            # per-slot last-received remote digests + have-one flags
            aux = (torch.zeros((p,) + lead + (nb, D.CHANNELS),
                               dtype=torch.int32, device=self.device),
                   torch.zeros((p,) + lead, dtype=torch.bool,
                               device=self.device))
        elif self.name == "state_driven":
            buf = T.bcast(bot, (p,) + lead)     # destination-indexed resp
        elif not self.has_buffer:
            buf = None
        elif self.per_origin:
            buf = T.bcast(bot, (p + 1,) + lead)
        else:
            buf = T.bcast(bot, lead)
        return AlgoCarry(x=x, buf=buf, buf_elems=torch.zeros(
            lead, dtype=torch.int32, device=self.device), aux=aux)

    def _carry_rows(self, carry: AlgoCarry, merge: bool) -> AlgoCarry:
        """A batched carry over the rows of the tiled topology (``merge``)
        or back: the (config, node) axes of every leaf merged (views)."""
        b = self.batch

        def at(state, axis):
            if state is None:
                return None
            return T.merge_axes(state, axis) if merge \
                else T.split_axis(state, axis, b)

        slot_buf = self.per_origin or self.name == "state_driven"
        aux = None if carry.aux is None else tuple(at(a, 1) for a in carry.aux)
        return AlgoCarry(x=at(carry.x, 0), buf=at(carry.buf, int(slot_buf)),
                         buf_elems=at(carry.buf_elems, 0), aux=aux)

    # -- sends ---------------------------------------------------------------

    def _loo_sends(self, buf):
        """d[p, i] = ⊔ {B[o, i] | o ≠ p} for p in 0..P-1 (slot P always in)."""
        lat = self.lattice
        p = self.topo.max_degree
        if self.resolved_engine in engine_mod.KERNEL_ENGINES:
            return engine_mod.fused_loo_sends(buf, lat.kernel_kind)
        slots = [T.slot(buf, k) for k in range(p + 1)]
        if self.loo == "naive":
            outs = []
            for j in range(p):
                acc = None
                for o in range(p + 1):
                    if o != j:
                        acc = slots[o] if acc is None else lat.join(acc, slots[o])
                outs.append(acc)
        else:
            bot = T.zeros_like(slots[0])
            prefix, suffix = [None] * (p + 1), [None] * (p + 1)
            acc = bot
            for k in range(p + 1):
                prefix[k] = acc
                acc = lat.join(acc, slots[k])
            acc = bot
            for k in range(p, -1, -1):
                suffix[k] = acc
                acc = lat.join(acc, slots[k])
            outs = [lat.join(prefix[j], suffix[j]) for j in range(p)]
        return T.stack(outs)                               # [P, N, U]

    def _bcast_sends(self, state):
        """One per-node state over the P send slots: [N, U] -> [P, N, U]
        (a broadcast view)."""
        p = self.topo.max_degree
        return T.tree_map(lambda a: a.unsqueeze(0).expand(
            (p,) + tuple(a.shape)), state)

    # -- one synchronous round -----------------------------------------------

    def round_step(self, carry: AlgoCarry, op_delta, faults=None,
                   recv_counts: bool = False, want_inbox: bool = False):
        """One synchronous round; ``faults`` is one round's
        ``faults.RoundFaults`` (None: fault-free; batched, per-config
        [B, N, P] or store-shared [1, N, P] masks). Returns
        ``(carry, RoundMetrics)``, the metrics 0-d or per config [B].

        With ``recv_counts`` (telemetry) a third element ``(recv,
        novel)``: int32 [(B,) N] received and novel-at-join element
        tallies summed over the P receive slots, the same on every engine
        (the kernel engines sum the kernels' ``dsz``/``cnt``, the
        reference loop counts them per slot). With ``want_inbox``
        (provenance) the LAST element is the active-masked inbox, slot-
        major [P, (B,) N, ...U]: per receive slot the δ-group the
        slot-order fold consumed, ⊥ where topology padding or a fault
        suppressed it; the same on every engine. With neither flag the
        round is the one it always was."""
        if self.batch is None:
            return self._round(carry, op_delta, faults, recv_counts,
                               want_inbox)
        out = self._round(self._carry_rows(carry, True),
                          T.merge_axes(op_delta, 0), self.rows_faults(faults),
                          recv_counts, want_inbox)
        ret = (self._carry_rows(out[0], False), out[1])
        if recv_counts:
            ret += (tuple(r.reshape(self.lead) for r in out[2]),)
        if want_inbox:
            ret += (T.split_axis(out[-1], 1, self.batch),)
        return ret

    def _round(self, carry: AlgoCarry, op_delta, faults, recv_counts=False,
               want_inbox=False):
        """One round over the rows of :attr:`rows` (a carry whose per-node
        axis is the R rows); the extra returns of :meth:`round_step` per
        row."""
        if self.is_resync:
            return self._resync_round(carry, op_delta, faults, recv_counts,
                                      want_inbox)
        lat = self.lattice
        p = self.topo.max_degree
        x, buf, buf_elems, _ = carry

        if self.resolved_engine == "mega":
            x, buf, buf_elems, tx, cpu, state_elems, recv, inbox = \
                engine_mod.mega_round(self, x, buf, buf_elems, op_delta,
                                      faults, recv_counts, want_inbox)
            return self._extras(
                (AlgoCarry(x, buf, buf_elems),
                 self._metrics(tx, cpu, state_elems, buf_elems)),
                recv, inbox, recv_counts, want_inbox)

        # (1) local update: δ = mᵟ(xᵢ); store(δ, i)      [Alg 2, lines 6-8]
        dsz = lat.size(op_delta)                                   # [N]
        x = lat.join(x, op_delta)
        if self.has_buffer:
            if self.per_origin:
                buf = T.set_slot(buf, p, lat.join(T.slot(buf, p), op_delta))
            else:
                buf = lat.join(buf, op_delta)
            buf_elems = buf_elems + dsz
        cpu = self.msum(dsz)

        # (2) sends                                        [Alg 2, lines 9-12]
        if not self.has_buffer:
            d_all = self._bcast_sends(x)
        elif self.per_origin:
            d_all = self._loo_sends(buf)
        else:
            d_all = self._bcast_sends(buf)
        # tx counts what an up sender puts on the wire, delivered or not
        tx = self.msum(lat.size(d_all) * self.send_live(faults).T)
        cpu = cpu + tx  # serialization cost ∝ elements sent

        # (3) clear buffer                                 [Alg 2, line 13]
        # Under faults a node whose sends were not all delivered RETAINS its
        # buffer (ack-gated eviction) and re-sends it next round.
        if self.has_buffer:
            dlv = self.delivered(faults)
            if dlv is None:
                buf = T.zeros_like(buf)
                buf_elems = torch.zeros_like(buf_elems)
            else:
                buf = T.where_lead(~dlv, buf, 0, self.bottom_shape)
                buf_elems = torch.where(dlv, 0, buf_elems)

        # (4) receive all messages, sequentially per slot  [Alg 2, lines 14-17]
        if self.resolved_engine == "fused":
            # route, then let the sends go: at a store's size they are
            # gigabytes
            inbox = engine_mod.gather_inbox(d_all, self.rows)
            del d_all
            x, buf, buf_elems, cpu, recv, inbox = engine_mod.fused_receive(
                self, x, buf, buf_elems, cpu, inbox, faults, recv_counts,
                want_inbox)
        else:
            x, buf, buf_elems, cpu, recv, inbox = self._receive_reference(
                x, buf, buf_elems, cpu, d_all, faults, recv_counts,
                want_inbox)

        # (5) metrics
        return self._extras(
            (AlgoCarry(x, buf, buf_elems),
             self._metrics(tx, cpu, lat.size(x), buf_elems)),
            recv, inbox, recv_counts, want_inbox)

    @staticmethod
    def _extras(ret, recv, inbox, recv_counts, want_inbox):
        """``(carry, metrics)`` with the requested extra returns."""
        if recv_counts:
            ret += (recv,)
        if want_inbox:
            ret += (inbox,)
        return ret

    # -- anti-entropy resync rounds -------------------------------------------

    def _slot_where(self, cond, a, b):
        """Select between two slot-major [P, N, U] states by a [N, P]
        node-major mask. The mask is transposed into a contiguous copy:
        a transposed view would lay the result out transposed too, and
        the kernels take contiguous operands."""
        return T.where_lead(cond.T.contiguous(), a, b, self.bottom_shape)

    def _join_inbox(self, x, inbox, want_novel: bool = False):
        """x ⊔ every (pre-masked) inbox slot [P, N, U], in slot order: one
        ``round_recv`` launch on the kernel engines, the torch loop on the
        reference engine (max/or joins are exact, so both agree). With
        ``want_novel`` (telemetry) returns ``(x, novel)``: the per-row
        novel-element tally |Δ(slot, x_running)| summed over the slots —
        the kernel's ``cnt``, or a Δ + size pass a slot on the reference
        engine."""
        if self.resolved_engine in engine_mod.KERNEL_ENGINES:
            return engine_mod.fused_join_inbox(self, x, inbox, want_novel)
        lat = self.lattice
        novel = None
        for q in range(self.topo.max_degree):
            d = T.slot(inbox, q)
            if want_novel:
                sz = lat.size(lat.delta(d, x)).to(torch.int32)
                novel = sz if novel is None else novel + sz
            x = lat.join(x, d)
        return (x, novel) if want_novel else x

    def _resync_round(self, carry: AlgoCarry, op_delta, faults=None,
                      recv_counts: bool = False, want_inbox: bool = False):
        """One pipelined anti-entropy round of ``state_driven`` /
        ``digest_driven``.

        What a node sends is a function of its current state and, for
        responses, the latest request or digest it holds, recomputed every
        round; so faults need no retention — a lost message is subsumed by
        the next handshake, and a stale digest is safe because states only
        grow. On the kernel engines (``mega`` included) ``digest_driven``
        runs one ``digest_blocks``, one ``masked_extract``, one
        ``merkle_descent`` and one ``round_recv`` call per round,
        ``state_driven`` one ``round_recv``."""
        lat, topo = self.lattice, self.rows
        n = topo.num_nodes
        kernels = self.resolved_engine in engine_mod.KERNEL_ENGINES
        x, buf, buf_elems, aux = carry

        # (1) local update: δ joins in (no buffering: the op's effect rides
        # the state itself)
        dsz = lat.size(op_delta)                                   # [R]
        x = lat.join(x, op_delta)
        cpu = self.msum(dsz)

        # slot-major [P, N] masks (contiguous: see _slot_where)
        send_live = self.send_live(faults).T.contiguous()
        valid = self.recv_valid(faults).T.contiguous()

        if self.name == "state_driven":
            # Per-edge orientation: the lower id initiates (ships its
            # state), the higher id responds with Δ computed at receive time.
            ids = torch.arange(n, dtype=topo.nbrs.dtype, device=self.device)
            init_send = (ids[:, None] < topo.nbrs) & topo.mask      # [N, P]
            req_recv = ((topo.nbrs < ids[:, None])
                        & topo.mask).T.contiguous()               # [P, N]
            d_all = self._slot_where(init_send, self._bcast_sends(x), buf)
            dig_words = None
        else:
            # digest_driven: every slot ships (digest, differing blocks)
            dig, dvalid = aux                      # [P, N, nB, 3], [P, N]
            spec = self.digest_spec
            kind = lat.kernel_kind or "max"
            u = D.state_universe(self.bottom_shape)
            with annotate("resync.digest"):
                if kernels:
                    local_dig = engine_mod.fused_digest(x, spec, kind)
                else:
                    local_dig = D.digest_state(x, spec, kind)  # [R, nB, 3]
                blocks = D.digest_diff(local_dig[None], dig) \
                    & dvalid[..., None]                        # [P, N, nB]
            with annotate("resync.extract"):
                if kernels:
                    d_all = engine_mod.fused_extract(x, blocks, spec)
                else:
                    em = D.block_mask_to_elems(blocks, u, spec)
                    d_all = D.extract_blocks(
                        T.tree_map(lambda a: a[None], x), em)  # [P, N, U]
            # The digest exchange is priced as the Merkle-descent
            # transcript between the two current trees, capped at the flat
            # leaf layer; an undelivered exchange costs the unanswered
            # root only.
            with annotate("resync.descent"):
                ok = topo.mask if faults is None \
                    else topo.mask & faults.send_ok
                if kernels:
                    desc = engine_mod.fused_descent(local_dig, topo.routes[1])
                else:
                    desc = D.routed_descent_words(local_dig, topo.routes[1])
                desc = torch.clamp_max(desc, spec.words(u))    # [P, N]
                dig_words = torch.where(ok.T, desc, D.CHANNELS) * send_live

        # (2) sends: tx counts what an up sender puts on the wire,
        # delivered or not
        tx = self.msum(lat.size(d_all) * send_live)
        if dig_words is not None:
            tx = tx + self.msum(dig_words)
        cpu = cpu + tx

        with annotate("resync.receive"):
            # (3) receive: gather and mask once (the masked inbox is also
            # the Δ-response operand), then one join fold per engine
            inbox = T.where_bot(valid, engine_mod.gather_inbox(d_all, topo))
            recv_sizes = lat.size(inbox)                           # [P, R]
            cpu = cpu + self.msum(recv_sizes)
            recv = None
            if recv_counts:
                # telemetry: received payload and its novel part at join
                # time (digest and descent words are metadata, not payload)
                x, novel = self._join_inbox(x, inbox, want_novel=True)
                recv = (recv_sizes.sum(0, dtype=torch.int32), novel)
            else:
                x = self._join_inbox(x, inbox)

            if self.name == "state_driven":
                # (4a) responses: Δ(x', request) for every delivered
                # request, overwriting the response buffer (a lost request
                # just skips this round's response; the initiator asks
                # again)
                req_ok = req_recv & valid
                resp = T.where_bot(req_ok,
                                   lat.delta(self._bcast_sends(x), inbox))
                rsz = lat.size(resp)                               # [P, N]
                cpu = cpu + self.msum(rsz)
                buf = resp
                buf_elems = rsz.sum(0, dtype=torch.int32)
            else:
                # (4b) store the delivered digests (each sender broadcast
                # ONE digest to all its neighbours)
                dig_in = local_dig[topo.routes[1]]         # [P, R, nB, 3]
                dig = torch.where(valid[..., None, None], dig_in, dig)
                dvalid = dvalid | valid
                aux = (dig, dvalid)
                # digesting the state is one pass over U per up node
                upm = torch.ones_like(dsz) if faults is None \
                    else faults.up.to(torch.int32)
                cpu = cpu + self.msum(upm * u)
                # memory: the stored remote digests are this mode's
                # metadata
                buf_elems = dvalid.sum(0, dtype=torch.int32) * spec.words(u)

        # the resync inbox was built masked: it is the provenance view
        return self._extras(
            (AlgoCarry(x, buf, buf_elems, aux),
             self._metrics(tx, cpu, lat.size(x), buf_elems)),
            recv, inbox, recv_counts, want_inbox)

    def _metrics(self, tx, cpu, state_elems, buf_elems) -> RoundMetrics:
        """The round's metrics from the [R] state and buffer sizes: the
        cluster's memory and its worst node, per config when batched."""
        acc = self.metric_dtype
        node_mem = state_elems.to(acc) + buf_elems.to(acc)
        if self.batch is not None:
            node_mem = node_mem.reshape(self.lead)
        return RoundMetrics(tx=tx, mem=node_mem.sum(-1, dtype=acc), cpu=cpu,
                            max_mem_node=node_mem.amax(-1))

    def _receive_reference(self, x, buf, buf_elems, cpu, d_all, faults=None,
                           want_recv: bool = False, want_inbox: bool = False):
        """Reference receive: the sequential per-slot loop. Returns
        ``(x, buf, buf_elems, cpu, recv, inbox)``: ``recv`` the telemetry
        ``(recv, novel)`` per-row tallies when ``want_recv``, ``inbox``
        the stacked masked slots [P, R, ...U] when ``want_inbox`` (each
        None otherwise)."""
        lat, topo = self.lattice, self.rows
        recv_valid = self.recv_valid(faults)
        tally = {"recv": 0, "novel": 0}
        slots = []

        def count(name, v):
            tally[name] = tally[name] + v.to(torch.int32)

        for q in range(topo.max_degree):
            valid = recv_valid[:, q]
            d = T.where_bot(valid, T.gather(d_all, topo.rev[:, q].long(),
                                            topo.nbrs[:, q].long()))
            if want_inbox:
                slots.append(d)
            if want_recv:
                count("recv", lat.size(d))
                if not self.extracts:   # RR's extraction below is this Δ
                    count("novel", lat.size(lat.delta(d, x)))
            if self.name == "state":
                cpu = cpu + self.msum(lat.size(d))
                x = lat.join(x, d)
                continue
            if self.extracts:
                stored = lat.delta(d, x)                       # RR: Δ(d, xᵢ)
                keep = torch.logical_not(lat.is_bottom(stored)) & valid
            else:
                stored = d                                     # whole group
                keep = torch.logical_not(lat.leq(d, x)) & valid  # inflation
            ssz = lat.size(stored) * keep
            if want_recv and self.extracts:
                count("novel", ssz)
            cpu = cpu + self.msum(lat.size(d)) + self.msum(ssz)
            x = lat.join(x, d)
            if self.per_origin:
                cur = T.slot(buf, q)
                buf = T.set_slot(buf, q, T.where(keep, lat.join(cur, stored),
                                                 cur))
            else:
                buf = T.where(keep, lat.join(buf, stored), buf)
            buf_elems = buf_elems + ssz
        recv = (tally["recv"], tally["novel"]) if want_recv else None
        inbox = T.stack(slots) if want_inbox else None
        return x, buf, buf_elems, cpu, recv, inbox
