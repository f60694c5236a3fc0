"""Telemetry and provenance oracles, PyTorch counterpart of
``repro.obs.oracle``: independent, unjitted replays of every observability
channel (DESIGN.md §18, §19).

``oracle_channels`` replays an unbatched ``simulate`` run round by round,
re-deriving the algorithm's messages from the documented semantics (paper
§IV Algorithms 1 & 2; DESIGN.md §14 for the resync modes), and recomputes
every telemetry channel by explicit join-and-compare per received slot:
``|Δ(d, x_running)|`` in slot order, the quantity the engines' in-scan
counters and the kernels' ``cnt`` outputs claim to tally.
``oracle_provenance`` runs the same replay and re-derives the per-element
lineage record: coverage, birth, source and hop matrices, first deliveries
per edge, and the per-cause waste split.

Nothing here goes through the engines, the algorithms, the round loop or
any kernel, nor through ``obs.telemetry``'s or ``obs.provenance``'s
channel code. The replay shares only the lattice primitives, the topology
tables, the fault views, the plain digest helpers of ``sync/digest.py``
and the result containers with the engines. The cluster gap is its own
pairwise fold, and the bit view of a packed state is its own mask test.

The replay runs in torch on ``device`` (the card unless the caller passes
``"cpu"``), so the lineage bookkeeping of a 4,194,304-key run stays on the
card. As on the engines' results, the channels come back as host int32
arrays [T, N] and the provenance matrices as tensors on the device
(``ProvenanceResult.numpy()`` brings them to the host).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.lattice import tree_map
from repro_torch.obs.provenance import (ProvenanceResult, ProvenanceSpec,
                                        element_universe)
from repro_torch.obs.telemetry import TelemetryResult, TelemetrySpec
from repro_torch.sync import digest as dgst
from repro_torch.sync.digest import DigestSpec
from repro_torch.sync.simulator import resolve_device

# bit k of an int32 bit-view word (k = 31 is int32's minimum)
_BIT = [((1 << k) + 2**31) % 2**32 - 2**31 for k in range(32)]


def _on(a, dev) -> torch.Tensor:
    """A state leaf (tensor or numpy; uint32 words as int32 bit-views) on
    ``dev``."""
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(dev)


def _bcast(bot, n: int):
    return tree_map(lambda b: b.expand((n,) + tuple(b.shape)).clone(), bot)


def _sel(cond: torch.Tensor, a, b, bot):
    """Per node: ``a`` where ``cond`` [N], else ``b``; ``cond`` aligned
    to each leaf by the universe rank of the ⊥ leaf."""

    def sel(x, y, bl):
        return torch.where(cond.reshape(cond.shape + (1,) * bl.ndim), x, y)

    return tree_map(sel, a, b, bot)


def _where_bot(cond: torch.Tensor, a, bot):
    return _sel(cond, a, tree_map(lambda x, bl: bl.expand_as(x), a, bot), bot)


def _rows(state, lo: int, hi: int):
    return tree_map(lambda a: a[lo:hi], state)


def _cluster_top(lat, x, n: int):
    """⊔ₘ xₘ over the node axis as a [1, ...U] state, by pairwise halving:
    rows [0, n − h) join rows [h, n), h = n // 2 (an odd middle row joins
    itself, which join's idempotence allows)."""
    while n > 1:
        h = n // 2
        x = lat.join(_rows(x, 0, n - h), _rows(x, h, n))
        n -= h
    return x


def _bits(words: torch.Tensor, e: int) -> torch.Tensor:
    """int32 bit-views [..., W] -> bool [..., e], little-endian, by masking
    each bit (int32 has no logical shift)."""
    m = torch.tensor(_BIT, dtype=torch.int32, device=words.device)
    b = (words[..., None] & m) != 0
    return b.reshape(words.shape[:-1] + (-1,))[..., :e]


class _Replay:
    """The messages of one unbatched run of ``algo``, replayed round by
    round; ``obs`` sees each round's gated op δ (``op``), each received
    slot before it is joined (``slot``) and the round's end (``end``)."""

    def __init__(self, algo, lat, topo, active_rounds, quiet_rounds, faults,
                 x0, digest, dev):
        self.algo, self.lat, self.dev = algo, lat, dev
        self.n, self.p = topo.num_nodes, topo.max_degree
        self.nbrs = topo.nbrs.to(dev).long()
        self.rev = topo.rev.to(dev).long()
        self.mask = topo.mask.to(dev)
        self.active = active_rounds
        self.total = active_rounds + quiet_rounds
        self.views = None if faults is None \
            else faults.views(self.total, dev)
        self.bot = lat.bottom(dev)
        self.x = _bcast(self.bot, self.n) if x0 is None \
            else tree_map(lambda a: _on(a, dev), x0)
        self.resync = algo in ("state_driven", "digest_driven")
        self.has_buffer = algo not in ("state", "digest_driven")
        self.buffered = self.has_buffer and not self.resync
        self.per_origin = algo in ("bp", "bprr")
        self.extracts = algo in ("rr", "bprr")
        self.digest = DigestSpec() if digest is None else digest

    def run(self, op_fn, obs) -> None:
        lat, n, p, bot = self.lat, self.n, self.p, self.bot
        algo, nbrs, rev, mask = self.algo, self.nbrs, self.rev, self.mask
        botn = _bcast(bot, n)
        x = self.x
        slots = fbuf = resp = None
        if self.per_origin:
            slots = [botn] * (p + 1)      # origin-indexed; slot p local ops
        elif algo in ("classic", "rr"):
            fbuf = botn
        elif algo == "state_driven":
            resp = [botn] * p             # per-destination Δ-responses
        elif algo == "digest_driven":
            u = dgst.state_universe(bot)
            kind = lat.kernel_kind or "max"
            dig = torch.zeros((n, p, self.digest.num_blocks(u),
                               dgst.CHANNELS), dtype=torch.int32,
                              device=self.dev)
            dvalid = torch.zeros((n, p), dtype=torch.bool, device=self.dev)
        buf = torch.zeros(n, dtype=torch.int32, device=self.dev)
        ids = torch.arange(n, device=self.dev)[:, None]
        init_send = (ids < nbrs) & mask   # state_driven: lower id initiates
        req_recv = (nbrs < ids) & mask

        for t in range(self.total):
            rf = None if self.views is None else self.views.at_round(t)
            recv_ok = mask if rf is None else mask & rf.recv_ok
            delivered = torch.ones(n, dtype=torch.bool, device=self.dev) \
                if rf is None else torch.all(rf.send_ok | ~mask, -1) & rf.up
            x_start = x

            # (1) the local op while t < active_rounds, where up, cast to
            # the state's dtype
            if t < self.active:
                delta = tree_map(lambda d, xl: d.to(xl.dtype),
                                 op_fn(x, t), x)
                if rf is not None:
                    delta = _where_bot(rf.up, delta, bot)
            else:
                delta = botn
            obs.op(t, delta)
            x = lat.join(x, delta)
            if self.buffered:
                if self.per_origin:
                    slots[p] = lat.join(slots[p], delta)
                else:
                    fbuf = lat.join(fbuf, delta)
                buf = buf + lat.size(delta)

            # (2) what each node addresses to its neighbour slot q
            if algo == "state":
                sends = [x] * p
            elif algo in ("classic", "rr"):
                sends = [fbuf] * p
            elif self.per_origin:         # leave-one-out over origin slots
                sends = []
                for j in range(p):
                    acc = None
                    for o in range(p + 1):
                        if o != j:
                            acc = slots[o] if acc is None \
                                else lat.join(acc, slots[o])
                    sends.append(acc)
            elif algo == "state_driven":
                # the lower id ships its state, the higher id last round's
                # Δ-response
                sends = [_sel(init_send[:, q], x, resp[q], bot)
                         for q in range(p)]
            else:                         # digest_driven: differing blocks
                local_dig = dgst.digest_state(x, self.digest, kind)
                blocks = dgst.digest_diff(local_dig[:, None], dig) \
                    & dvalid[..., None]
                em = dgst.block_mask_to_elems(blocks, u, self.digest)
                sends = [dgst.extract_blocks(x, em[:, q]) for q in range(p)]

            # (3) the ack-gated buffer clear (δ-family only)
            if self.buffered:
                if self.per_origin:
                    slots = [_sel(delivered, botn, s, bot) for s in slots]
                else:
                    fbuf = _sel(delivered, botn, fbuf, bot)
                buf = torch.where(delivered, 0, buf)

            # (4) receive in slot order against the running state
            stack = tree_map(lambda *ls: torch.stack(ls), *sends)  # [P, N]
            del sends
            inbox = []
            for q in range(p):
                valid = recv_ok[:, q]
                d = tree_map(lambda a: a[rev[:, q], nbrs[:, q]], stack)
                d = _where_bot(valid, d, bot)
                if algo == "state_driven":
                    inbox.append(d)
                obs.slot(t, q, d, x)
                if self.resync or algo == "state":
                    x = lat.join(x, d)
                    continue
                if self.extracts:         # RR: Δ against the running x
                    stored = lat.delta(d, x)
                    keep = ~lat.is_bottom(stored) & valid
                else:                     # classic / bp: the whole group
                    stored = d
                    keep = ~lat.leq(d, x) & valid
                buf = buf + lat.size(stored) * keep
                x = lat.join(x, d)
                if self.per_origin:
                    slots[q] = _sel(keep, lat.join(slots[q], stored),
                                    slots[q], bot)
                else:
                    fbuf = _sel(keep, lat.join(fbuf, stored), fbuf, bot)
            del stack

            # (4b) the resync round trip
            if algo == "state_driven":
                buf = torch.zeros_like(buf)
                for q in range(p):
                    ok = req_recv[:, q] & recv_ok[:, q]
                    resp[q] = _where_bot(ok, lat.delta(x, inbox[q]), bot)
                    buf = buf + lat.size(resp[q])
            elif algo == "digest_driven":
                dig = torch.where(recv_ok[..., None, None], local_dig[nbrs],
                                  dig)
                dvalid = dvalid | recv_ok
                buf = dvalid.sum(-1, dtype=torch.int32) \
                    * self.digest.words(u)

            obs.end(t, x_start, x, buf, delivered)


class _Channels:
    """The six telemetry channels, gated as ``TelemetrySpec`` says."""

    def __init__(self, spec: TelemetrySpec, rp: _Replay):
        self.spec, self.rp = spec, rp
        self.zero = torch.zeros(rp.n, dtype=torch.int32, device=rp.dev)
        self.stale = self.ack = self.zero
        self.rows = []

    def op(self, t, delta):               # a round starts with its op
        self.recv = self.novel = self.zero

    def slot(self, t, q, d, x):
        if self.spec.redundancy:
            lat = self.rp.lat
            self.recv = self.recv + lat.size(d)
            self.novel = self.novel + lat.size(lat.delta(d, x))

    def end(self, t, x_start, x, buf, delivered):
        spec, rp, z = self.spec, self.rp, self.zero
        lat = rp.lat
        if spec.staleness:
            grew = ~lat.leq(x, x_start)
            self.stale = torch.where(grew, 0, self.stale + 1)
        if spec.buffer and rp.has_buffer and rp.views is not None:
            self.ack = torch.where(delivered, 0, self.ack + 1)
        gap = z
        if spec.divergence:
            y = tree_map(lambda a, b: a.expand_as(b),
                         _cluster_top(lat, x, rp.n), x)
            gap = lat.size(lat.delta(y, x))
        self.rows.append((
            self.recv if spec.redundancy else z,
            self.novel if spec.redundancy else z,
            self.stale if spec.staleness else z,
            self.ack if spec.buffer else z,
            buf if spec.buffer else z, gap))

    def result(self) -> TelemetryResult:
        return TelemetryResult(*_host(self.rows, 6, self.rp.n),
                               spec=self.spec)


class _Lineage:
    """The provenance record: lineage matrices [N, E], first deliveries
    per slot (kept slot-major [P, N, E]) and the waste split by cause."""

    def __init__(self, spec: ProvenanceSpec, rp: _Replay, e: int, x0):
        self.spec, self.rp, self.e = spec, rp, e
        n, dev = rp.n, rp.dev
        self.ids = torch.arange(n, dtype=torch.int32, device=dev)[:, None]

        def full(v, shape=(n, e)):
            return torch.full(shape, v, dtype=torch.int32, device=dev)

        self.cov, self.birth, self.src, self.hop = \
            full(0), full(-1), full(-1), full(-1)
        if x0 is not None:                # held from the start: native
            m0 = self.mask(rp.x)
            self.cov = m0.to(torch.int32)
            self.src = torch.where(m0, self.ids, self.src)
            self.hop = torch.where(m0, 0, self.hop)
        self.edge_first = full(-1, (rp.p, n, e))
        self.waste_bp, self.waste_cp = full(0), full(0)
        self.rows = []

    def mask(self, v) -> torch.Tensor:
        """bool [N, E]: the elements a state or δ covers."""
        if self.rp.lat.kernel_kind == "bitor":
            return _bits(v, self.e)
        return self.rp.lat.irreducible_mask(v)

    def novel(self, d, x) -> torch.Tensor:
        """bool [N, E]: the elements of d that x does not hold."""
        if self.rp.lat.kernel_kind == "bitor":
            return _bits(d & ~x, self.e)
        return self.rp.lat.novel_mask(d, x)

    def _cover(self, new, t, src, hop):
        self.cov = torch.where(new, 1, self.cov)
        self.birth = torch.where(new, t, self.birth)
        self.src = torch.where(new, src, self.src)
        self.hop = torch.where(new, hop, self.hop)

    def op(self, t, delta):
        # local births, then the snapshot every sender's attribution reads:
        # a node sends after its own op and before any receive
        self._cover(self.mask(delta) & (self.cov == 0), t, self.ids, 0)
        self.src_op, self.hop_op = self.src, self.hop
        z = torch.zeros(self.rp.n, dtype=torch.int32, device=self.rp.dev)
        self.bp_t = self.cp_t = z

    def slot(self, t, q, d, x):
        nbr = self.rp.nbrs[:, q]
        recv_m = self.mask(d)
        if self.spec.waste:
            red = recv_m & ~self.novel(d, x)
            isbp = red & (self.src_op[nbr] == self.ids)   # shipped back
            iscp = red & ~isbp
            self.waste_bp = self.waste_bp + isbp
            self.waste_cp = self.waste_cp + iscp
            self.bp_t = self.bp_t + isbp.sum(-1, dtype=torch.int32)
            self.cp_t = self.cp_t + iscp.sum(-1, dtype=torch.int32)
        if self.spec.edges:
            ef = self.edge_first[q]
            self.edge_first[q] = torch.where(recv_m & (ef < 0), t, ef)
        self._cover(recv_m & (self.cov == 0), t,
                    nbr.to(torch.int32)[:, None], self.hop_op[nbr] + 1)

    def end(self, t, x_start, x, buf, delivered):
        self.rows.append((self.bp_t, self.cp_t,
                          self.cov.sum(-1, dtype=torch.int32)))

    def result(self) -> ProvenanceResult:
        bp, cp, covered = _host(self.rows, 3, self.rp.n)
        return ProvenanceResult(
            cov=self.cov, birth=self.birth, src=self.src, hop=self.hop,
            edge_first=self.edge_first.movedim(0, -2),
            waste_bp_elems=self.waste_bp, waste_cp_elems=self.waste_cp,
            waste_bp=bp, waste_cp=cp, covered=covered,
            nbrs=self.rp.nbrs.to(torch.int32).cpu().numpy(), spec=self.spec)


def _host(rows, k: int, n: int) -> tuple:
    """A list of rounds' k-tuples of [N] device tensors as k host int32
    arrays [T, N] (empty [0, N] for zero rounds), in one transfer."""
    if not rows:
        return tuple(np.zeros((0, n), np.int32) for _ in range(k))
    a = torch.stack([torch.stack(r) for r in rows], 1).cpu().numpy()
    return tuple(np.ascontiguousarray(c, np.int32) for c in a)


def oracle_channels(algo: str, lattice, topo, op_fn, active_rounds: int,
                    quiet_rounds: int = 0, faults=None, x0: Any = None,
                    digest: Optional[DigestSpec] = None,
                    spec: Optional[TelemetrySpec] = None,
                    device="cuda") -> TelemetryResult:
    """Recompute the [T, N] telemetry channels of an unbatched
    ``simulate(algo, ...)`` run from first principles, on ``device``."""
    dev = resolve_device(device)
    spec = TelemetrySpec() if spec is None else spec
    rp = _Replay(algo, lattice, topo, active_rounds, quiet_rounds, faults,
                 x0, digest, dev)
    obs = _Channels(spec, rp)
    rp.run(op_fn, obs)
    return obs.result()


def oracle_provenance(algo: str, lattice, topo, op_fn, active_rounds: int,
                      quiet_rounds: int = 0, faults=None, x0: Any = None,
                      digest: Optional[DigestSpec] = None,
                      spec: Optional[ProvenanceSpec] = None,
                      device="cuda") -> ProvenanceResult:
    """Recompute the full provenance record of an unbatched
    ``simulate(algo, ..., provenance=spec)`` run from first principles, on
    ``device``: the message replay of :func:`oracle_channels` with its own
    lineage bookkeeping. Attribution reads the sender's source and hop as
    they stood after the op phase (sends precede every receive in a
    round), which ``provenance.round_update`` documents, matched by
    construction and not by sharing its code."""
    dev = resolve_device(device)
    spec = ProvenanceSpec() if spec is None else spec
    e = element_universe(lattice, spec.universe)
    rp = _Replay(algo, lattice, topo, active_rounds, quiet_rounds, faults,
                 x0, digest, dev)
    obs = _Lineage(spec, rp, e, x0)
    rp.run(op_fn, obs)
    return obs.result()
