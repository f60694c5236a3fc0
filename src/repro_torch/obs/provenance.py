"""Delta provenance: per-element lineage and wasted-transmission
attribution, PyTorch counterpart of ``repro.obs.provenance``.

Telemetry (``obs/telemetry.py``) measures how many delivered elements were
already known. This module says which element was shipped again, along
which edge, and for which of the paper's two inefficiencies (§I, §IV). It
keeps, on the device, a flight record over a fixed element universe E:

* ``cov``   [.., N, E] — 0/1: node n holds element e;
* ``birth`` [.., N, E] — round of first coverage (−1: not covered, or held
  from the start through ``x0``);
* ``src``   [.., N, E] — the node e first came from (its own id for a local
  op and for the initial state);
* ``hop``   [.., N, E] — path length at first coverage (0 at the origin);
* ``edge_first`` — first round e reached n through receive slot q (−1:
  never); the carry keeps it slot-major [P, .., N, E], the port's layout
  for per-slot arrays, and :class:`ProvenanceResult` shows the JAX
  package's [.., N, P, E];
* ``waste_bp`` / ``waste_cp`` [.., N, E] — redundant deliveries of e at n,
  by cause:

  - **back-propagation** (``bp``): the sender first obtained e from this
    very receiver (``src[sender, e] == receiver``) and ships it back — what
    BP's origin tags remove;
  - **concurrent path** (``cp``): every other redundant delivery — e
    reached the receiver over another path first — what RR's Δ-extraction
    attacks.

  Every redundant delivery (telemetry's ``recv − novel``) falls in exactly
  one bucket, so ``waste_bp + waste_cp`` accounts for all of it.

The universe: a lattice whose state is one dense tensor indexes elements
by its universe slot (``irreducible_mask`` / ``novel_mask``); a bit-packed
state (``kernel_kind == "bitor"``, int32 bit-views) unpacks to bits, E =
32·words (``ProvenanceSpec(universe=...)`` trims the padding bits). Tuple
states have no flat element axis and are refused.

``alg`` is duck-typed (``lattice``, ``topo``, ``lead``, ``device``); this
module imports nothing of ``repro_torch.sync``. The replay reads the
engines' masked inbox (``round_step(..., want_inbox=True)``), which every
engine gives bit-identically, so every provenance channel is the same on
every engine. With ``provenance=None`` the round loop queues nothing
extra. The end-of-run matrices stay on the run's device (as
``SimResult.final_x`` does); the per-round channels come to the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ProvenanceSpec:
    """Which provenance groups to compute. Coverage lineage (``cov``,
    ``birth``, ``src``, ``hop``) is always on. ``edges`` toggles the
    per-edge first-delivery matrix, ``waste`` the per-cause tallies (one
    gather of ``src`` and two mask passes a slot); a disabled group keeps
    its carry leaves but skips their work.

    ``universe`` sets E for bit-packed states (32·words bits otherwise);
    for dense states it must equal the universe axis, or be None."""

    edges: bool = True
    waste: bool = True
    universe: Optional[int] = None

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


class ProvenanceCarry(NamedTuple):
    cov: torch.Tensor         # int32 [.., N, E] 0/1
    birth: torch.Tensor       # int32 [.., N, E] first-coverage round (−1)
    src: torch.Tensor         # int32 [.., N, E] first-coverage source node
    hop: torch.Tensor         # int32 [.., N, E] hops at first coverage (−1)
    edge_first: torch.Tensor  # int32 [P, .., N, E] first delivery round
    waste_bp: torch.Tensor    # int32 [.., N, E] back-propagation waste
    waste_cp: torch.Tensor    # int32 [.., N, E] concurrent-path waste


class ProvChannels(NamedTuple):
    """One round's provenance channels, each int32 [(B,) N]."""

    waste_bp: torch.Tensor    # this round's back-propagated redundancy
    waste_cp: torch.Tensor    # this round's concurrent-path redundancy
    covered: torch.Tensor     # elements covered at round end


def element_universe(lattice, universe: Optional[int] = None) -> int:
    """The element-universe width E of ``lattice`` (module docstring),
    checking the optional ``ProvenanceSpec.universe``."""
    bot = lattice.bottom("meta")
    if isinstance(bot, (tuple, list)):
        raise ValueError(
            f"provenance needs a single dense state array, but lattice "
            f"{lattice.name!r} has a tuple state (lex pair / product / "
            f"linear sum) — there is no flat element universe to index "
            f"lineage over")
    if getattr(lattice, "kernel_kind", None) == "bitor":
        e = int(bot.shape[-1]) * 32
        if universe is not None:
            if not 0 < universe <= e:
                raise ValueError(
                    f"ProvenanceSpec.universe={universe} out of range for "
                    f"a {bot.shape[-1]}-word bit-packed state (max {e})")
            return universe
        return e
    e = int(bot.shape[-1])
    if universe is not None and universe != e:
        raise ValueError(
            f"ProvenanceSpec.universe={universe} does not match the dense "
            f"universe axis {e} of lattice {lattice.name!r} — omit it "
            f"(it only trims bit-packed states)")
    return e


def _unpack_bits(words: torch.Tensor, universe: int) -> torch.Tensor:
    """int32 bit-views [..., W] -> bool [..., universe], little-endian.
    ``(w >> k) & 1`` is bit k even where int32 ``>>`` sign-extends (the
    extension fills only bits above 31 − k)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :universe] \
        .to(torch.bool)


def _elem_mask(lattice, v, e: int) -> torch.Tensor:
    """bool [.., E]: the elements a state or δ covers."""
    if getattr(lattice, "kernel_kind", None) == "bitor":
        return _unpack_bits(v, e)
    return lattice.irreducible_mask(v)


def _novel_elem_mask(lattice, d, x, e: int) -> torch.Tensor:
    """bool [.., E]: the elements of d novel against x (value-level for
    max lattices: a covered slot receiving a strictly larger value is
    novel, as telemetry counts it)."""
    if getattr(lattice, "kernel_kind", None) == "bitor":
        return _unpack_bits(torch.bitwise_and(d, torch.bitwise_not(x)), e)
    return lattice.novel_mask(d, x)


def _node_ids(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)[:, None]


def init_carry(spec: ProvenanceSpec, alg, x0=None) -> ProvenanceCarry:
    """A fresh carry; ``x0`` (the run's initial states [.., N, U]) seeds
    coverage held from the start: birth −1, src its own node, hop 0 — a
    joining replica's initial state counts as native, so its resync
    deliveries attribute as concurrent-path, never back-propagation.
    Every leaf is its own tensor."""
    lat = alg.lattice
    e = element_universe(lat, spec.universe)
    n, p = alg.topo.num_nodes, alg.topo.max_degree
    shape = tuple(alg.lead) + (e,)
    dev = alg.device

    def full(v, sh=shape):
        return torch.full(sh, v, dtype=torch.int32, device=dev)

    cov, src, hop = full(0), full(-1), full(-1)
    if x0 is not None:
        m = _elem_mask(lat, x0, e)
        cov = m.to(torch.int32)
        src = torch.where(m, _node_ids(n, dev), src)
        hop = torch.where(m, src.new_zeros(()), hop)
    return ProvenanceCarry(cov=cov, birth=full(-1), src=src, hop=hop,
                           edge_first=full(-1, (p,) + shape),
                           waste_bp=full(0), waste_cp=full(0))


def round_update(spec: ProvenanceSpec, alg, prov: ProvenanceCarry,
                 x_before, op_delta, inbox, t: int):
    """Replay one round's provenance from the gated op δ and the engines'
    masked inbox (slot-major [P, .., N, ...U]: the per-slot values the
    receive joined, ⊥ where topology padding or a fault suppressed them).

    The order is the round's: (a) the op births its irreducibles locally;
    (b) the P slots replay in slot order against the RUNNING state (the
    novelty of telemetry and the kernels' ``cnt``). Attribution reads the
    senders' ``src``/``hop`` as they stood after the op phase: a node
    sends after its own op and before any receive, so this round's
    receives elsewhere cannot change what it shipped. The carry is
    updated in place (the round loop owns it). Returns
    ``(ProvenanceCarry, ProvChannels)``."""
    lat, topo = alg.lattice, alg.topo
    p = topo.max_degree
    e = prov.cov.shape[-1]
    cov, birth, src, hop, edge_first, waste_bp, waste_cp = prov
    ids = _node_ids(topo.num_nodes, cov.device)               # [N, 1]

    # (a) op phase: local births (op_delta is gated: a down node and a
    # quiet round birth nothing)
    new = _elem_mask(lat, op_delta, e) & (cov == 0)
    cov.masked_fill_(new, 1)
    birth.masked_fill_(new, t)
    src.copy_(torch.where(new, ids, src))
    hop.masked_fill_(new, 0)
    x_run = lat.join(x_before, op_delta)

    # the senders' lineage as it stood when they sent
    src_op, hop_op = src.clone(), hop.clone()
    round_bp = torch.zeros_like(waste_bp)
    round_cp = torch.zeros_like(waste_cp)
    for q in range(p):
        d = inbox[q]                                          # [.., N, ..U]
        recv_m = _elem_mask(lat, d, e)
        nbr_q = topo.nbrs[:, q].long()
        if spec.waste:
            red = recv_m & ~_novel_elem_mask(lat, d, x_run, e)
            isbp = red & (src_op.index_select(-2, nbr_q) == ids)
            round_bp += isbp
            round_cp += red & ~isbp
        if spec.edges:
            ef_q = edge_first[q]
            ef_q.masked_fill_(recv_m & (ef_q < 0), t)
        newly = recv_m & (cov == 0)
        cov.masked_fill_(newly, 1)
        birth.masked_fill_(newly, t)
        src.copy_(torch.where(newly, nbr_q.to(torch.int32)[:, None], src))
        hop.copy_(torch.where(newly, hop_op.index_select(-2, nbr_q) + 1, hop))
        x_run = lat.join(x_run, d)
    waste_bp += round_bp
    waste_cp += round_cp
    return prov, ProvChannels(
        waste_bp=round_bp.sum(-1, dtype=torch.int32),
        waste_cp=round_cp.sum(-1, dtype=torch.int32),
        covered=cov.sum(-1, dtype=torch.int32))


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


class ProvenanceResult(NamedTuple):
    """Provenance views. Matrix fields are end-of-run ([(B,) N, E] /
    [(B,) N, P, E]) tensors on the run's device (:meth:`numpy` brings them
    to the host); channel fields are per-round numpy arrays ([T, N], or
    [B, T, N] for sweeps and stores)."""

    cov: object
    birth: object
    src: object
    hop: object
    edge_first: object
    waste_bp_elems: object
    waste_cp_elems: object
    waste_bp: np.ndarray     # per round, per node
    waste_cp: np.ndarray
    covered: np.ndarray
    nbrs: np.ndarray         # [N, P] the topology table (edge_first's names)
    spec: ProvenanceSpec

    @property
    def batch(self) -> Optional[int]:
        return int(self.cov.shape[0]) if self.cov.ndim == 3 else None

    def cell(self, b: int) -> "ProvenanceResult":
        if self.batch is None:
            raise ValueError("not a batched provenance result")
        return ProvenanceResult(*(a[b] for a in self[:10]),
                                nbrs=self.nbrs, spec=self.spec)

    def take_lead(self, b: int) -> "ProvenanceResult":
        """The first ``b`` entries of the batch axis."""
        if self.batch is None:
            raise ValueError("not a batched provenance result")
        return ProvenanceResult(*(a[:b] for a in self[:10]),
                                nbrs=self.nbrs, spec=self.spec)

    @classmethod
    def cat(cls, parts, device) -> "ProvenanceResult":
        """Batched results of consecutive blocks of the batch axis as one:
        the matrices (tensors) gathered on ``device``, the host channels
        concatenated, ``nbrs`` and the spec shared."""

        def cat(f):
            vals = [getattr(p, f) for p in parts]
            if isinstance(vals[0], torch.Tensor):
                return torch.cat([v.to(device) for v in vals])
            return np.concatenate(vals)

        return cls(**{f: cat(f) for f in cls._fields
                      if f not in ("nbrs", "spec")},
                   nbrs=parts[0].nbrs, spec=parts[0].spec)

    def numpy(self) -> "ProvenanceResult":
        """The same result with every matrix a host numpy array."""
        return ProvenanceResult(*(_np(a) for a in self[:7]), *self[7:])

    def _single(self, what: str):
        if self.batch is not None:
            raise ValueError(
                f"{what} is a single-run view — pass .cell(b) for one "
                f"cell of a batched provenance result")

    def waste_by_cause(self):
        """Redundant deliveries by cause: ``{"backprop": int,
        "concurrent": int}`` (arrays [B] batched); the two partition
        telemetry's ``redundant_elems``."""
        ax = (-2, -1)
        bp = self.waste_bp.astype(np.int64).sum(axis=ax)
        cp = self.waste_cp.astype(np.int64).sum(axis=ax)
        return {"backprop": int(bp) if bp.ndim == 0 else bp,
                "concurrent": int(cp) if cp.ndim == 0 else cp}

    @property
    def total_waste(self):
        w = self.waste_by_cause()
        return w["backprop"] + w["concurrent"]

    def attributed_fraction(self, tele) -> float:
        """The share of ``tele.redundant_elems`` (a ``TelemetryResult`` of
        the same run) attributed to a cause: 1.0 by construction."""
        red = float(tele.redundant_elems.astype(np.int64).sum())
        if red == 0:
            return 1.0
        return float(np.asarray(self.total_waste, np.float64).sum()) / red

    def lineage(self, e: int) -> dict:
        """Element ``e``'s flight record: origins, per covered node its
        birth round, source and hop count, the first-delivery edges and
        the full-coverage round (−1: never)."""
        self._single("lineage")
        cov, birth, src, hop = (_np(a[:, e]) for a in self[:4])
        covered = cov != 0
        nodes = [{"node": int(nd), "birth": int(birth[nd]),
                  "src": int(src[nd]), "hop": int(hop[nd])}
                 for nd in np.nonzero(covered)[0]]
        origins = [r["node"] for r in nodes if r["src"] == r["node"]]
        edges = []
        if self.spec.edges:
            ef = _np(self.edge_first[:, :, e])
            for nd in range(ef.shape[0]):
                for q in range(ef.shape[1]):
                    r = int(ef[nd, q])
                    if r >= 0:
                        edges.append({"dst": nd,
                                      "src": int(self.nbrs[nd, q]),
                                      "round": r})
        full = int(birth.max()) if covered.all() else -1
        return {"element": int(e), "origins": origins, "nodes": nodes,
                "edges": edges, "full_coverage_round": full}

    def time_to_full_coverage(self) -> np.ndarray:
        """[E] the round the LAST node obtained each element (−1: never
        everywhere)."""
        self._single("time_to_full_coverage")
        cov, birth = _np(self.cov), _np(self.birth)
        full = (cov != 0).all(axis=0)
        return np.where(full, birth.max(axis=0), -1).astype(np.int32)


def collect(spec: ProvenanceSpec, carry: ProvenanceCarry, channels, nbrs,
            batched: bool) -> ProvenanceResult:
    """The final carry and the time-major host channels ([T, (B,) N]) as
    a :class:`ProvenanceResult`, after the overflow check (tallies are
    counts: a negative one means an accumulator wrapped)."""
    chans = [np.ascontiguousarray(a.swapaxes(0, 1) if batched else a)
             for a in channels]
    for name, a in zip(ProvChannels._fields, chans):
        if (a < 0).any():
            raise OverflowError(
                f"provenance counter {name!r} overflowed its accumulator "
                f"(negative tallies)")
    m = carry._replace(edge_first=carry.edge_first.movedim(0, -2))
    return ProvenanceResult(*m, *chans, nbrs=_np(nbrs), spec=spec)
