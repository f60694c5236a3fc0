"""Sync-round engine dispatch: the reference torch loop or the CUDA kernels.

Counterpart of ``repro.sync.engine``. Three engines execute one round, all
bit-identical in final states, buffers and metrics:

* ``reference`` — the per-slot torch loop in ``SyncAlgorithm.round_step``;
* ``fused``     — the receive phase as one ``round_recv`` launch and the BP
  leave-one-out sends as one ``buffer_fold`` launch;
* ``mega``      — the whole round (local join, buffering, sends, clear,
  routing, receive) as one ``round_step`` launch.

Fault masks fold into the kernels' inputs: ``active`` = topology padding ∧
delivery, ``delivered`` gates ``round_step``'s buffer clear. The resync
modes (``state_driven``/``digest_driven``) take the per-phase kernels on
both kernel engines, ``mega`` included: ``digest_blocks`` and
``masked_extract`` for the digest exchange, ``merkle_descent`` for its
price, one ``round_recv`` for the receive.

Batched rounds (sweeps, the keyed store) come here over the rows of the
tiled topology: the kernels see R = B·N rows, which is the JAX package's
``rows`` layout, and ``round_step`` the B configs as its ``nb`` axis (its
routing crosses a config's nodes). The JAX package's "grid" layout (a
grid axis per config) has no counterpart: every batch runs as rows.

Dispatch is by ``Lattice.kernel_kind``: lattices without a dense kernel kind
fall back to ``reference``. The kernel engines' epilogues (the classic/bp
keep-gated buffer merge, the metric sums) are plain torch, as they are plain
jnp in the JAX package.
"""

from __future__ import annotations

import torch

from repro_torch.core.lattice import tree_map
from repro_torch.kernels import ops as kops
from repro_torch.kernels._build import join_fn

ENGINES = ("reference", "fused", "mega")
KERNEL_ENGINES = ("fused", "mega")
FUSED_KINDS = ("max", "bitor")


def supports_fused(lattice) -> bool:
    """A lattice runs fused/mega iff it has a dense kernel kind."""
    return getattr(lattice, "kernel_kind", None) in FUSED_KINDS


def resolve(engine: str, lattice) -> str:
    """Validate ``engine`` and apply the automatic reference fallback."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    if engine in KERNEL_ENGINES and not supports_fused(lattice):
        return "reference"
    return engine


def gather_inbox(d_all, topo):
    """Route per-edge messages: inbox[q, n] = d_all[rev[n, q], nbrs[n, q]]
    — the [P, R, U] sends to the [P, R, U] inbox ``round_recv`` takes, in
    one gather (R: the nodes, or a batch's rows over the tiled topology).
    Padding slots carry their copy's node 0's sends; the kernel's active
    mask suppresses them. Indexing a broadcast view may lay the result out
    in another order, and the kernel takes it contiguous. A tuple state
    (reference engine only) is gathered leaf by leaf."""
    rev, nbrs = topo.routes
    return tree_map(lambda a: a[rev, nbrs].contiguous(), d_all)


def fold_slots(stack, kind: str):
    """⊔ over the leading slot axis."""
    join = join_fn(kind)
    acc = stack[0]
    for q in range(1, stack.shape[0]):
        acc = join(acc, stack[q])
    return acc


def fused_loo_sends(buf, kind: str):
    """All P leave-one-out sends from the origin-indexed buffer [P+1, R, U]
    in one ``buffer_fold`` launch. Returns [P, R, U]."""
    return kops.buffer_fold(buf, kind=kind)


def fused_receive(algo, x, buf, buf_elems, cpu, inbox, faults=None,
                  want_recv: bool = False, want_inbox: bool = False):
    """Algorithm 2 lines 14-17 for all P slots in one ``round_recv`` launch,
    on the routed inbox [P, R, U] (:func:`gather_inbox`).

    The kernel counts each slot's novel irreducibles ``cnt`` against the
    RUNNING state, so the reference loop's reductions become scalar tests:
    ¬(d ⊑ x) ⇔ cnt > 0 and Δ(d, x) = ⊥ ⇔ cnt = 0. RR buffers take the
    extractions (⊥ wherever not novel); classic/BP buffers take the whole
    δ-group where it inflated x, joined into what the clear left (under
    faults a retained buffer keeps its entries). Fault masks fold into the
    kernel's active-slot input, so a dropped slot adds nothing to x, the
    counts or the buffers. ``buf`` is this round's cleared buffer (a fresh
    tensor), so it is updated in place. Returns
    ``(x, buf, buf_elems, cpu, recv, inbox)``: ``recv`` the telemetry
    ``(recv, novel)`` per-row int32 tallies summed from the kernel's
    ``dsz``/``cnt`` when ``want_recv`` (else None), ``inbox`` the
    active-masked inbox [P, R, U] — what the slot-order fold consumed, ⊥
    where a slot was suppressed — when ``want_inbox`` (the provenance
    replay; else None). The launch is the same either way."""
    lat = algo.lattice
    kind = lat.kernel_kind
    p = algo.topo.max_degree
    valid = algo.recv_valid(faults)
    x, stored, _, cnt, dsz = kops.round_recv(
        inbox, x, kind=kind, active=valid, emit_stored=algo.extracts)
    recv = (dsz.sum(-1, dtype=torch.int32),
            cnt.sum(-1, dtype=torch.int32)) if want_recv else None
    mib = torch.where(valid.T[..., None], inbox, inbox.new_zeros(())) \
        if want_inbox else None
    cpu = cpu + algo.msum(dsz.T)
    if not algo.has_buffer:                              # state-based
        return x, buf, buf_elems, cpu, recv, mib
    if algo.extracts:                                    # rr / bprr
        ssz = cnt
        slot_vals = stored                               # [P, N, U]
    else:                                                # classic / bp
        keep = cnt > 0                                   # ¬(d ⊑ x_running)
        ssz = dsz * keep
        slot_vals = torch.where(keep.T[..., None], inbox,
                                inbox.new_zeros(()))
    if algo.per_origin:                                  # in place: no copy
        join_fn(kind)(buf[:p], slot_vals, out=buf[:p])   # of the buffer
    else:
        buf = lat.join(buf, fold_slots(slot_vals, kind))
    cpu = cpu + algo.msum(ssz.T)
    buf_elems = buf_elems + ssz.sum(-1, dtype=torch.int32)
    return x, buf, buf_elems, cpu, recv, mib


def mega_round(algo, x, buf, buf_elems, op_delta, faults=None,
               want_recv: bool = False, want_inbox: bool = False):
    """Phases (1)-(4) of one round through one ``round_step`` launch.

    Returns ``(x, buf, buf_elems, tx, cpu, state_elems, recv, inbox)``,
    bit-identical to the reference phases: the kernel emits every count
    the metrics need as exact int32 per-(node, slot) tallies, and this
    epilogue sums them in the reference order. The carry's R rows go in
    as the kernel's
    [B, N, U] configs (B = 1 for a single run) and the buffer as a
    [K, B, N, U] view of the carry's layout (no copy). Faults enter as the
    kernel's ``active`` (delivery) and ``delivered`` (ack-gated clear)
    inputs; the epilogue's ``buf_elems`` follows the same retention.
    Classic/BP's keep-gated merge reduces over the whole universe
    (¬(d ⊑ x) ⇔ cnt > 0), so it runs here on the kernel's masked inbox,
    joined in place into the kernel's fresh buffer output. ``recv`` is
    the telemetry ``(recv, novel)`` per-row pair summed from the kernel's
    ``dsz``/``cnt`` when ``want_recv`` (else None); ``want_inbox`` makes
    the kernel emit the masked inbox for every flavour (state, rr and bprr
    do not need it themselves) and returns it as [P, R, U] for the
    provenance replay (else None).
    """
    lat, topo = algo.lattice, algo.topo
    kind = lat.kernel_kind
    p = topo.max_degree
    cfg = (algo.batch or 1, topo.num_nodes)              # the kernel's [B, N]
    rows = x.shape[0]
    u = x.shape[-1]
    dlv = algo.delivered(faults)                         # None: all clear
    if not algo.has_buffer:
        bv = dlv_in = None
    else:
        bv = (buf if algo.per_origin else buf[None]).reshape(
            (-1,) + cfg + (u,))
        dlv_in = (torch.ones(cfg, dtype=torch.int32, device=x.device)
                  if dlv is None else dlv.to(torch.int32).reshape(cfg))
    active = algo.recv_valid(faults).to(torch.int32).reshape(cfg + (p,))
    xo, bo, inbox, dsz_op, xsz, ssend, cnt, dsz = kops.sync_round(
        op_delta.reshape(cfg + (u,)), x.reshape(cfg + (u,)), bv, active, dlv_in,
        nbrs=topo.nbrs, rev=topo.rev, kind=kind, per_origin=algo.per_origin,
        extracts=algo.extracts, want_inbox=want_inbox)
    xo = xo.reshape(rows, u)
    dsz_op, xsz = dsz_op.reshape(rows), xsz.reshape(rows)
    ssend, cnt, dsz = (a.reshape(rows, p) for a in (ssend, cnt, dsz))
    recv = (dsz.sum(-1, dtype=torch.int32),
            cnt.sum(-1, dtype=torch.int32)) if want_recv else None
    mib = inbox.reshape(p, rows, u) if want_inbox else None
    # metric arithmetic in the reference round_step's order
    cpu = algo.msum(dsz_op)                              # (1) local update
    tx = algo.msum((ssend * algo.send_live(faults)).T)   # (2) sends
    cpu = cpu + tx
    cpu = cpu + algo.msum(dsz.T)                         # (4) receive
    if not algo.has_buffer:
        return xo, buf, buf_elems, tx, cpu, xsz, recv, mib
    # (3) the ack-gated clear ran in the kernel; its entry counts follow
    buf_elems = torch.zeros_like(buf_elems) if dlv is None \
        else torch.where(dlv, 0, buf_elems + dsz_op)
    buf = bo.reshape(-1, rows, u)
    if not algo.per_origin:
        buf = buf[0]
    if algo.extracts:                                    # rr / bprr: in-kernel
        ssz = cnt
    else:                                                # classic / bp
        keep = cnt > 0
        ssz = dsz * keep
        slot_vals = torch.where(keep.T[..., None], inbox.reshape(p, rows, u), 0)
        if algo.per_origin:
            buf[:p] = lat.join(buf[:p], slot_vals)
        else:
            buf = lat.join(buf, fold_slots(slot_vals, kind))
    cpu = cpu + algo.msum(ssz.T)
    buf_elems = buf_elems + ssz.sum(-1, dtype=torch.int32)
    return xo, buf, buf_elems, tx, cpu, xsz, recv, mib


def fused_join_inbox(algo, x, inbox, want_novel: bool = False):
    """Resync receive: fold all P pre-masked inbox slots [P, R, U] into x
    in one ``round_recv`` launch (no extractions). With ``want_novel``
    (telemetry) also returns the kernel's per-slot novelty counts summed
    per row, as ``(x, novel)``."""
    xo, _, _, cnt, _ = kops.round_recv(inbox, x,
                                       kind=algo.lattice.kernel_kind,
                                       emit_stored=False)
    if want_novel:
        return xo, cnt.sum(-1, dtype=torch.int32)
    return xo


def fused_digest(x, spec, kind: str):
    """Blockwise digest [R, nB, 3] of the states in one ``digest_blocks``
    launch; bit-identical to ``sync.digest.digest_state``."""
    return kops.digest_blocks(x, block_elems=spec.block_elems, kind=kind)


def fused_descent(local_dig, src):
    """The Merkle-descent words of every digest message, [R, nB, 3]
    digests routed by ``src`` [P, R] -> [P, R], in one ``merkle_descent``
    call; bit-identical to ``sync.digest.routed_descent_words``."""
    return kops.merkle_descent(local_dig, src)


def fused_extract(x, block_masks, spec):
    """Δ(state, block mask) for all P slots, [P, R, nB] masks -> [P, R, U]
    sends, in one ``masked_extract`` launch (the state is read once)."""
    return kops.masked_extract(x, block_masks, block_elems=spec.block_elems)
