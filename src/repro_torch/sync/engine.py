"""Sync-round engine dispatch: the reference torch loop or the CUDA kernels.

Counterpart of ``repro.sync.engine``. Three engines execute one round, all
bit-identical in final states, buffers and metrics:

* ``reference`` — the per-slot torch loop in ``SyncAlgorithm.round_step``;
* ``fused``     — the receive phase as one ``round_recv`` launch and the BP
  leave-one-out sends as one ``buffer_fold`` launch;
* ``mega``      — the whole round (local join, buffering, sends, clear,
  routing, receive) as one ``round_step`` launch.

Dispatch is by ``Lattice.kernel_kind``: lattices without a dense kernel kind
fall back to ``reference``. The kernel engines' epilogues (the classic/bp
keep-gated buffer merge, the metric sums) are plain torch, as they are plain
jnp in the JAX package.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops

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
    — the [P, N, U] sends to the [P, N, U] inbox ``round_recv`` takes, in
    one gather. Padding slots carry node 0's sends; the kernel's active
    mask suppresses them. Indexing a broadcast view may lay the result out
    in another order, and the kernel takes it contiguous."""
    return d_all[topo.rev.T.long(), topo.nbrs.T.long()].contiguous()


def fold_slots(stack, kind: str):
    """⊔ over the leading slot axis."""
    join = torch.bitwise_or if kind == "bitor" else torch.maximum
    acc = stack[0]
    for q in range(1, stack.shape[0]):
        acc = join(acc, stack[q])
    return acc


def fused_loo_sends(buf, kind: str):
    """All P leave-one-out sends from the origin-indexed buffer [P+1, N, U]
    in one ``buffer_fold`` launch. Returns [P, N, U]."""
    return kops.buffer_fold(buf, kind=kind)


def fused_receive(algo, x, buf, buf_elems, cpu, d_all):
    """Algorithm 2 lines 14-17 for all P slots in one ``round_recv`` launch.

    The kernel counts each slot's novel irreducibles ``cnt`` against the
    RUNNING state, so the reference loop's reductions become scalar tests:
    ¬(d ⊑ x) ⇔ cnt > 0 and Δ(d, x) = ⊥ ⇔ cnt = 0. RR buffers take the
    extractions (⊥ wherever not novel); classic/BP buffers take the whole
    δ-group where it inflated x. ``buf`` is the freshly cleared buffer of
    this round, so it is updated in place. Returns
    ``(x, buf, buf_elems, cpu)``."""
    lat, topo, acc = algo.lattice, algo.topo, algo.metric_dtype
    kind = lat.kernel_kind
    p = topo.max_degree
    inbox = gather_inbox(d_all, topo)                    # [P, N, U]
    x, stored, _, cnt, dsz = kops.round_recv(
        inbox, x, kind=kind, active=algo.active[0],
        emit_stored=algo.extracts)
    cpu = cpu + algo.msum(dsz, acc)
    if not algo.has_buffer:                              # state-based
        return x, buf, buf_elems, cpu
    if algo.extracts:                                    # rr / bprr
        ssz = cnt
        slot_vals = stored                               # [P, N, U]
    else:                                                # classic / bp
        keep = cnt > 0                                   # ¬(d ⊑ x_running)
        ssz = dsz * keep
        slot_vals = torch.where(keep.T[..., None], inbox, 0)
    if algo.per_origin:
        buf[:p] = lat.join(buf[:p], slot_vals)
    else:
        buf = lat.join(buf, fold_slots(slot_vals, kind))
    cpu = cpu + algo.msum(ssz, acc)
    buf_elems = buf_elems + ssz.sum(-1, dtype=torch.int32)
    return x, buf, buf_elems, cpu


def mega_round(algo, x, buf, buf_elems, op_delta):
    """Phases (1)-(4) of one round through one ``round_step`` launch.

    Returns ``(x, buf, buf_elems, tx, cpu, state_elems)``, bit-identical to
    the reference phases: the kernel emits every count the metrics need as
    exact int32 per-(node, slot) tallies, and this epilogue sums them in
    the reference order. The buffer goes in and comes out as a
    [K, 1, N, U] view of the carry's layout (no copy). Classic/BP's
    keep-gated merge reduces over the whole universe (¬(d ⊑ x) ⇔ cnt > 0),
    so it runs here on the kernel's masked inbox, in place on the kernel's
    fresh buffer output.
    """
    lat, topo, acc = algo.lattice, algo.topo, algo.metric_dtype
    kind = lat.kernel_kind
    p = topo.max_degree
    if not algo.has_buffer:
        bv = dlv = None
    else:
        bv = buf[:, None] if algo.per_origin else buf[None, None]
        dlv = algo.delivered
    xo, bo, inbox, dsz_op, xsz, ssend, cnt, dsz = kops.sync_round(
        op_delta[None], x[None], bv, algo.active, dlv, nbrs=topo.nbrs,
        rev=topo.rev, kind=kind, per_origin=algo.per_origin,
        extracts=algo.extracts)
    dsz_op, xsz, ssend, cnt, dsz = (a[0] for a in (dsz_op, xsz, ssend, cnt,
                                                    dsz))
    # metric arithmetic in the reference round_step's order
    cpu = algo.msum(dsz_op, acc)                         # (1) local update
    tx = algo.msum(ssend * topo.mask, acc)               # (2) sends
    cpu = cpu + tx
    cpu = cpu + algo.msum(dsz, acc)                      # (4) receive
    if not algo.has_buffer:
        return xo[0], buf, buf_elems, tx, cpu, xsz
    # (3) the fault-free clear empties every buffer; (4) refills it
    buf = bo[:, 0] if algo.per_origin else bo[0, 0]
    if algo.extracts:                                    # rr / bprr: in-kernel
        ssz = cnt
    else:                                                # classic / bp
        keep = cnt > 0
        ssz = dsz * keep
        slot_vals = torch.where(keep.T[..., None], inbox[:, 0], 0)
        if algo.per_origin:
            buf[:p] = lat.join(buf[:p], slot_vals)
        else:
            buf = lat.join(buf, fold_slots(slot_vals, kind))
    cpu = cpu + algo.msum(ssz, acc)
    buf_elems = ssz.sum(-1, dtype=torch.int32)
    return xo[0], buf, buf_elems, tx, cpu, xsz
