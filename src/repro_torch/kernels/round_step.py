"""One whole synchronous round of Algorithms 1/2 in one launch.

CUDA kernel ``csrc/round_step.cu`` (replacing the TPU megakernel
``round_step_2d`` in ``src/repro/kernels/round_step.py``) and its plain
PyTorch version, with the same contract: local join, sends (broadcast or
leave-one-out fold), ack-gated clear, routing by the topology's
``nbrs``/``rev`` tables, the P-slot receive in slot order, and optionally
the RR Δ-merge and the masked inbox.

A CUDA block runs the round for 32 universe columns of one config, one
thread per (column, node), with the columns' working set in shared memory:
``(1 + K + S)·N`` values per column (x, the K buffer slots, the S sends —
S = P for the per-origin fold, else 1). :func:`smem_bytes` sizes it; a
round whose working set does not fit the card's 227 KB raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.buffer_fold import plain as fold_plain

launches = 0            # kernel launches since the last reset (CUDA only)
SMEM_LIMIT = 232448     # dynamic shared memory a block may use on sm_90
COLS = 32               # universe columns per block (csrc/round_step.cu)

_SIGNATURE = {"round_step_launch": [
    ctypes.c_int] + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_void_p]}


def table_bytes(n: int, p: int) -> int:
    """Shared int tables: nbrs, rev, active, the three slot counters [N·P]
    each, delivered [N], node counters [N·2]; 16-byte aligned."""
    return -(-4 * (6 * n * p + 3 * n) // 16) * 16


def smem_bytes(n: int, p: int, k: int, per_origin: bool,
               elem_size: int) -> int:
    """Shared memory of one block: the int tables, then (1 + K + S)·N rows
    of COLS values."""
    rows = n * (1 + k + (p if per_origin else 1))
    return table_bytes(n, p) + elem_size * COLS * rows


def block_rows(n: int, p: int, k: int, per_origin: bool,
               elem_size: int) -> int:
    """Node-threads per column of a block (min(N, 32): a block is at most
    1,024 threads; a thread loops over nodes N/32 apart beyond that).
    Raises when the block's working set does not fit in shared memory,
    i.e. when ``(1 + K + S)·N`` exceeds about (227 KB - tables) /
    (32 · element size) — 1,800 values for int32 states, 7,200 for bool."""
    need = smem_bytes(n, p, k, per_origin, elem_size)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"round_step: {n} nodes x (1 + {k} slots + sends) of "
            f"{elem_size}-byte values need {need} bytes of shared memory "
            f"per block; a block has {SMEM_LIMIT}")
    return min(n, 32)


def plain(delta, x, buf, active, delivered, nbrs, rev, kind: str = "max",
          per_origin: bool = False, extracts: bool = False,
          emit_inbox: bool = False):
    """Plain version on the canonical operands of :func:`round_step`."""
    join = B.join_fn(kind)
    p = nbrs.shape[-1]

    def size(v):
        return B.count(v, kind).sum(-1, dtype=torch.int32)

    dsz_op = size(delta)
    x = join(x, delta)
    slots = None
    if buf is None:
        sends = [x] * p
    else:
        slots = list(buf.unbind(0))
        me = len(slots) - 1 if per_origin else 0
        slots[me] = join(slots[me], delta)
        sends = list(fold_plain(torch.stack(slots), kind).unbind(0)) \
            if per_origin else [slots[0]] * p
        clear = (delivered != 0)[..., None]
        slots = [torch.where(clear, 0, s) for s in slots]
    ssend = torch.stack([size(s) for s in sends], -1)
    by_slot = torch.stack(sends, 2)                       # [B, N, S, U]
    inbox, cnt, dsz = [], [], []
    for q in range(p):
        d = by_slot[:, nbrs[:, q].long(), rev[:, q].long()]   # [B, N, U]
        d = torch.where(active[:, :, q, None] != 0, d, 0)
        s, c = B.novel(d, x, kind)
        cnt.append(c.sum(-1, dtype=torch.int32))
        dsz.append(size(d))
        inbox.append(d)
        x = join(x, d)
        if extracts:
            t = q if per_origin else 0
            slots[t] = join(slots[t], s)
    return (x, None if slots is None else torch.stack(slots),
            torch.stack(inbox) if emit_inbox else None, dsz_op, size(x),
            ssend, torch.stack(cnt, -1), torch.stack(dsz, -1))


def _launch(delta, x, buf, active, delivered, nbrs, rev, kind, per_origin,
            extracts, emit_inbox):
    global launches
    B.check_cuda("round_step", delta, x, buf, active, delivered, nbrs, rev)
    nb, n, u = x.shape
    p = nbrs.shape[-1]
    k = 0 if buf is None else buf.shape[0]
    if nb > 65535:
        raise ValueError(f"round_step: {nb} configs; the kernel takes <= 65535")
    bo = None if buf is None else torch.empty_like(buf)
    dev = x.device
    xo = torch.empty_like(x)
    inbox = torch.empty((p, nb, n, u), dtype=x.dtype, device=dev) \
        if emit_inbox else None
    nodecnt = torch.zeros((nb, n, 2), dtype=torch.int32, device=dev)
    ssend, cnt, dsz = (torch.zeros((nb, n, p), dtype=torch.int32, device=dev)
                       for _ in range(3))
    rows = block_rows(n, p, k, per_origin, x.element_size())
    lib = B.library("round_step", _SIGNATURE)
    err = lib.round_step_launch(
        B.KIND_CODES[(kind, x.dtype)], B.ptr(delta), B.ptr(x), B.ptr(buf),
        B.ptr(active), B.ptr(delivered), B.ptr(nbrs), B.ptr(rev), B.ptr(xo),
        B.ptr(bo), B.ptr(inbox), B.ptr(nodecnt), B.ptr(ssend), B.ptr(cnt),
        B.ptr(dsz), nb, n, p, k, int(per_origin), int(extracts), u, rows,
        table_bytes(n, p),
        smem_bytes(n, p, k, per_origin, x.element_size()),
        B.stream_handle())
    B.check_launch(lib, err, "round_step")
    launches += 1
    return xo, bo, inbox, nodecnt[..., 0], nodecnt[..., 1], ssend, cnt, dsz


def round_step(delta, x, buf, active, delivered, nbrs, rev, *,
               kind: str = "max", per_origin: bool = False,
               extracts: bool = False, emit_inbox: bool = False):
    """One whole round on canonical operands:

    * ``delta``/``x``: [B, N, U] (B = 1 for a single run);
    * ``buf``: [K, B, N, U] slot-major buffer (K = P+1 per-origin, 1 flat)
      or None for state-based sync; ``delivered`` int32 [B, N] (clear
      where != 0), required with a buffer;
    * ``active`` int32 [B, N, P]; ``nbrs``/``rev`` int32 [N, P].

    Returns ``(x', buf', inbox, dsz_op, xsz, ssend, cnt, dsz)``: buf'
    (None without a buffer), inbox [P, B, N, U] the
    active-masked received δ-groups (None unless ``emit_inbox``),
    ``dsz_op``/``xsz`` int32 [B, N] (|⇓δ|, |⇓x'|), and int32 [B, N, P]
    send sizes (before liveness masking), novel and received counts. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    (every operand contiguous) or raises.
    """
    nb, n, u = x.shape
    p = nbrs.shape[-1]
    if tuple(delta.shape) != (nb, n, u) or delta.dtype != x.dtype:
        raise ValueError("round_step: delta must match x in shape and dtype")
    if tuple(active.shape) != (nb, n, p) or tuple(rev.shape) != (n, p):
        raise ValueError("round_step: active [B, N, P] and rev [N, P] "
                         "must match x and nbrs")
    if buf is not None:
        if tuple(buf.shape[1:]) != (nb, n, u) or buf.dtype != x.dtype:
            raise ValueError("round_step: buf must be [K, B, N, U] of x's dtype")
        if delivered is None or tuple(delivered.shape) != (nb, n):
            raise ValueError("round_step: a buffer needs delivered [B, N]")
        if per_origin and buf.shape[0] != p + 1:
            raise ValueError("round_step: a per-origin buffer has P+1 slots")
    elif extracts or per_origin:
        raise ValueError("round_step: extracts/per_origin need a buffer")
    dv, xv = B.kernel_view(delta, kind), B.kernel_view(x, kind)
    bv = None if buf is None else B.kernel_view(buf, kind)
    dlv = None if buf is None else delivered.to(torch.int32)
    run = plain if B.is_cpu(xv) else _launch
    xo, bo, ib, dsz_op, xsz, ssend, cnt, dsz = run(
        dv, xv, bv, active.to(torch.int32), dlv, nbrs, rev, kind,
        per_origin, extracts, emit_inbox)
    return (B.restore(xo, x.dtype), B.restore(bo, x.dtype),
            B.restore(ib, x.dtype), dsz_op, xsz, ssend, cnt, dsz)
