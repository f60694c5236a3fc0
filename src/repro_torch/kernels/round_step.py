"""One whole synchronous round of Algorithms 1/2 in one launch.

CUDA kernel ``csrc/round_step.cu`` (replacing the TPU megakernel
``round_step_2d`` in ``src/repro/kernels/round_step.py``) and its plain
PyTorch version, with the same contract: local join, sends (broadcast or
leave-one-out fold), ack-gated clear, routing by the topology's
``nbrs``/``rev`` tables, the P-slot receive in slot order, and optionally
the RR Δ-merge and the masked inbox.

A CUDA block runs the round for a tile of universe columns of one config
with all its node rows; a thread is a (node, lane) pair holding its node's
δ and x in registers, and only the sends go to shared memory. Aligned rows
come in through a ring of Hopper bulk asynchronous copies; :func:`plan`
picks the tile width, the stages and the tallies that fit the card's
227 KB of shared memory, the direct (synchronous) loads where rows are not
16-byte aligned, and raises where nothing fits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.buffer_fold import plain as fold_plain

launches = 0            # kernel launches since the last reset (CUDA only)
last_launch = None      # (Plan, blocks per config) of the last launch
SMEM_LIMIT = 232448     # dynamic shared memory a block may use on sm_90
REG_TALLY_P = 4         # largest P with registers per slot (csrc/round_step.cu)
REG_TALLY_N = 16        # largest N with register tallies (a 512-thread block)
VEC_BYTES = (16, 8, 4)  # int32 lanes' bytes, widest first (uint8: 4)
STAGES = (3, 2)         # bulk plans' ring stages, most first

_SIGNATURE = {"round_step_launch": [
    ctypes.c_int] + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [
    ctypes.c_longlong] + [ctypes.c_int] * 6 + [
    ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]}


class Plan(NamedTuple):
    """A launch of ``csrc/round_step.cu``: ``tile`` universe columns a
    block step, ``vec_bytes`` a lane moves per row (0: direct loads, one
    element), ``stages`` of the bulk-copy ring (0: direct), ``threads`` a
    block, ``reg_tally`` the P bound of register tallies (0: shared
    counters), and the shared memory: int tables, mbarriers, total."""
    tile: int
    vec_bytes: int
    stages: int
    threads: int
    reg_tally: int
    table_bytes: int
    bar_bytes: int
    smem: int

    @property
    def bulk(self) -> bool:
        return self.stages > 0


def table_bytes(n: int, p: int) -> int:
    """Shared int tables: nbrs, rev, active, the three slot counters [N·P]
    each, delivered [N], node counters [N·2]; 16-byte aligned."""
    return -(-4 * (6 * n * p + 3 * n) // 16) * 16


@functools.lru_cache(maxsize=256)
def plan(n: int, p: int, k: int, per_origin: bool, elem_size: int, u: int,
         aligned: bool) -> Plan:
    """The launch plan of one round: N nodes, P slots, K buffer slots,
    ``elem_size``-byte elements, U columns; ``aligned`` when every operand's
    base address is 16-byte aligned.

    Rows of U·elem_size bytes, a multiple of 16, on aligned bases take the
    bulk-copy ring: the widest lane vector (int32: 16, 8, 4 bytes; uint8:
    4, one element a register as for int32) and the most
    stages (3, 2) whose shared memory — the tables, the mbarriers, two
    buffers of the S send rows (S = P for the per-origin fold, else 1) and
    the stages of the (2 + K)·N input rows — fits 227 KB; failing that,
    direct vector loads of the widest lane vector whose sends fit. Other
    rows take direct loads of one element a lane over 32-column tiles.
    Raises where even that does not fit."""
    s = p if per_origin and k else 1
    rows_in = (2 + k) * n
    tables = table_bytes(n, p)
    reg = REG_TALLY_P if n <= REG_TALLY_N and p <= REG_TALLY_P else 0
    threads = 32 * (n if reg else min(n, 32))

    def make(vb, stages):
        row = 32 * (vb or elem_size)                  # bytes of a tile row
        bars = -(-8 * stages // 16) * 16
        smem = tables + bars + (2 * s * n + stages * rows_in) * row
        return Plan(row // elem_size, vb, stages, threads, reg, tables, bars,
                    smem)

    vecs = VEC_BYTES if elem_size == 4 else (4,)
    cands = [make(vb, st) for vb in vecs for st in STAGES] \
        + [make(vb, 0) for vb in vecs] \
        if aligned and (u * elem_size) % 16 == 0 else []
    for pl in cands + [make(0, 0)]:
        if pl.smem <= SMEM_LIMIT:
            return pl
    raise ValueError(
        f"round_step: {n} nodes x {s} send rows of 32 {elem_size}-byte "
        f"values need {make(0, 0).smem} bytes of shared memory per block; a "
        f"block has {SMEM_LIMIT}")


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
            extracts, emit_inbox, pl=None):
    global launches, last_launch
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
    pl = pl or plan(n, p, k, per_origin, x.element_size(), u, all(
        t is None or t.data_ptr() % 16 == 0
        for t in (delta, x, buf, xo, bo, inbox)))
    blocks = ctypes.c_longlong(0)
    lib = B.library("round_step", _SIGNATURE)
    err = lib.round_step_launch(
        B.KIND_CODES[(kind, x.dtype)], B.ptr(delta), B.ptr(x), B.ptr(buf),
        B.ptr(active), B.ptr(delivered), B.ptr(nbrs), B.ptr(rev), B.ptr(xo),
        B.ptr(bo), B.ptr(inbox), B.ptr(nodecnt), B.ptr(ssend), B.ptr(cnt),
        B.ptr(dsz), nb, n, p, k, int(per_origin), int(extracts), u,
        pl.vec_bytes, pl.reg_tally, pl.stages, pl.threads, pl.table_bytes,
        pl.bar_bytes, pl.smem, ctypes.byref(blocks), B.stream_handle())
    B.check_launch(lib, err, "round_step")
    launches += 1
    last_launch = (pl, blocks.value)
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
