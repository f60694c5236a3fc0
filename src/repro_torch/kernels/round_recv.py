"""Slot-order receive of one sync round (Algorithm 2, lines 14-17).

CUDA kernel ``csrc/round_recv.cu`` (replacing the TPU kernel ``round_recv_2d``
in ``src/repro/kernels/round_recv.py``) and its plain PyTorch version, with
the same contract: the P gathered δ-groups fold into the running state in
slot order, and each slot's novel and received irreducibles are counted per
node.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build as B

launches = 0          # kernel launches since the last reset (CUDA only)

_SIGNATURE = {"round_recv_launch": [
    ctypes.c_int] + [ctypes.c_void_p] * 8 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_void_p]}
SHORT_VECS = 32       # rows of at most this many vectors: one lane group a row
MAX_BLOCKS = 1 << 20  # grid cap (short rows' blocks, long rows' gridDim.y);
                      # the kernel grid-strides beyond it


def plain(d, x, active, kind: str = "max", emit_stored: bool = True,
          emit_cov: bool = False):
    """Plain version on d [P, M, U], x [M, U], active int [M, P]."""
    join = B.join_fn(kind)
    stored, cnt, dsz = [], [], []
    cov = torch.zeros(x.shape, dtype=torch.int32, device=x.device) \
        if emit_cov else None
    for q in range(d.shape[0]):
        dq = torch.where(active[:, q, None] != 0, d[q], 0)
        s, c = B.novel(dq, x, kind)
        z = B.count(dq, kind)
        cnt.append(c.sum(-1, dtype=torch.int32))
        dsz.append(z.sum(-1, dtype=torch.int32))
        if emit_cov:
            cov = cov + z
        x = join(x, dq)
        stored.append(s)
    return (x, torch.stack(stored) if emit_stored else None, cov,
            torch.stack(cnt, -1), torch.stack(dsz, -1))


def _launch(d, x, active, kind, emit_stored, emit_cov):
    global launches
    B.check_cuda("round_recv", d, x, active)
    p, m, u = d.shape
    dev = x.device
    xo = torch.empty_like(x)
    stored = torch.empty_like(d) if emit_stored else None
    cov = torch.empty(x.shape, dtype=torch.int32, device=dev) \
        if emit_cov else None
    cnt = torch.zeros((m, p), dtype=torch.int32, device=dev)
    dsz = torch.zeros((m, p), dtype=torch.int32, device=dev)
    lib = B.library("round_recv", _SIGNATURE)
    with B.launching(dev) as stream:
        err = lib.round_recv_launch(
            B.KIND_CODES[(kind, x.dtype)], B.ptr(d), B.ptr(x),
            B.ptr(active), B.ptr(xo), B.ptr(stored), B.ptr(cov), B.ptr(cnt),
            B.ptr(dsz), p, m, u,
            int(vectorized(u, x.element_size(), d, x, xo, stored)),
            MAX_BLOCKS, stream)
    B.check_launch(lib, err, "round_recv")
    launches += 1
    return xo, stored, cov, cnt, dsz


def vectorized(u: int, elem_size: int, *tensors) -> bool:
    """Lanes move 16 bytes: every row is a whole number of 16-byte vectors
    and every base is 16-byte aligned (None skipped)."""
    return (u * elem_size) % 16 == 0 and all(
        t is None or t.data_ptr() % 16 == 0 for t in tensors)


def short_rows(u: int, elem_size: int, vec: bool) -> bool:
    """The kernel's short-row path (a lane group a row): rows of at most
    SHORT_VECS vectors (16 bytes each when ``vec``, else one element)."""
    return (u * elem_size // 16 if vec else u) <= SHORT_VECS


def round_recv(d_stack, x, *, kind: str = "max", active=None,
               emit_stored: bool = True, emit_cov: bool = False):
    """Fused P-slot receive.

    ``d_stack`` [P, ..., U] gathered per-slot δ-groups, ``x`` [..., U]
    states, ``active`` int/bool [..., P] per-(node, slot) mask (None: all
    slots active; 0 suppresses a slot — topology padding). Returns
    ``(x', stored, cov, cnt, dsz)``: x' after joining all P slots in order;
    ``stored`` [P, ..., U] the slot-order extractions Δ(d_q, x_running)
    (None unless ``emit_stored``); ``cov`` int32 [..., U] how many active
    slots delivered each element, per bit for ``bitor`` (None unless
    ``emit_cov``); ``cnt``/``dsz`` int32 [..., P] each slot's novel /
    received irreducibles. The leading axes (a batch's (config, node)
    axes) are the kernel's rows. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises.
    """
    p, lead, u = d_stack.shape[0], tuple(x.shape[:-1]), x.shape[-1]
    if tuple(d_stack.shape) != (p,) + lead + (u,):
        raise ValueError(f"round_recv: d_stack {tuple(d_stack.shape)} does "
                         f"not match x {tuple(x.shape)}")
    m = math.prod(lead)
    dv = B.kernel_view(d_stack, kind).reshape(p, m, u)
    xv = B.kernel_view(x, kind).reshape(m, u)
    if dv.dtype != xv.dtype:
        raise TypeError(f"round_recv: d {d_stack.dtype} vs x {x.dtype}")
    act = torch.ones((m, p), dtype=torch.int32, device=x.device) \
        if active is None else active.to(torch.int32).reshape(m, p).contiguous()
    run = plain if B.is_cpu(xv) else _launch
    xo, s, cov, cnt, dsz = run(dv, xv, act, kind, emit_stored, emit_cov)
    xo = B.restore(xo.reshape(x.shape), x.dtype)
    s = None if s is None else B.restore(s.reshape(d_stack.shape), x.dtype)
    cov = None if cov is None else cov.reshape(x.shape)
    return xo, s, cov, cnt.reshape(lead + (p,)), dsz.reshape(lead + (p,))
