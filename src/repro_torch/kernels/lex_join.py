"""Lexicographic-pair map join and Δ, the LWWMap / LexCounter hot path.

CUDA kernel ``csrc/lex_join.cu`` (replacing the TPU kernel
``lex_join_delta_2d`` in ``src/repro/kernels/lex_join.py``) and its plain
PyTorch version, with the contract of ``repro.kernels.ops.lex_join_delta``:
two lex-pair states a = (ta, va), b = (tb, vb) of any one shape in;
``(a ⊔ b, Δ(b, a), count)`` out, the count an int32 0-d tensor on the
states' device (no host read).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build as B

launches = 0          # kernel launches since the last reset (CUDA only)

_SIGNATURE = {"lex_join_delta_launch": [ctypes.c_void_p] * 9
              + [ctypes.c_longlong, ctypes.c_void_p]}


def plain(ta, va, tb, vb):
    """Plain version: ``(t, v, dt, dv, count)``."""
    eq = ta == tb
    t = torch.maximum(ta, tb)
    v = torch.where(eq, torch.maximum(va, vb), torch.where(ta > tb, va, vb))
    # Δ((tb, vb), (ta, va)): b's pairs not ⊑ a, and not ⊥
    leq_b_a = (tb < ta) | (eq & (vb <= va))
    novel = ~leq_b_a & ~((tb == 0) & (vb == 0))
    zero = ta.new_zeros(())
    return (t, v, torch.where(novel, tb, zero), torch.where(novel, vb, zero),
            novel.sum(dtype=torch.int32))


def _launch(ta, va, tb, vb):
    global launches
    B.check_cuda("lex_join_delta", ta, va, tb, vb)
    outs = [torch.empty_like(ta) for _ in range(4)]
    count = torch.zeros((), dtype=torch.int32, device=ta.device)
    lib = B.library("lex_join", _SIGNATURE)
    with B.launching(ta.device) as stream:
        err = lib.lex_join_delta_launch(
            *(B.ptr(a) for a in (ta, va, tb, vb, *outs, count)), ta.numel(),
            stream)
    B.check_launch(lib, err, "lex_join_delta")
    launches += 1
    return (*outs, count)


def lex_join_delta(a, b):
    """``((t, v), (dt, dv), count)``: the lex join a ⊔ b (the larger
    timestamp wins its value; equal timestamps take the larger value) and
    Δ(b, a) (b's pairs with ¬(b ⊑ a) and b ≠ (0, 0), ⊥ elsewhere), for
    int32 leaves of one shape, compared signed. ``count`` (int32 0-d, on
    the states' device) counts Δ's pairs; it is exact below 2³¹ (the scale
    shapes, 15 × 4,194,304 pairs, give at most 62,914,560). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel
    (contiguous) or raises."""
    leaves = (*a, *b)
    if len(leaves) != 4:
        raise ValueError("lex_join_delta takes two (t, v) pairs")
    for leaf in leaves:
        if leaf.dtype != torch.int32:
            raise TypeError(f"lex_join_delta takes int32 leaves, not "
                            f"{leaf.dtype}")
        if leaf.shape != leaves[0].shape:
            raise ValueError(f"lex_join_delta: leaf shapes "
                             f"{[tuple(x.shape) for x in leaves]} differ")
    if B.is_cpu(leaves[0]):
        t, v, dt, dv, count = plain(*leaves)
    elif leaves[0].numel() == 0:
        t, v, dt, dv = (torch.empty_like(leaves[0]) for _ in range(4))
        count = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
    else:
        t, v, dt, dv, count = _launch(*leaves)
    return (t, v), (dt, dv), count
