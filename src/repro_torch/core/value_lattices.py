"""Per-slot value lattices (PyTorch counterpart of ``repro.core.value_lattices``).

A *value lattice* defines the order over a single map entry (one "slot" of a
fixed universe). Map-like CRDT states are tensors of value-lattice points; the
join-irreducibles of the map state are exactly the single-slot states whose
slot value is non-bottom (see ``lattice.MapLattice``).

All operations are elementwise, so they vectorize over the universe axis and
any leading axes (the node axis of a simulated cluster).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class ValueLattice:
    """Elementwise lattice over tensor points: one tensor of ``dtype``, or
    (``arity`` > 1) a tuple of tensors of the dtypes in ``dtype`` (a
    struct-of-arrays point, e.g. a lexicographic pair)."""

    name: str
    dtype: torch.dtype | tuple
    # join(a, b) -> point
    join: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    # leq(a, b) -> bool tensor   (pointwise a ⊑ b)
    leq: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    # is_bottom(a) -> bool tensor
    is_bottom: Callable[[torch.Tensor], torch.Tensor]
    # Dense kernel implementing this pointwise order ("max", "bitor") or
    # None; propagated to Lattice.kernel_kind for engine dispatch.
    kernel_kind: str | None = None
    # number of tensors making up a point (1 for scalar lattices)
    arity: int = 1

    def bottom(self, shape, device=None):
        if self.arity == 1:
            return torch.zeros(shape, dtype=self.dtype, device=device)
        return tuple(torch.zeros(shape, dtype=d, device=device)
                     for d in self.dtype)


def max_int(dtype=torch.int32) -> ValueLattice:
    """Natural numbers under max — GCounter entries, GMap versions."""
    return ValueLattice(
        name=f"max_{str(dtype).removeprefix('torch.')}",
        dtype=dtype,
        join=torch.maximum,
        leq=lambda a, b: a <= b,
        is_bottom=lambda a: a == 0,
        kernel_kind="max",
    )


def or_bool() -> ValueLattice:
    """Booleans under disjunction — GSet membership flags."""
    return ValueLattice(
        name="or_bool",
        dtype=torch.bool,
        join=torch.logical_or,
        leq=lambda a, b: torch.logical_or(torch.logical_not(a), b),
        is_bottom=torch.logical_not,
        kernel_kind="max",        # or on {0, 1} ≡ pointwise max
    )


def lex_pair(ts_dtype=torch.int32, val_dtype=torch.int32) -> ValueLattice:
    """Lexicographic pair (version, value) — LWW registers and
    Cassandra-style counters (single-writer principle: the version is a
    chain, so the lex product stays distributive; paper Appendix B, Table
    III). The timestamp wins; equal timestamps take the larger value."""

    def join(a, b):
        ta, va = a
        tb, vb = b
        val = torch.where(ta == tb, torch.maximum(va, vb),
                          torch.where(ta > tb, va, vb))
        return (torch.maximum(ta, tb), val)

    def leq(a, b):
        ta, va = a
        tb, vb = b
        return (ta < tb) | ((ta == tb) & (va <= vb))

    def is_bottom(a):
        ta, va = a
        return (ta == 0) & (va == 0)

    return ValueLattice(name="lex_pair", dtype=(ts_dtype, val_dtype),
                        join=join, leq=leq, is_bottom=is_bottom, arity=2)
