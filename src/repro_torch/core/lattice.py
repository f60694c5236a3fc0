"""State lattices, join decompositions and optimal deltas (paper §III).

PyTorch counterpart of ``repro.core.lattice`` for the dense map lattices:

* join-irreducible states are the single-slot states of a map ``U ↪ V``;
* ⇓x is represented implicitly by the tensor itself;
* the optimal delta  Δ(a, b) = ⊔{y ∈ ⇓a | y ⋢ b}  is an elementwise select.

All reductions are over the trailing universe axis, so states may carry
leading axes (the node axis of a simulated cluster, the slot axis of a
buffer). Sizes come back as int32, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.value_lattices import ValueLattice

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Lattice:
    """A state lattice with join-decomposition support.

    ``size`` counts non-bottom join-irreducibles — the paper's measurement
    unit ("number of elements / map entries") for transmission and memory.
    """

    name: str
    bottom: Callable[..., Tensor]                 # bottom(device=None)
    join: Callable[[Tensor, Tensor], Tensor]
    leq: Callable[[Tensor, Tensor], Tensor]       # bool per leading index
    delta: Callable[[Tensor, Tensor], Tensor]     # optimal Δ(a, b)
    size: Callable[[Tensor], Tensor]              # int32 #non-bottom irreducibles
    is_bottom: Callable[[Tensor], Tensor]         # bool per leading index
    # Pointwise views (universe-axis resolution), used by RR and the kernels:
    irreducible_mask: Callable[[Tensor], Tensor]  # bool[..., U]
    novel_mask: Callable[[Tensor, Tensor], Tensor]  # bool[..., U]: ⇓a slots ⋢ b
    # Dense kernel kind implementing this lattice's join/Δ on one tensor
    # ("max": pointwise max, bool-or as 0/1 max; "bitor": bit-packed sets),
    # or None if only the reference engine applies.
    kernel_kind: str | None = None


@dataclasses.dataclass(frozen=True)
class MapLattice:
    """Finite function  U ↪ V  from a static universe to a value lattice
    (paper Appendix B, Table III); its irredundant decompositions are the
    single-slot states."""

    universe: int
    value: ValueLattice
    name: str = "map"

    def build(self) -> Lattice:
        v = self.value
        bot = torch.zeros((), dtype=v.dtype)

        def bottom(device=None):
            return v.bottom((self.universe,), device)

        def novel_mask(a, b):
            # slots whose irreducible in ⇓a is NOT ⊑ b
            return torch.logical_and(torch.logical_not(v.leq(a, b)),
                                     torch.logical_not(v.is_bottom(a)))

        def delta(a, b):
            # Δ(a,b): keep a's slot where its irreducible ⋢ b, else ⊥.
            return torch.where(novel_mask(a, b), a, bot.to(a.device))

        def irreducible_mask(a):
            return torch.logical_not(v.is_bottom(a))

        def size(a):
            return irreducible_mask(a).sum(-1, dtype=torch.int32)

        def leq(a, b):
            return torch.all(v.leq(a, b), dim=-1)

        def is_bottom(a):
            return torch.all(v.is_bottom(a), dim=-1)

        return Lattice(
            name=self.name,
            bottom=bottom,
            join=v.join,
            leq=leq,
            delta=delta,
            size=size,
            is_bottom=is_bottom,
            irreducible_mask=irreducible_mask,
            novel_mask=novel_mask,
            kernel_kind=v.kernel_kind,
        )
