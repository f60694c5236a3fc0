"""State lattices, join decompositions and optimal deltas (paper §III).

PyTorch counterpart of ``repro.core.lattice``:

* join-irreducible states are the single-slot states of a map ``U ↪ V``;
* ⇓x is represented implicitly by the tensor itself;
* the optimal delta  Δ(a, b) = ⊔{y ∈ ⇓a | y ⋢ b}  is an elementwise select;
* the product ``A × B`` and the linear sum ``A ⊕ B`` (Appendix B, Table
  III) compose lattices.

A state is one tensor or a tuple of states (a struct-of-arrays lex pair, a
product's components, a linear sum's ``(tag, low, high)``); :func:`tree_map`
maps a function over the tensors of such states. All reductions are over
the trailing universe axis, so states may carry leading axes (the node axis
of a simulated cluster, the slot axis of a buffer). Sizes come back as
int32, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from repro_torch.core.value_lattices import ValueLattice

Tensor = torch.Tensor
State = Any  # a tensor, or a tuple of states


def tree_map(fn, state, *others):
    """``fn`` over the tensors of ``state``, with the matching tensors of
    ``others`` (states of the same structure) as further arguments. A
    tensor state is one call of ``fn``."""
    if isinstance(state, tuple):
        return tuple(tree_map(fn, s, *(o[i] for o in others))
                     for i, s in enumerate(state))
    return fn(state, *others)


def tree_leaves(state) -> list:
    """The tensors of a state, in order."""
    if isinstance(state, tuple):
        return [leaf for s in state for leaf in tree_leaves(s)]
    return [state]


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
    # Weighted element accounting: wsize(x, w) sums ``w`` over x's non-⊥
    # irreducibles instead of counting them. ``w`` broadcasts against the
    # universe axis (per-slot weights, right-aligned), or, wrapped in
    # :class:`BatchWeights`, against the leading axes of every leaf (per-
    # object byte weights of the keyed store). ``wsize(x, 1) == size(x)``.
    wsize: Callable[[State, Any], Tensor] | None = None


@dataclasses.dataclass(frozen=True)
class BatchWeights:
    """Weights for :attr:`Lattice.wsize` aligned to the LEADING (batch)
    axes of every state leaf: each leaf right-pads ``w`` with singleton
    axes up to its own rank (:func:`align_weights`), so a product whose
    components have different universe ranks (a [B, N, U] map beside a
    [B, N] register) prices every leaf on its own batch axes."""

    w: Any


def align_weights(w, mask: Tensor):
    """Resolve a ``wsize`` weight operand against one leaf's irreducible
    mask (or per-word counts): :class:`BatchWeights` are left-aligned
    (right-padded with singletons to the mask's rank), anything else is a
    tensor broadcast right-aligned as it is."""
    if not isinstance(w, BatchWeights):
        return torch.as_tensor(w, device=mask.device)
    wa = torch.as_tensor(w.w, device=mask.device)
    pad = mask.ndim - wa.ndim
    if pad < 0:
        raise ValueError(
            f"BatchWeights rank {wa.ndim} exceeds the leaf mask rank "
            f"{mask.ndim}: batch weights must index leading axes of every "
            f"leaf")
    return wa.reshape(tuple(wa.shape) + (1,) * pad)


def weighted_sum(counts: Tensor, w) -> Tensor:
    """Σ over the universe axis of per-slot irreducible counts (a bool
    mask, or per-word popcounts) times their aligned weights."""
    return (counts * align_weights(w, counts)).sum(-1)


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
        bot = v.bottom(())

        def bottom(device=None):
            return v.bottom((self.universe,), device)

        def novel_mask(a, b):
            # slots whose irreducible in ⇓a is NOT ⊑ b
            return torch.logical_and(torch.logical_not(v.leq(a, b)),
                                     torch.logical_not(v.is_bottom(a)))

        def delta(a, b):
            # Δ(a,b): keep a's slot where its irreducible ⋢ b, else ⊥.
            keep = novel_mask(a, b)
            return tree_map(lambda ai, bi: torch.where(keep, ai,
                                                       bi.to(ai.device)),
                            a, bot)

        def irreducible_mask(a):
            return torch.logical_not(v.is_bottom(a))

        def size(a):
            return irreducible_mask(a).sum(-1, dtype=torch.int32)

        def leq(a, b):
            return torch.all(v.leq(a, b), dim=-1)

        def is_bottom(a):
            return torch.all(v.is_bottom(a), dim=-1)

        def wsize(a, w):
            return weighted_sum(irreducible_mask(a), w)

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
            # struct-of-arrays points (lex pairs) take the reference engine
            kernel_kind=v.kernel_kind if v.arity == 1 else None,
            wsize=wsize,
        )


def leq_from_join(join, equal):
    """The canonical order  x ⊑ y ⇔ x ⊔ y = y  (paper §II)."""

    def leq(a, b):
        return equal(join(a, b), b)

    return leq


def product(name: str, parts: Sequence[Lattice]) -> Lattice:
    """Cartesian product A × B (Table III: preserves DCC and
    distributivity). The state is a tuple of sub-states; an irreducible of
    A × B is (j, ⊥) or (⊥, j), so sizes add and Δ distributes
    componentwise."""
    parts = tuple(parts)

    def all_of(fn, *states):
        out = None
        for p, *xs in zip(parts, *states):
            r = fn(p)(*xs)
            out = r if out is None else torch.logical_and(out, r)
        return out

    def size(a):
        out = None
        for p, x in zip(parts, a):
            s = p.size(x)
            out = s if out is None else out + s
        return out

    def wsize(a, w):
        # an irreducible of A × B lives in one component: weighted sizes
        # add like sizes do, each component aligning w on its own leaves
        out = None
        for p, x in zip(parts, a):
            s = p.wsize(x, w)
            out = s if out is None else out + s
        return out

    return Lattice(
        name=name,
        bottom=lambda device=None: tuple(p.bottom(device) for p in parts),
        join=lambda a, b: tuple(p.join(x, y) for p, x, y in zip(parts, a, b)),
        leq=lambda a, b: all_of(lambda p: p.leq, a, b),
        delta=lambda a, b: tuple(p.delta(x, y)
                                 for p, x, y in zip(parts, a, b)),
        size=size,
        is_bottom=lambda a: all_of(lambda p: p.is_bottom, a),
        irreducible_mask=lambda a: tuple(p.irreducible_mask(x)
                                         for p, x in zip(parts, a)),
        novel_mask=lambda a, b: tuple(p.novel_mask(x, y)
                                      for p, x, y in zip(parts, a, b)),
        wsize=wsize,
    )


def linear_sum(name: str, low: Lattice, high: Lattice, is_high=None) -> Lattice:
    """Linear sum A ⊕ B (paper Appendix B, Table III): every element of B
    is above every element of A. The state is ``(tag, a_state, b_state)``
    with tag 0 = low, 1 = high; the inactive side is ⊥. ``is_high`` is not
    needed at run time (the tag carries it); it is kept for the signature
    of the JAX package's construct.

    Tags are per point while the sides carry universe axes, so every
    tag-driven select aligns the mask per leaf by that side's ⊥ rank
    (:func:`_tag_sel`)."""

    def _tag_sel(mask, a, b, bot_ref):
        # mask [...] against side leaves [..., *U]: one trailing singleton
        # per universe axis of the side's ⊥ leaf
        def sel(x, y, bl):
            return torch.where(mask.reshape(mask.shape + (1,) * bl.ndim),
                               x, y)

        return tree_map(sel, a, b, bot_ref)

    def zeros(s):
        return tree_map(torch.zeros_like, s)

    def bottom(device=None):
        return (torch.zeros((), dtype=torch.int32, device=device),
                low.bottom(device), high.bottom(device))

    def join(x, y):
        tx, ax, bx = x
        ty, ay, by = y
        # when the tags differ the high side wins and the low side is
        # discarded (absorbed below any high element)
        both_low = torch.logical_and(tx == 0, ty == 0)
        a = low.join(ax, ay)
        a_out = _tag_sel(both_low, a, zeros(a), low.bottom())
        return (torch.maximum(tx, ty), a_out, high.join(bx, by))

    def leq(x, y):
        tx, ax, bx = x
        ty, ay, by = y
        same = torch.where(tx == 0, low.leq(ax, ay), high.leq(bx, by))
        return torch.where(tx < ty, True, torch.where(tx > ty, False, same))

    def delta(x, y):
        tx, ax, bx = x
        ty, ay, by = y
        # Optimal Δ: ⊥ whenever x ⊑ y. The low side contributes only when
        # both are low; a high x delegates to the high side's Δ, which
        # against a low y compares to ⊥_B and returns all of x's high
        # irreducibles.
        da = low.delta(ax, ay)
        same_low = torch.logical_and(tx == 0, ty == 0)
        a_out = _tag_sel(same_low, da, zeros(da), low.bottom())
        tag = torch.where(leq(x, y), torch.zeros_like(tx), tx)
        return (tag, a_out, high.delta(bx, by))

    def size(x):
        tx, ax, bx = x
        return torch.where(tx == 0, low.size(ax), high.size(bx))

    def wsize(x, w):
        tx, ax, bx = x
        return torch.where(tx == 0, low.wsize(ax, w), high.wsize(bx, w))

    def is_bottom(x):
        tx, ax, _ = x
        return torch.logical_and(tx == 0, low.is_bottom(ax))

    return Lattice(
        name=name, bottom=bottom, join=join, leq=leq, delta=delta,
        size=size, is_bottom=is_bottom,
        irreducible_mask=lambda x: (low.irreducible_mask(x[1]),
                                    high.irreducible_mask(x[2])),
        novel_mask=lambda a, b: (low.novel_mask(a[1], b[1]),
                                 high.novel_mask(a[2], b[2])),
        wsize=wsize,
    )


# -- explicit (materialised) decompositions: property tests and docs ----------

def decompose_dense(lat_map: MapLattice, x: State):
    """Materialise ⇓x as a stack of single-slot states, plus a validity mask.

    Returns ``(stack, mask)``: ``stack`` has a new leading axis of length U
    (a tuple of such stacks for multi-tensor points), ``stack[k]`` is the
    irreducible of slot k (⊥ elsewhere) and ``mask[k]`` says whether slot k
    is in ⇓x. Only for small universes."""
    v = lat_map.value
    u = lat_map.universe
    eye = torch.eye(u, dtype=torch.bool)

    def expand(comp, bot):
        e = eye.to(comp.device).reshape((u,) + (1,) * (comp.ndim - 1) + (u,))
        return torch.where(e, comp[None], bot.to(comp.device))

    return tree_map(expand, x, v.bottom(())), torch.logical_not(v.is_bottom(x))


def join_all(lat: Lattice, states, mask=None):
    """⊔ over a Python sequence of states (``mask[i]`` false skips
    ``states[i]``)."""
    acc = lat.bottom()
    for i, s in enumerate(states):
        if mask is not None and not bool(mask[i]):
            continue
        acc = lat.join(acc, s)
    return acc
