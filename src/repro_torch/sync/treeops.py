"""Helpers for node- and slot-indexed lattice states (PyTorch counterpart of
``repro.sync.treeops``). A state is one tensor (the dense lattices) or a
tuple of states (lex pairs, products, linear sums); each helper applies the
same tensor operation to every leaf through ``core.lattice.tree_map``, so a
one-tensor state takes exactly the one operation. The trailing axes of a
leaf are its universe axes (none for a linear sum's tag)."""

from __future__ import annotations

import torch

from repro_torch.core.lattice import tree_map


def bcast(state, prefix: tuple):
    """Broadcast a (⊥-like) state to leading axes ``prefix`` (a copy, so
    the result may be written)."""
    return tree_map(lambda a: a.expand(tuple(prefix) + tuple(a.shape))
                    .clone(), state)


def where(cond: torch.Tensor, a, b):
    """Select between two states; ``cond`` has the states' common leading
    shape and is right-padded with singleton axes to each leaf's rank.
    ``b`` may be a Python scalar (0 is ⊥ for every leaf of the port's
    lattices); it takes the leaf's dtype, so a bool state stays bool."""

    def sel(x, y):
        c = cond.reshape(tuple(cond.shape) + (1,) * (x.ndim - cond.ndim))
        if not isinstance(y, torch.Tensor):
            y = x.new_full((), y)
        return torch.where(c, x, y)

    if isinstance(b, (torch.Tensor, tuple)):
        return tree_map(sel, a, b)
    return tree_map(lambda x: sel(x, b), a)


def where_bot(cond: torch.Tensor, a):
    """``a`` where ``cond`` else ⊥."""
    return where(cond, a, 0)


def where_lead(cond: torch.Tensor, a, b, bot):
    """Select between two states by a mask of the LEADING axes of ``cond``'s
    own rank: per leaf, ``cond`` grows one trailing singleton per axis of
    the matching leaf of the unbatched ⊥ state ``bot`` (its universe
    rank), then broadcasts right-aligned over any further leading axes (a
    slot axis). This is ``repro.sync.treeops.where_bot``'s alignment; it
    lets a [N] mask gate a [P+1, N, U] buffer and a [P+1, N] tag alike.
    ``b`` may be a Python scalar."""

    def sel(x, y, bl):
        c = cond.reshape(tuple(cond.shape) + (1,) * bl.ndim)
        if not isinstance(y, torch.Tensor):
            y = x.new_full((), y)
        return torch.where(c, x, y)

    if isinstance(b, (torch.Tensor, tuple)):
        return tree_map(sel, a, b, bot)
    return tree_map(lambda x, bl: sel(x, b, bl), a, bot)


def slot(state, p: int):
    """Buffer slot ``p`` of every node of a [P+1, N, U] buffer (a view)."""
    return tree_map(lambda a: a[p], state)


def set_slot(state, p: int, val):
    """A copy of ``state`` with slot ``p`` replaced by ``val``."""

    def put(a, v):
        out = a.clone()
        out[p] = v
        return out

    return tree_map(put, state, val)


def stack(states: list):
    """States of one structure stacked along a new leading axis."""
    if isinstance(states[0], tuple):
        return tuple(stack([s[i] for s in states])
                     for i in range(len(states[0])))
    return torch.stack(states)


def gather(state, idx0: torch.Tensor, idx1: torch.Tensor):
    """Leafwise ``a[idx0, idx1]`` (advanced indexing on two leading
    axes)."""
    return tree_map(lambda a: a[idx0, idx1], state)


def zeros_like(state):
    return tree_map(torch.zeros_like, state)


def to(state, device):
    """A state (tensors or numpy arrays) on ``device``, contiguous."""
    return tree_map(lambda a: torch.as_tensor(a).to(device).contiguous(),
                    state)


def cast_like(state, like):
    """``state`` with each leaf cast to the dtype of the matching leaf of
    ``like``."""
    return tree_map(lambda a, b: a.to(b.dtype), state, like)


def merge_axes(state, axis: int):
    """Every leaf with its axes ``axis`` and ``axis + 1`` merged into one
    (a view of a contiguous leaf): the [B, N] (config, node) axes of a
    batched state become the B·N rows of the tiled topology."""
    return tree_map(lambda a: a.reshape(
        tuple(a.shape[:axis]) + (-1,) + tuple(a.shape[axis + 2:])), state)


def split_axis(state, axis: int, first: int):
    """Inverse of :func:`merge_axes`: axis ``axis`` of every leaf split
    into (``first``, the rest)."""
    return tree_map(lambda a: a.reshape(
        tuple(a.shape[:axis]) + (first, -1) + tuple(a.shape[axis + 1:])),
        state)
