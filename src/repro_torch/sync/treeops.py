"""Helpers for node- and slot-indexed lattice states (PyTorch counterpart of
``repro.sync.treeops``). The dense lattices of the port hold one tensor per
state, so the pytree mapping of the JAX helpers is not needed: each helper
acts on one tensor whose trailing axis is the universe."""

from __future__ import annotations

import torch


def bcast(state: torch.Tensor, prefix: tuple) -> torch.Tensor:
    """Broadcast a (⊥-like) state to leading axes ``prefix`` (a copy, so
    the result may be written)."""
    return state.expand(tuple(prefix) + tuple(state.shape)).clone()


def where(cond: torch.Tensor, a: torch.Tensor, b) -> torch.Tensor:
    """Select between two states; ``cond`` has the leading shape and is
    right-padded with singleton axes to the states' rank. ``b`` may be a
    Python scalar (0 is ⊥ for every dense lattice); it takes ``a``'s dtype,
    so a bool state stays bool."""
    c = cond.reshape(tuple(cond.shape) + (1,) * (a.ndim - cond.ndim))
    if not isinstance(b, torch.Tensor):
        b = a.new_full((), b)
    return torch.where(c, a, b)


def where_bot(cond: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``a`` where ``cond`` else ⊥."""
    return where(cond, a, 0)


def slot(state: torch.Tensor, p: int) -> torch.Tensor:
    """Buffer slot ``p`` of every node of a [P+1, N, U] buffer (a view)."""
    return state[p]


def set_slot(state: torch.Tensor, p: int, val: torch.Tensor) -> torch.Tensor:
    """A copy of ``state`` with slot ``p`` replaced by ``val``."""
    out = state.clone()
    out[p] = val
    return out
