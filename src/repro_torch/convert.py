"""Carry states across between the JAX package and the port.

The JAX package's states, algorithm carries (``x``, ``buf``, ``buf_elems``)
and topology tables, handed over as numpy arrays, become the port's tensors
and back. States are [N, U] on both sides. A per-origin buffer is node-major
[N, P+1, U] in the JAX package and slot-major [P+1, N, U] in the port, so
that its slots are contiguous operands of the port's kernels; the carry
converters swap those two axes. BitGSet words change type: uint32 in numpy,
int32 bit-views in torch (same bits). Bool (GSet) stays bool.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.sync.algorithms import AlgoCarry
from repro_torch.sync.topology import Topology, from_tables


def to_torch(a, device="cpu") -> torch.Tensor:
    """numpy array -> tensor on ``device``; uint32 words become int32
    bit-views."""
    a = np.array(a, order="C")          # a writable, contiguous copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor, words: bool = False) -> np.ndarray:
    """tensor -> numpy array; ``words=True`` returns int32 bit-views as the
    JAX package's uint32 words."""
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if words else a


def _per_origin(x, buf) -> bool:
    """A buffer with one axis more than the states holds origin slots."""
    return buf is not None and buf.ndim == x.ndim + 1


def carry_to_torch(x, buf, buf_elems, device="cpu") -> AlgoCarry:
    """A JAX ``AlgoCarry``'s leaves (numpy) -> the port's carry."""
    x, buf = np.asarray(x), None if buf is None else np.asarray(buf)
    if _per_origin(x, buf):
        buf = buf.swapaxes(0, 1)
    return AlgoCarry(x=to_torch(x, device),
                     buf=None if buf is None else to_torch(buf, device),
                     buf_elems=to_torch(buf_elems, device).to(torch.int32))


def carry_to_numpy(carry: AlgoCarry, words: bool = False):
    """The port's carry -> ``(x, buf, buf_elems)`` numpy arrays in the JAX
    package's types."""
    buf = carry.buf
    if _per_origin(carry.x, buf):
        buf = buf.movedim(0, 1)
    return (to_numpy(carry.x, words),
            None if buf is None else to_numpy(buf, words),
            to_numpy(carry.buf_elems))


def topology_to_torch(name: str, nbrs, mask, rev) -> Topology:
    """A JAX ``Topology``'s tables (numpy) -> the port's topology."""
    return from_tables(name, nbrs, mask, rev)


def topology_to_numpy(topo: Topology):
    """The port's topology -> ``(nbrs, mask, rev)`` numpy tables."""
    return topo.nbrs.numpy(), topo.mask.numpy(), topo.rev.numpy()
