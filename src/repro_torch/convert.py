"""Carry states across between the JAX package and the port.

The JAX package's states, algorithm carries (``x``, ``buf``, ``buf_elems``,
``aux``) and topology tables, handed over as numpy arrays, become the port's
tensors and back. States are [N, U] on both sides. Every per-slot array is
node-major in the JAX package and slot-major in the port, so that its slots
are contiguous operands of the port's kernels: the per-origin buffer
([N, P+1, U] ↔ [P+1, N, U]), ``state_driven``'s response buffer
([N, P, U] ↔ [P, N, U]) and ``digest_driven``'s ``aux`` (remote digests
[N, P, nB, 3] ↔ [P, N, nB, 3], have-one flags [N, P] ↔ [P, N]); the carry
converters swap those two axes. BitGSet words and digests change type:
uint32 in numpy, int32 bit-views in torch (same bits). Bool (GSet) stays
bool.
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


def _per_slot(x, buf) -> bool:
    """A buffer with one axis more than the states holds slots."""
    return buf is not None and buf.ndim == x.ndim + 1


def carry_to_torch(x, buf, buf_elems, aux=None, device="cpu") -> AlgoCarry:
    """A JAX ``AlgoCarry``'s leaves (numpy) -> the port's carry."""
    x, buf = np.asarray(x), None if buf is None else np.asarray(buf)
    if _per_slot(x, buf):
        buf = buf.swapaxes(0, 1)
    if aux is not None:
        aux = tuple(to_torch(np.asarray(a).swapaxes(0, 1), device)
                    for a in aux)
    return AlgoCarry(x=to_torch(x, device),
                     buf=None if buf is None else to_torch(buf, device),
                     buf_elems=to_torch(buf_elems, device).to(torch.int32),
                     aux=aux)


def carry_to_numpy(carry: AlgoCarry, words: bool = False):
    """The port's carry -> ``(x, buf, buf_elems, aux)`` numpy arrays in the
    JAX package's types (digests as uint32 words)."""
    buf, aux = carry.buf, carry.aux
    if _per_slot(carry.x, buf):
        buf = buf.movedim(0, 1)
    if aux is not None:
        dig, have = aux
        aux = (to_numpy(dig.movedim(0, 1), words=True),
               to_numpy(have.movedim(0, 1)))
    return (to_numpy(carry.x, words),
            None if buf is None else to_numpy(buf, words),
            to_numpy(carry.buf_elems), aux)


def topology_to_torch(name: str, nbrs, mask, rev) -> Topology:
    """A JAX ``Topology``'s tables (numpy) -> the port's topology."""
    return from_tables(name, nbrs, mask, rev)


def topology_to_numpy(topo: Topology):
    """The port's topology -> ``(nbrs, mask, rev)`` numpy tables."""
    return topo.nbrs.numpy(), topo.mask.numpy(), topo.rev.numpy()
