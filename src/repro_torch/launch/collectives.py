"""Collective traffic of a traced program, for the roofline's collective
term: the counterpart of ``repro.launch.hlo_analysis``, which parses the
collectives of a compiled XLA module.

Here the program is eager PyTorch over DTensors. Every collective a
redistribution issues is a ``_c10d_functional`` op on the local shards
(``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``, ``broadcast``); a dispatch mode below DTensor
(``launch.op_cost``) turns each into a :class:`Collective` with
:func:`record_of` (its result's bytes and its group's size), and
:func:`analyze_collectives` models per-device link traffic with the ring
formulas of the JAX package (``repro.launch.hlo_cost``):

    all-reduce       2·X·(g−1)/g      (reduce-scatter + all-gather halves)
    all-gather       X·(g−1)/g        (X = full gathered output)
    reduce-scatter   X·(g−1)          (X = per-device output shard)
    all-to-all       X·(g−1)/g
    collective-permute X              (a broadcast counts as one)

Shapes are the local shards', so all results are per device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, NamedTuple, Optional

import torch
from torch.utils._pytree import tree_leaves

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

# _c10d_functional op -> (kind, index of its group_size argument or None)
_FUNCTIONAL = {
    "all_reduce": ("all-reduce", None),
    "all_reduce_": ("all-reduce", None),
    "all_reduce_coalesced": ("all-reduce", None),
    "all_gather_into_tensor": ("all-gather", 1),
    "all_gather_into_tensor_coalesced": ("all-gather", 1),
    "reduce_scatter_tensor": ("reduce-scatter", 2),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 2),
    "all_to_all_single": ("all-to-all", None),
    "broadcast": ("collective-permute", None),
    "broadcast_": ("collective-permute", None),
}


class Collective(NamedTuple):
    kind: str                  # one of COLLECTIVE_KINDS
    result_bytes: int          # bytes of the op's (local) result
    group_size: Optional[int]  # ranks in its group (None: the whole world)


@dataclasses.dataclass
class CollectiveStats:
    # per-kind: (op count, per-chip modeled bytes, raw result bytes)
    counts: Dict[str, int]
    per_chip_bytes: Dict[str, float]
    result_bytes: Dict[str, float]

    @property
    def total_per_chip_bytes(self) -> float:
        return sum(self.per_chip_bytes.values())

    @property
    def total_ops(self) -> int:
        return sum(self.counts.values())


def chip_bytes(kind: str, x: float, g: int) -> float:
    """Per-device link bytes of one collective with an X-byte result over a
    group of g (the ring formulas above)."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * x * (g - 1) / g
    if kind == "all-gather":
        return x * (g - 1) / g
    if kind == "reduce-scatter":
        return x * (g - 1)
    if kind == "all-to-all":
        return x * (g - 1) / g
    return float(x)            # collective-permute


def _group_size(group_name) -> int:
    # the one use of c10d's private name -> group lookup
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group_name).size()


def record_of(func, args, out) -> Optional[Collective]:
    """The :class:`Collective` of one dispatched op, or None if it is not a
    ``_c10d_functional`` collective."""
    if func.namespace != "_c10d_functional":
        return None
    entry = _FUNCTIONAL.get(func.__name__.split(".")[0])
    if entry is None:
        return None
    kind, size_at = entry
    x = sum(t.numel() * t.element_size() for t in tree_leaves(out)
            if isinstance(t, torch.Tensor))
    g = args[size_at] if size_at is not None else _group_size(args[-1])
    return Collective(kind, int(x), int(g))


def analyze_collectives(trace: Iterable[Collective],
                        num_devices: int) -> CollectiveStats:
    """Per-kind counts, modeled per-device link bytes and raw result bytes
    of the recorded collectives (a group size of None is the world's)."""
    counts = {k: 0 for k in COLLECTIVE_KINDS}
    per_chip = {k: 0.0 for k in COLLECTIVE_KINDS}
    res = {k: 0.0 for k in COLLECTIVE_KINDS}
    for c in trace:
        g = num_devices if c.group_size is None else c.group_size
        counts[c.kind] += 1
        per_chip[c.kind] += chip_bytes(c.kind, c.result_bytes, g)
        res[c.kind] += float(c.result_bytes)
    return CollectiveStats(counts=counts, per_chip_bytes=per_chip,
                           result_bytes=res)
