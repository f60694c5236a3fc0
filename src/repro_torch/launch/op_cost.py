"""Per-device cost of a traced step: the counterpart of
``repro.launch.hlo_cost``, which reads a compiled, SPMD-partitioned XLA
module.

``analyze(fn, *args)`` runs ``fn`` under a dispatch mode that sees every op
*below* the DTensor layer — an op on DTensors is left to DTensor, whose
local ops and collectives then come back through the mode — so each count
is one device's, on its local shards:

* ``flops``      — the FLOPs of each op that ``torch.utils.flop_counter``
                   counts (matrix products, convolutions, attention),
                   forward and backward;
* ``hbm_bytes``  — Σ (operand + result bytes) over every op that is not a
                   view, a factory of uninitialised memory or a collective.
                   Eager PyTorch fuses nothing, so this is the traffic the
                   eager program really makes (a compiled module's would
                   be less);
* collectives    — per-kind counts and per-device link bytes of the
                   functional collectives the redistributions issue
                   (``launch.collectives``, ring formulas).

``trip_counts`` stays ``{}``: eager dispatch runs every loop iteration, so
nothing needs the HLO parser's loop correction. Run ``fn`` under
``FakeTensorMode`` on a fake process group to cost a mesh of any size
without allocating (``launch.dryrun``).

DTensor derives an op's output shape by running it once on global-shape
fake tensors the first time it meets the op's schema; those runs are not
the program's, and :func:`hidden_meta_propagation` hides them from every
dispatch mode (this cost mode, a memory tracker).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.launch import collectives as C

# ops that move no device memory: uninitialised allocations and metadata
_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "device")


@dataclasses.dataclass
class OpCost:
    flops: float
    hbm_bytes: float
    collective_counts: Dict[str, float]
    collective_chip_bytes: Dict[str, float]
    trip_counts: Dict[str, int]

    @property
    def total_collective_chip_bytes(self) -> float:
        return sum(self.collective_chip_bytes.values())


@contextlib.contextmanager
def hidden_meta_propagation():
    """While active, DTensor's shape propagation runs with every dispatch
    mode set aside (it makes a fake mode of its own), so no mode counts
    its global-shape tensors. The one use of DTensor's private sharding
    propagator and of torch's private mode-stack helper."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def wrapped(self, op_schema):
        with _disable_current_modes():
            return orig(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = wrapped
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class CostMode(TorchDispatchMode):
    """Counts FLOPs, HBM bytes and collectives of the local ops."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collectives = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        rec = C.record_of(func, args, out)
        if rec is not None:
            self.collectives.append(rec)
            return out
        if func.namespace == "_c10d_functional":      # wait_tensor
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        name = func.__name__.split(".")[0]
        if not func.is_view and name not in _NO_TRAFFIC:
            self.hbm_bytes += _bytes((args, kwargs)) + _bytes(out)
        return out


def analyze(fn, *args, num_devices: int | None = None, **kwargs):
    """``(fn(*args, **kwargs), OpCost)`` of one call, per device.
    ``num_devices`` (default: the process group's size, else 1) is the
    group size of a collective whose group is not named."""
    if num_devices is None:
        num_devices = dist.get_world_size() if dist.is_initialized() else 1
    mode = CostMode()
    with hidden_meta_propagation(), mode:
        out = fn(*args, **kwargs)
    stats = C.analyze_collectives(mode.collectives, num_devices)
    return out, OpCost(flops=mode.flops, hbm_bytes=mode.hbm_bytes,
                       collective_counts=dict(stats.counts),
                       collective_chip_bytes=dict(stats.per_chip_bytes),
                       trip_counts={})
