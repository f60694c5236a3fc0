"""Device meshes, PyTorch port of ``repro.launch.mesh``: the model side's
``torch.distributed`` ``DeviceMesh``es (``make_mesh``,
``make_production_mesh``, and ``fake_process_group`` for a dry-run), and
the meshes of the sweep's config axis and the store's object axis.

A :class:`Mesh` is the list of ``torch.device``s along one named axis;
``shape`` maps the axis name to its extent, as a JAX mesh's does. The
batch axis of a sweep (configs) or a store (objects) splits into equal
blocks, one a device of the mesh; configs and objects never communicate,
so a block's rounds run on its own device with no collective. The engines
issue the blocks' rounds round by round with no host read inside a round
(``simulator.run_blocks``), and each kernel launches on its block's card
and stream, so blocks on different cards overlap.

A mesh takes its devices from ``device``: a device type names every
visible device of that type (``"cuda"`` every card, ``"cpu"`` the one
CPU), an indexed device (``"cuda:1"``) that device alone, and a list its
entries in order. Entries may repeat: ``["cpu"] * 4`` is four blocks on
the CPU (the counterpart of the JAX package's forced host-device count)
and ``["cuda:0"] * 4`` four blocks on one card, the same program a
four-card mesh runs.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.core.lattice import Lattice, tree_leaves
from repro_torch.sync import treeops as T
from repro_torch.sync.simulator import resolve_device

SWEEP_AXIS = "config"
STORE_AXIS = "object"


# -- the model side's meshes (torch.distributed DeviceMesh) -------------------

def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with named dims ``axes`` (tests use
    small ones, e.g. (2, 2)) over the process group this process belongs
    to, whose size must be the mesh's. Raises where there is none: this
    process's rank, world size and rendezvous are the caller's
    (``dist.init_process_group``; ``torchrun`` sets them), or, for a
    dry-run, :func:`fake_process_group`."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    size = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"make_mesh{shape}: no process group; initialise one of "
            f"{size} ranks first (dist.init_process_group, or torchrun)")
    if dist.get_world_size() != size:
        raise RuntimeError(
            f"make_mesh{shape}: the process group has "
            f"{dist.get_world_size()} ranks, the mesh needs {size}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"make_mesh{shape}: device_type 'cuda' but no "
                           f"card is visible")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: 256 devices (16 data × 16 model). Multi-pod: 2 × 256."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """This process as rank 0 of a ``"fake"`` process group of
    ``world_size`` ranks, whose collectives return at once without moving
    data: a mesh of any size in one process, for a dry-run under
    ``FakeTensorMode`` (the counterpart of the JAX package's placeholder
    host devices). The group is destroyed on exit. (``FakeStore`` lives in
    torch's private testing package; this is its one use.)"""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_process_group: this process already "
                           "belongs to a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


class Mesh(NamedTuple):
    """The devices along one named batch axis; ``shape`` maps the axis name
    to its extent, as a JAX mesh's does."""

    devices: List[torch.device]
    axis_name: str

    @property
    def axis_names(self) -> tuple:
        return (self.axis_name,)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_name: len(self.devices)}


class Block(NamedTuple):
    """Entries [lo, hi) of a batch axis, run on ``device``."""

    device: torch.device
    lo: int
    hi: int


def mesh_devices(device="cuda") -> List[torch.device]:
    """The devices a mesh over ``device`` spans (see the module
    docstring); a CUDA device without a card raises."""
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("an empty device list")
        return [resolve_device(d) for d in device]
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def _take(device, num_devices: Optional[int]) -> List[torch.device]:
    devs = mesh_devices(device)
    if num_devices is None:
        return devs
    if not 1 <= num_devices <= len(devs):
        raise ValueError(f"num_devices={num_devices} but {len(devs)} "
                         f"device(s) are available: {devs}")
    return devs[:num_devices]


def sweep_mesh(num_devices: Optional[int] = None, device="cuda") -> Mesh:
    """1-D mesh over the config axis of a sweep: B independent configs,
    each device runs its own block of cells."""
    return Mesh(_take(device, num_devices), SWEEP_AXIS)


def store_mesh(num_devices: Optional[int] = None, config_devices: int = 1,
               device="cuda") -> Mesh:
    """1-D mesh over the object axis of the keyed store: each device runs
    its own block of objects. ``config_devices`` is the JAX mesh's second
    axis, for config-batched store runs, which the port does not have: it
    must be 1."""
    if config_devices != 1:
        raise ValueError(f"config_devices={config_devices}: the port's "
                         f"store runs one config, so the store mesh has "
                         f"the object axis alone (config_devices=1)")
    return Mesh(_take(device, num_devices), STORE_AXIS)


def batch_mesh(axis: str, shard: bool, device) -> Mesh:
    """The mesh a sweep's (``SWEEP_AXIS``) or a store's (``STORE_AXIS``)
    batch axis runs over: every device of ``device`` with ``shard``, else
    the one device it names (a list of devices asks for blocks, so it
    needs ``shard``)."""
    if shard:
        return Mesh(mesh_devices(device), axis)
    if isinstance(device, (list, tuple)):
        raise ValueError("a list of devices runs the batch axis in blocks: "
                         "pass shard=True")
    return Mesh([resolve_device(device)], axis)


def axis_shards(mesh: Mesh, axis: str) -> int:
    """Number of shards the named mesh axis splits a batch into (1 when
    the axis is absent — e.g. a 1-D sweep mesh asked about "object")."""
    return int(mesh.shape.get(axis, 1))


def padded_size(batch: int, shards: int) -> int:
    """Smallest multiple of ``shards`` that holds ``batch`` entries — the
    object-axis padding rule: arbitrary batch sizes shard by padding up to
    the device multiple instead of erroring."""
    return batch + (-batch) % shards


def _shard_axis(batch: int, mesh: Mesh, axis: str, what: str) -> List[Block]:
    devs = mesh.devices if mesh.axis_name == axis else mesh.devices[:1]
    n = len(devs)
    if batch % n:
        raise ValueError(
            f"{what} {batch} is not divisible by the {n}-shard {axis!r} "
            f"mesh axis — pad the batch to {padded_size(batch, n)} "
            f"(simulate_store pads automatically) or pass a smaller mesh")
    per = batch // n
    return [Block(d, i * per, (i + 1) * per) for i, d in enumerate(devs)]


def shard_sweep_scan(batch: int, mesh: Optional[Mesh] = None) -> List[Block]:
    """The config axis of a sweep split over ``mesh``'s "config" axis:
    one :class:`Block` a device (its cells' fault masks go with it)."""
    if mesh is None:
        mesh = sweep_mesh()
    return _shard_axis(batch, mesh, SWEEP_AXIS, "sweep batch")


def shard_store_scan(objects: int, mesh: Optional[Mesh] = None) -> List[Block]:
    """The object axis of a store split over ``mesh``'s "object" axis: one
    :class:`Block` a device. The store-wide fault masks are shared by every
    object and go to every device whole. ``objects`` must be a multiple of
    the shard count — ``simulate_store`` pads arbitrary object counts up to
    it (:func:`padded_size`) and masks the pad back out of the results."""
    if mesh is None:
        mesh = store_mesh()
    return _shard_axis(objects, mesh, STORE_AXIS, "store objects")


def block_op(op_fn, block: Block, shards: int):
    """The op stream a block runs: ``op_fn.for_block(lo, hi)`` when the
    op_fn carries per-object tables that must be cut to the block's rows
    (``workloads.versioned_slot_op``), else ``op_fn`` itself, which must
    then derive the object extent from ``x``. One shard runs ``op_fn``."""
    if shards == 1 or not hasattr(op_fn, "for_block"):
        return op_fn
    return op_fn.for_block(block.lo, block.hi)


def check_block_op(op_fn, lattice: Lattice, n: int, blocks: List[Block],
                   what: str, axis: str) -> None:
    """Over several blocks, call the first block's op stream once on a ⊥
    block state and refuse an ``op_fn`` whose deltas do not take the
    block's shape: each block runs its own rows, so ``op_fn`` must derive
    the batch extent from ``x`` (or cut its tables with ``for_block``)
    instead of closing over whole-batch tables. One block passes."""
    if len(blocks) == 1:
        return
    block = blocks[0]
    rows = block.hi - block.lo
    x = T.bcast(lattice.bottom(block.device), (rows, n))
    err = None
    try:
        out = block_op(op_fn, block, len(blocks))(x, 0)
        ok = len(tree_leaves(out)) == len(tree_leaves(x)) and all(
            tuple(o.shape) == tuple(a.shape)
            for o, a in zip(tree_leaves(out), tree_leaves(x)))
    except Exception as e:  # noqa: BLE001 - re-raised as a refusal
        ok, err = False, e
    if not ok:
        raise ValueError(
            f"{what} cannot run on a sharded {axis} axis: each of the "
            f"{len(blocks)} blocks runs its own {rows} {axis}s, so op_fn "
            f"must derive the {axis} extent from x (e.g. x.shape[0]) or "
            f"cut its tables with a for_block(lo, hi) method rather than "
            f"close over whole-batch op tables"
            + (f" (the block call failed with: {err})" if err else ""))
