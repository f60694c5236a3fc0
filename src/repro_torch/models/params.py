"""Parameter definitions and their deterministic initialisation, PyTorch
port of ``repro.models.params``.

Params are nested dicts (and lists) of ``ParamDef`` (shape, logical axes,
init) that materialise either as real tensors (``init_tree``) or as
``meta``-device stand-ins that allocate nothing (``tree_shapes``).

Logical axes translate to a per-dim ``Spec`` (the counterpart of JAX's
``PartitionSpec``) via a rules table (MaxText-style): training rules
implement ZeRO-3/FSDP×TP (weights shard over the data axes and the model
axis), serving rules shard over the model axis only. ``placements`` turns a
``Spec`` into DTensor placements on a ``DeviceMesh`` with named dims.

Each leaf draws from its own ``torch.Generator`` on the target device,
seeded by a CRC-32 of the run's seed and the leaf's path, so a tree is the
same in every process. (The JAX package keys its leaves with Python's
salted ``hash()``, so its weights differ between processes: parity tests
carry a JAX tree across with ``convert.params_to_torch`` and never draw
weights on both sides.)
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.sync.simulator import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "fan_in"       # "fan_in" | "zeros" | "ones" | "normal" | "rnn_lambda" | "embed"
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def tree_map(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a nested dict/list tree of ``ParamDef``s (or
    tensors); the path names the leaf as ``['blocks'][0]['wq']`` does in
    ``jax.tree_util.keystr``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, f"{path}['{k}']") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, f"{path}[{i}]") for i, v in enumerate(tree)]
    return fn(path, tree)


# logical axis -> mesh axes, per execution mode
TRAIN_RULES = {
    "fsdp": ("pod", "data"),   # weight shards over data axes (ZeRO-3)
    "tp": ("model",),          # tensor-parallel dim
    "stack": None,             # stacked layer-group dim (the JAX layout)
    "expert": None,            # expert dim (baseline: FSDP'd via fsdp dim)
    None: None,
}
SERVE_RULES = {
    "fsdp": None,
    "tp": ("model",),
    "stack": None,
    "expert": None,
    None: None,
}


class Spec:
    """A per-dim sharding spec: each entry None (replicated), a mesh axis
    name, or a tuple of names (that dim split over them, the first major),
    element for element what JAX's ``PartitionSpec`` holds. It iterates
    and compares as the tuple of its entries, but is not a tuple, so the
    tree helpers take it as one leaf."""

    __slots__ = ("dims",)

    def __init__(self, *dims):
        self.dims = tuple(dims)

    def __iter__(self):
        return iter(self.dims)

    def __len__(self):
        return len(self.dims)

    def __getitem__(self, i):
        return self.dims[i]

    def __eq__(self, other):
        if isinstance(other, Spec):
            return self.dims == other.dims
        return isinstance(other, tuple) and self.dims == other

    def __hash__(self):
        return hash(self.dims)

    def __repr__(self):
        return f"Spec{self.dims!r}"


def axis_names(mesh) -> tuple:
    """The named axes of a ``DeviceMesh`` (``mesh_dim_names``) or of any
    stand-in with ``axis_names``, in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def logical_to_spec(logical, rules, mesh_axes) -> Spec:
    out = []
    for ax in logical:
        m = rules.get(ax, None)
        if m is None:
            out.append(None)
        else:
            present = tuple(a for a in m if a in mesh_axes)
            out.append(present if len(present) > 1
                       else (present[0] if present else None))
    return Spec(*out)


def tree_specs(defs, rules, mesh_axes):
    return tree_map(lambda _, d: logical_to_spec(d.logical, rules, mesh_axes),
                    defs)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: mesh dim i is
    ``Shard(d)`` where tensor dim d names its axis, else ``Replicate()``.
    A dim over several axes is ``Shard(d)`` on each, in mesh order (the
    first named axis major, as in JAX)."""
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"{spec}: axes of dim {d} must follow the "
                             f"mesh's order {names}")
        for a in axes:
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: mesh axis {a!r} shards two dims")
            out[i] = Shard(d)
    return tuple(out)


def shard_range(t, dim: int):
    """(start, length) of this rank's shard of the DTensor ``t`` along
    ``dim`` (nested ``Shard(dim)`` placements in mesh order, chunked as
    DTensor chunks)."""
    start, size = 0, t.shape[dim]
    for i, pl in enumerate(t.placements):
        if isinstance(pl, Shard) and pl.dim == dim % t.dim():
            n, r = t.device_mesh.size(i), t.device_mesh.get_local_rank(i)
            chunk = -(-size // n)
            start += min(r * chunk, size)
            size = max(0, min(chunk, size - r * chunk))
    return start, size


def tree_shapes(defs):
    """``meta``-device stand-ins (shape and dtype, no storage)."""
    return tree_map(
        lambda _, d: torch.empty(d.shape, dtype=d.dtype, device="meta"), defs)


def _init_one(d: ParamDef, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=dev)
    if d.init == "rnn_lambda":
        # RG-LRU Λ init so that a = σ(Λ)^c lands in [0.9, 0.999]
        u = torch.rand(d.shape, generator=gen, device=dev) * (0.999 - 0.9) + 0.9
        root = u ** (1.0 / 8.0)
        return torch.log(root / (1 - root)).to(d.dtype)
    if d.init == "embed":
        # embeddings: std d^-1/2 keeps tied-head logits O(1)
        scale = d.shape[-1] ** -0.5
    else:
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = 1.0 if d.init == "normal" else fan_in ** -0.5
    w = torch.randn(d.shape, generator=gen, device=dev)
    return (w * scale).to(d.dtype)


def leaf_generator(seed: int, path: str, device) -> torch.Generator:
    """The generator of one leaf, seeded with a CRC-32 of the run's seed and
    the leaf's path (32 bits: the CPU generator keeps no more)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(zlib.crc32(f"{seed}/{path}".encode()))
    return gen


def init_tree(defs, seed: int = 0, device="cuda"):
    """Materialise a ParamDef tree on ``device`` deterministically
    (path-keyed generators)."""
    dev = resolve_device(device)
    return tree_map(
        lambda path, d: _init_one(d, leaf_generator(seed, path, dev)), defs)
