"""Parameter definitions and their deterministic initialisation, PyTorch
port of ``repro.models.params``.

Params are nested dicts (and lists) of ``ParamDef`` (shape, logical axes,
init) that materialise either as real tensors (``init_tree``) or as
``meta``-device stand-ins that allocate nothing (``tree_shapes``). The
logical axes are kept so that the trees equal the JAX package's; mapping
them onto a device mesh (``TRAIN_RULES``, ``SERVE_RULES``,
``logical_to_spec``) has no meaning on one card and comes with the model
meshes.

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
