"""Checkpoint bundles for torch carries, counterpart of the ``Checkpointer``
of ``repro.checkpoint.checkpointer``.

A bundle is a directory ``step_XXXXXXXX`` under the checkpointer's root
holding ``tensors.pt`` (the state's leaves, one CPU tensor each, written by
``torch.save``) and ``manifest.json`` (the step, the leaves' paths, dtypes
and shapes, a SHA-256 content digest, and a caller's ``extra`` record). The
state is a tree of dicts, tuples (named tuples included), tensors, numpy
arrays and None; a leaf's path names its place, e.g. ``['carry'].buf``.
:meth:`Checkpointer.restore` rebuilds the tree of a template ``like``
after verifying the digest, every path and every shape, so a truncated or
corrupted bundle, or a template that changed since the save, raises
instead of restoring garbage. Tensor leaves come back on the template
leaf's device, numpy leaves as numpy arrays.

The format is the port's own: the JAX package's ``arrays.npz`` bundles are
not read.

:class:`CheckpointRegistry` is the replicated registry of durable steps
that the gossip runtime synchronises (a GMap on the node's device).
"""

from __future__ import annotations

import hashlib
import json
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import GMap


def _flatten(tree, path: str = "") -> list:
    """``[(path, leaf)]`` in a fixed order: dict keys sorted, tuples by
    position (named tuples by field name); None is a leaf."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f, v in zip(tree._fields, tree)
                for kv in _flatten(v, f"{path}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(tree, leaves):
    """``tree`` with its leaves replaced from the iterator ``leaves``, in
    :func:`_flatten` order. (A module-level recursion: a nested recursive
    closure would form a reference cycle that keeps the restored tensors
    alive until the garbage collector runs — gigabytes for a store.)"""
    if isinstance(tree, dict):
        out = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(v, leaves) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _as_tensor(leaf) -> Optional[torch.Tensor]:
    if leaf is None:
        return None
    t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(leaf))
    return t.detach().to("cpu").contiguous()


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        if t is not None and t.numel():
            h.update(t.view(-1).view(torch.uint8).numpy())
    return h.hexdigest()[:16]


class Checkpointer:
    """Bundles under one directory, one per step."""

    def __init__(self, directory):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def save(self, step: int, state: Any, extra: Optional[dict] = None) -> str:
        """Write ``state`` as the bundle of ``step`` (replacing one of the
        same step); returns its content digest."""
        leaves = _flatten(state)
        tensors = [_as_tensor(leaf) for _, leaf in leaves]
        path = self._path(step)
        path.mkdir(exist_ok=True)
        torch.save({f"a{i}": t for i, t in enumerate(tensors)
                    if t is not None}, path / "tensors.pt")
        manifest = {
            "step": step,
            "time": time.time(),
            "digest": _digest(tensors),
            "paths": [p for p, _ in leaves],
            "dtypes": [None if t is None else str(t.dtype) for t in tensors],
            "shapes": [None if t is None else list(t.shape) for t in tensors],
            "extra": extra or {},
        }
        (path / "manifest.json").write_text(json.dumps(manifest, indent=2))
        return manifest["digest"]

    def restore(self, step: int, like: Any) -> Any:
        """The bundle of ``step`` in the structure of ``like``, verified
        first: the content digest, every leaf's path, and every leaf's
        shape against the manifest and against ``like``."""
        path = self._path(step)
        manifest = self.manifest(step)
        try:
            data = torch.load(path / "tensors.pt", map_location="cpu",
                              weights_only=True)
            loaded = [None if s is None else data[f"a{i}"]
                      for i, s in enumerate(manifest["shapes"])]
        except Exception as e:  # noqa: BLE001 - re-raised as a refusal
            raise ValueError(f"checkpoint bundle {path / 'tensors.pt'} is "
                             f"unreadable or truncated: {e}") from e
        digest = _digest(loaded)
        if digest != manifest["digest"]:
            raise ValueError(
                f"checkpoint {path} failed digest verification (manifest "
                f"{manifest['digest']}, recomputed {digest}): the bundle is "
                f"corrupted")
        leaves_like = _flatten(like)
        if len(leaves_like) != len(manifest["paths"]):
            raise ValueError(
                f"checkpoint {path} holds {len(manifest['paths'])} leaves "
                f"but the restore template has {len(leaves_like)}: the tree "
                f"structure changed since the save")
        out = []
        for i, (lp, leaf) in enumerate(leaves_like):
            mp = manifest["paths"][i]
            if lp != mp:
                raise ValueError(
                    f"checkpoint {path} leaf {i} is {mp!r} but the restore "
                    f"template has {lp!r} at that position: tree paths were "
                    f"reordered or renamed since the save")
            t, want = loaded[i], manifest["shapes"][i]
            if (t is None) != (leaf is None) or (t is not None and (
                    list(t.shape) != want)):
                raise ValueError(
                    f"checkpoint {path} leaf {mp!r} has shape "
                    f"{None if t is None else list(t.shape)} but the "
                    f"manifest recorded {want}")
            if t is not None and tuple(leaf.shape) != tuple(want):
                raise ValueError(
                    f"checkpoint {path} leaf {mp!r} was saved with shape "
                    f"{tuple(want)} but the restore template expects "
                    f"{tuple(leaf.shape)}")
            if isinstance(leaf, torch.Tensor):
                t = t.to(leaf.device)
            elif t is not None:
                t = t.numpy()
            out.append(t)
        return _unflatten(like, iter(out))

    def manifest(self, step: int) -> dict:
        """The step's manifest (metadata only, no tensor loads)."""
        return json.loads((self._path(step) / "manifest.json").read_text())

    def available_steps(self) -> list:
        return sorted(int(p.name.split("_")[1])
                      for p in self.dir.glob("step_*")
                      if (p / "manifest.json").exists())


class CheckpointRegistry:
    """Replicated registry: GMap slot per step bucket, max-join versions,
    on ``device`` (the card unless ``device="cpu"``).

    ``announce(step)`` produces the optimal delta to gossip; ``latest_step``
    is a pure read of the local replica. Bucketing: step → slot step %
    capacity with value = step + 1 (monotone), so the newest durable step
    wins everywhere without coordination.
    """

    def __init__(self, capacity: int = 1024, device="cuda"):
        # sync.store imports this module: resolve_device comes late
        from repro_torch.sync.simulator import resolve_device

        self.gmap = GMap(num_keys=capacity)
        self.state = self.gmap.lattice.bottom(resolve_device(device))
        self.capacity = capacity

    def announce(self, step: int):
        delta = torch.zeros_like(self.state)
        delta[step % self.capacity] = step + 1
        self.state = self.gmap.lattice.join(self.state, delta)
        return delta

    def merge(self, delta):
        self.state = self.gmap.lattice.join(self.state, delta)

    def latest_step(self) -> Optional[int]:
        m = int(self.state.max())
        return m - 1 if m > 0 else None
