"""Sharding specs for every step input and output, PyTorch port of
``repro.train.sharding``.

Single-pod mesh: (data, model). Multi-pod: (pod, data, model) — the pod
axis joins the data axes for batch/FSDP sharding. ``long_500k`` (batch 1)
shards the cache *sequence* over the data axes instead of the batch.

A spec is a ``models.params.Spec`` per leaf, element for element the JAX
package's ``PartitionSpec``; ``models.params.placements`` turns it into
DTensor placements on a ``DeviceMesh`` with named dims. The spec builders
take the mesh's axis names only (a ``DeviceMesh`` or any stand-in with
``axis_names``), so they need no process group. ``to_named`` carries a
plain tree (weights drawn by ``init_params`` or crossed over by
``convert.params_to_torch``) onto the mesh as DTensors, and ``full_tree``
gathers one back.

The port's trees are its own: ``param_specs`` matches ``Decoder.tensors()``
(the head's leaves and one dict a layer) and ``cache_specs`` the port's
cache (one dict a layer). A layer's spec is the JAX package's stacked
``blocks`` spec without its leading ``stack`` entry (always None), or its
``tail`` spec.
"""

from __future__ import annotations

from typing import Any

from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.models import transformer as TR
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (SERVE_RULES, TRAIN_RULES, Spec,
                                       axis_names, placements, tree_map,
                                       tree_specs)
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.adamw import tree_map as map_leaves


def data_axes_of(mesh) -> Any:
    names = axis_names(mesh)
    axes = tuple(a for a in ("pod", "data") if a in names)
    return axes if len(axes) > 1 else axes[0]


def batch_specs(cfg: ModelConfig, mesh, batch_tree, *, shard_batch=True):
    """Every batch leaf sharded over the data axes on its leading dim."""
    da = data_axes_of(mesh) if shard_batch else None
    return tree_map(lambda _, leaf: Spec(*([da] + [None] * (leaf.dim() - 1))),
                    batch_tree)


def _resolve_rules(rules, mesh):
    names = axis_names(mesh)
    out = {}
    for k, v in rules.items():
        present = () if v is None else tuple(a for a in v if a in names)
        out[k] = present if present else None
    return out


def param_specs(cfg: ModelConfig, mesh, mode: str):
    """Specs of ``Decoder.tensors()``: train rules (FSDP × TP) or serve
    rules (TP only)."""
    rules = TRAIN_RULES if mode == "train" else SERVE_RULES
    return tree_specs(TR.layer_param_defs(cfg), _resolve_rules(rules, mesh),
                      axis_names(mesh))


def opt_state_specs(param_sp) -> AdamWState:
    """AdamWState(step, master, mu, nu) — moments mirror param sharding."""
    return AdamWState(step=Spec(), master=param_sp, mu=param_sp, nu=param_sp)


def cache_specs(cfg: ModelConfig, mesh, *, seq_shard: str = "model"):
    """Specs matching ``init_cache``: one dict a layer.

    ``seq_shard`` places the cache *sequence* dim (flash-decoding style):
      "model" — seq over TP, batch over data (decode_32k / prefill)
      "all"   — seq over data+model (long_500k: batch 1 cannot shard)
    Recurrent states have no seq dim: their width shards over TP.
    """
    da = data_axes_of(mesh)
    tp = "model" if "model" in axis_names(mesh) else None
    if seq_shard == "all":
        batch = None
        seq = tuple(a for a in (da if isinstance(da, tuple) else (da,))
                    if a) + ((tp,) if tp else ())
        seq = seq if len(seq) > 1 else (seq[0] if seq else None)
    else:
        batch = da
        seq = tp

    def for_kind(kind):
        if kind in ("global", "local"):
            return {"k": Spec(batch, seq, None, None),
                    "v": Spec(batch, seq, None, None),
                    "kpos": Spec(batch, seq)}
        if kind == "rec":
            return {"h": Spec(batch, tp), "conv": Spec(batch, None, tp)}
        return {"s": Spec(batch, tp, None, None),
                "last_tm": Spec(batch, None),
                "last_cm": Spec(batch, None)}

    return [for_kind(k) for k in cfg.layer_kinds]


def to_named(tree, specs, mesh):
    """``tree`` (plain tensors) distributed onto ``mesh`` as DTensors with
    the placements of ``specs`` (a tree of the same structure). Every rank
    must hold the same full tree (drawn from one seed, or one checkpoint):
    each keeps its own shard, with no communication."""
    def one(t, spec):
        d = distribute_tensor(t.detach(), mesh, placements(spec, mesh),
                              src_data_rank=None)
        local = d.to_local()
        if local.untyped_storage().nbytes() > local.numel() \
                * local.element_size():
            local = local.clone()   # a shard owns its storage, not t's
        return DTensor.from_local(local, mesh, d.placements, run_check=False,
                                  shape=d.shape, stride=d.stride())
    return map_leaves(one, tree, specs)


def full_tree(tree):
    """``tree`` with every DTensor gathered to its full tensor."""
    return map_leaves(
        lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)
