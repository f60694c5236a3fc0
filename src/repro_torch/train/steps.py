"""Train, prefill and decode steps, PyTorch port of
``repro.train.steps``.

``make_train_step`` builds the training step: the loss (chunked
cross-entropy + the MoE aux loss) and its gradients by autograd, optionally
over microbatches (the batch's leading axis split, float32 gradients
accumulated as ``g / microbatches``, the metrics averaged), then AdamW with
float32 masters, global-norm clipping and decoupled decay. The state is
functional: a step returns a new ``TrainState`` and writes nothing in
place. ``make_prefill`` / ``make_decode`` build the serving steps, which
run without autograd. All close over the config; nothing is compiled.

Under a mesh the weights (and the optimizer state) are DTensors
(``train.sharding.to_named``) and the batch a DTensor sharded over the data
axes; ``hints`` are the activation constraints (``TR.ShardingHints``) and
``grad_specs`` a spec tree matching the weights: each gradient leaf, and
the float32 microbatch accumulator, is redistributed to its spec, so that
accumulation stays shard-local (the JAX step's reason for them). A step
with ``NO_HINTS`` and no ``grad_specs`` runs exactly as without a mesh.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models import transformer as TR
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import placements
from repro_torch.optim.adamw import (AdamW, AdamWState, tree_leaves,
                                     tree_unflatten)
from repro_torch.train.sharding import cache_specs
from repro_torch.train.losses import chunked_cross_entropy


class TrainState(NamedTuple):
    params: TR.Decoder     # bf16 working copy (float32 after microbatching)
    opt: AdamWState


def init_train_state(cfg: ModelConfig, optim: AdamW,
                     params: TR.Decoder) -> TrainState:
    return TrainState(params=params, opt=optim.init(params.tensors()))


def make_loss_fn(cfg: ModelConfig, hints=TR.NO_HINTS):
    def loss_fn(params, batch):
        feats, aux = TR.forward(cfg, params, batch, mode="train",
                                hints=hints)
        tot, den = chunked_cross_entropy(cfg, params, feats, batch["labels"],
                                         batch["loss_mask"])
        ce = tot / torch.clamp(den, min=1.0)
        return ce + aux, {"ce": ce, "aux": aux, "tokens": den}

    return loss_fn


def _constrain(grads, grad_specs):
    """Each DTensor gradient redistributed to its spec in ``grad_specs``
    (a list of specs in the order of the leaves), on its own mesh."""
    if grad_specs is None:
        return grads
    out = []
    for g, s in zip(grads, grad_specs):
        if isinstance(g, DTensor):
            want = placements(s, g.device_mesh)
            if tuple(g.placements) != want:
                g = g.redistribute(g.device_mesh, want)
        out.append(g)
    return out


def make_grad_fn(cfg: ModelConfig, microbatches: int = 1, *,
                 hints=TR.NO_HINTS, grad_specs=None):
    """``grad_fn(params, batch) -> (loss, metrics, grads)``, the JAX step's
    ``value_and_grad`` with its microbatch scan: ``grads`` has the tree of
    ``params.tensors()`` (a weight the loss does not reach gets zeros), in
    the weights' dtype, or float32 accumulated over ``microbatches``. It
    makes the model's weights trainable (``requires_grad``); serving runs
    them without autograd. ``hints`` and ``grad_specs`` (a spec tree of
    the weights) as in :func:`make_train_step`."""
    loss_fn = make_loss_fn(cfg, hints)
    specs = None if grad_specs is None else tree_leaves(grad_specs)

    def one(params, batch):
        params.requires_grad_(True)
        leaves = tree_leaves(params.tensors())
        with torch.enable_grad(), hints.context():
            loss, metrics = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = _constrain([torch.zeros_like(w) if g is None else g
                            for w, g in zip(leaves, grads)], specs)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def grad_fn(params, batch):
        if microbatches == 1:
            loss, metrics, grads = one(params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % microbatches:
                raise ValueError(f"a batch of {b} does not split into "
                                 f"{microbatches} microbatches")
            n = b // microbatches
            loss = torch.zeros((), dtype=torch.float32,
                               device=params.embed.device)
            grads, ms = None, []
            with hints.context():
                for i in range(microbatches):
                    # a DTensor's rows re-sharded over the data axes
                    l, m, g = one(params, {
                        k: hints.batch_only(v[i * n:(i + 1) * n])
                        for k, v in batch.items()})
                    g = [gg.float() / microbatches for gg in g]
                    grads = _constrain(g if grads is None else [
                        a + gg for a, gg in zip(grads, g)], specs)
                    loss = loss + l / microbatches
                    ms.append(m)
                metrics = {k: torch.stack([m[k] for m in ms]).mean()
                           for k in ms[0]}
        return loss, metrics, tree_unflatten(params.tensors(), iter(grads))

    return grad_fn


def make_train_step(cfg: ModelConfig, optim: AdamW, *,
                    microbatches: int = 1, hints=TR.NO_HINTS,
                    grad_specs=None):
    """``train_step(state, batch) -> (new state, metrics)``: metrics ``ce``,
    ``aux``, ``tokens``, ``loss``, ``grad_norm`` and ``lr`` (0-d tensors on
    the device). ``grad_specs``: optional spec tree matching the weights
    (``train.sharding.param_specs``); without it the gradients keep the
    placements autograd gives them, which may be replicated."""
    grad_fn = make_grad_fn(cfg, microbatches, hints=hints,
                           grad_specs=grad_specs)

    def train_step(state: TrainState, batch):
        loss, metrics, grads = grad_fn(state.params, batch)
        with hints.context():
            params, opt, opt_metrics = optim.update(grads, state.opt)
        del grads
        return (TrainState(params=TR.Decoder(cfg, params), opt=opt),
                dict(metrics, loss=loss, **opt_metrics))

    return train_step


def make_prefill(cfg: ModelConfig, *, hints=TR.NO_HINTS):
    """Full-sequence forward that also builds the KV cache (on the
    weights' device); returns the last-position logits (next-token) and
    the cache. Under a mesh (DTensor weights) every cache leaf comes out on
    the weights' mesh with ``train.sharding.cache_specs`` placements (the
    sequence over the model axis), as decode takes it."""

    @torch.no_grad()
    def prefill(params, batch):
        b = batch.get("tokens", batch.get("embeds")).shape[0]
        s = _total_len(cfg, batch)
        cache = TR.init_cache(cfg, b, s, device=params.embed.device)
        feats, cache, _ = TR.forward(cfg, params, batch, mode="prefill",
                                     cache=cache, hints=hints)
        if isinstance(params.embed, DTensor):
            cache = _cache_on_mesh(cfg, cache, params.embed.device_mesh)
        with hints.context():
            return TR.lm_head(cfg, params, feats[:, -1:]), cache

    return prefill


def _cache_on_mesh(cfg: ModelConfig, cache, mesh):
    """Each cache leaf redistributed to its ``cache_specs`` placements (a
    plain leaf, such as the positions, first taken as replicated)."""
    def place(t, spec):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        want = placements(spec, mesh)
        return t if tuple(t.placements) == want else t.redistribute(mesh,
                                                                    want)
    return [{k: place(v, specs[k]) for k, v in layer.items()}
            for layer, specs in zip(cache, cache_specs(cfg, mesh))]


def make_decode(cfg: ModelConfig, *, hints=TR.NO_HINTS):
    @torch.no_grad()
    def decode(params, cache, batch, pos):
        return TR.forward(cfg, params, batch, mode="decode", cache=cache,
                          pos=pos, hints=hints)

    return decode


def _total_len(cfg: ModelConfig, batch) -> int:
    if cfg.frontend == "vision":
        return batch["embeds"].shape[1] + batch["tokens"].shape[1]
    if cfg.frontend == "audio":
        return batch["embeds"].shape[1]
    return batch["tokens"].shape[1]
