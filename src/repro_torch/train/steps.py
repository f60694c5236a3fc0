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
The JAX step's ``hints`` / ``grad_specs`` (shardings) have no meaning on
one card and are left out.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import transformer as TR
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import (AdamW, AdamWState, tree_leaves,
                                     tree_unflatten)
from repro_torch.train.losses import chunked_cross_entropy


class TrainState(NamedTuple):
    params: TR.Decoder     # bf16 working copy (float32 after microbatching)
    opt: AdamWState


def init_train_state(cfg: ModelConfig, optim: AdamW,
                     params: TR.Decoder) -> TrainState:
    return TrainState(params=params, opt=optim.init(params.tensors()))


def make_loss_fn(cfg: ModelConfig):
    def loss_fn(params, batch):
        feats, aux = TR.forward(cfg, params, batch, mode="train")
        tot, den = chunked_cross_entropy(cfg, params, feats, batch["labels"],
                                         batch["loss_mask"])
        ce = tot / torch.clamp(den, min=1.0)
        return ce + aux, {"ce": ce, "aux": aux, "tokens": den}

    return loss_fn


def make_grad_fn(cfg: ModelConfig, microbatches: int = 1):
    """``grad_fn(params, batch) -> (loss, metrics, grads)``, the JAX step's
    ``value_and_grad`` with its microbatch scan: ``grads`` has the tree of
    ``params.tensors()`` (a weight the loss does not reach gets zeros), in
    the weights' dtype, or float32 accumulated over ``microbatches``. It
    makes the model's weights trainable (``requires_grad``); serving runs
    them without autograd."""
    loss_fn = make_loss_fn(cfg)

    def one(params, batch):
        params.requires_grad_(True)
        leaves = tree_leaves(params.tensors())
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(leaves, grads)]
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
            for i in range(microbatches):
                l, m, g = one(params, {k: v[i * n:(i + 1) * n]
                                       for k, v in batch.items()})
                g = [gg.float() / microbatches for gg in g]
                grads = g if grads is None else [
                    a + gg for a, gg in zip(grads, g)]
                loss = loss + l / microbatches
                ms.append(m)
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        return loss, metrics, tree_unflatten(params.tensors(), iter(grads))

    return grad_fn


def make_train_step(cfg: ModelConfig, optim: AdamW, *,
                    microbatches: int = 1):
    """``train_step(state, batch) -> (new state, metrics)``: metrics ``ce``,
    ``aux``, ``tokens``, ``loss``, ``grad_norm`` and ``lr`` (0-d tensors on
    the device)."""
    grad_fn = make_grad_fn(cfg, microbatches)

    def train_step(state: TrainState, batch):
        loss, metrics, grads = grad_fn(state.params, batch)
        params, opt, opt_metrics = optim.update(grads, state.opt)
        del grads
        return (TrainState(params=TR.Decoder(cfg, params), opt=opt),
                dict(metrics, loss=loss, **opt_metrics))

    return train_step


def make_prefill(cfg: ModelConfig):
    """Full-sequence forward that also builds the KV cache (on the
    weights' device); returns the last-position logits (next-token) and
    the cache."""

    @torch.no_grad()
    def prefill(params, batch):
        b = batch.get("tokens", batch.get("embeds")).shape[0]
        s = _total_len(cfg, batch)
        cache = TR.init_cache(cfg, b, s, device=params.embed.device)
        feats, cache, _ = TR.forward(cfg, params, batch, mode="prefill",
                                     cache=cache)
        return TR.lm_head(cfg, params, feats[:, -1:]), cache

    return prefill


def make_decode(cfg: ModelConfig):
    @torch.no_grad()
    def decode(params, cache, batch, pos):
        return TR.forward(cfg, params, batch, mode="decode", cache=cache,
                          pos=pos)

    return decode


def _total_len(cfg: ModelConfig, batch) -> int:
    if cfg.frontend == "vision":
        return batch["embeds"].shape[1] + batch["tokens"].shape[1]
    if cfg.frontend == "audio":
        return batch["embeds"].shape[1]
    return batch["tokens"].shape[1]
