"""Prefill and decode steps, the serving half of ``repro.train.steps``
(PyTorch port). ``make_prefill`` / ``make_decode`` close over the config
and run without autograd; the training half (``TrainState``,
``make_loss_fn``, ``make_train_step``) comes with the training slice.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as TR
from repro_torch.models.config import ModelConfig


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
