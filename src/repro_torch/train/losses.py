"""Losses, PyTorch port of ``repro.train.losses``. Cross-entropy runs over
sequence chunks, each under ``torch.utils.checkpoint``, so the full
[B, S, V] logits are never held: backward recomputes one chunk's
[B, c, V] float32 logits (2.5 GB at a 151,936 vocab, B 4, c 1,024)
instead of keeping every chunk's. Logits sharded over the vocab take
their reductions shard by shard (``_lse_gold``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils import checkpoint as CK

from repro_torch.models import transformer as TR
from repro_torch.models.params import shard_range


def _lse_gold(logits, labels):
    """(logsumexp over the vocab, the label's logit). On logits sharded
    over the vocab (a DTensor) both are reductions over the shards,
    combined across the model axis as [B, c] partials: a max and a sum of
    exponentials (``logsumexp`` would all-gather the [B, c, V] logits),
    and each rank's gather of the labels in its own vocab range, zero
    elsewhere (``gather`` has no sharded rule)."""
    if not isinstance(logits, DTensor):
        return (torch.logsumexp(logits, dim=-1),
                torch.gather(logits, -1, labels[..., None].long())[..., 0])
    m = logits.amax(dim=-1).detach()
    lse = m + torch.log(torch.exp(logits - m[..., None]).sum(dim=-1))
    mesh = logits.device_mesh
    vocab = [isinstance(pl, Shard) and pl.dim == logits.dim() - 1
             for pl in logits.placements]
    rows = [Replicate() if v else pl for v, pl in zip(vocab,
                                                      logits.placements)]
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    t = labels.redistribute(mesh, rows).to_local().long()
    lo, n = shard_range(logits, -1)
    local = torch.gather(logits.to_local(), -1,
                         (t - lo).clamp(0, n - 1)[..., None])[..., 0]
    local = local * ((t >= lo) & (t < lo + n)).to(local.dtype)
    gold = DTensor.from_local(local, mesh, [Partial() if v else r for v, r
                                            in zip(vocab, rows)],
                              run_check=False)
    return lse, gold


def _chunk_ce(cfg, params, fc, lc, mc):
    logits = TR.lm_head(cfg, params, fc).float()
    lse, gold = _lse_gold(logits, lc)
    return torch.sum((lse - gold) * mc), torch.sum(mc)


def chunked_cross_entropy(cfg, params, feats, labels, mask, chunk: int = 1024):
    """feats: [B, S, d]; labels/mask: [B, S]. Returns (loss sum, denom),
    float32 0-d tensors."""
    s = feats.shape[1]
    c = min(chunk, s)
    pad = (-s) % c                  # pad S to a multiple of the chunk
    if pad:
        feats = F.pad(feats, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=feats.device)
    den = torch.zeros((), dtype=torch.float32, device=feats.device)
    for i in range(feats.shape[1] // c):
        sl = slice(i * c, (i + 1) * c)
        args = (cfg, params, feats[:, sl], labels[:, sl],
                mask[:, sl].to(torch.float32))
        if torch.is_grad_enabled():
            ce_sum, m_sum = CK.checkpoint(_chunk_ce, *args,
                                          use_reentrant=False)
        else:
            ce_sum, m_sum = _chunk_ce(*args)
        tot = tot + ce_sum
        den = den + m_sum
    return tot, den
