"""Losses, PyTorch port of ``repro.train.losses``. Cross-entropy runs over
sequence chunks, each under ``torch.utils.checkpoint``, so the full
[B, S, V] logits are never held: backward recomputes one chunk's
[B, c, V] float32 logits (2.5 GB at a 151,936 vocab, B 4, c 1,024)
instead of keeping every chunk's."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as CK

from repro_torch.models import transformer as TR


def _chunk_ce(cfg, params, fc, lc, mc):
    logits = TR.lm_head(cfg, params, fc).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
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
