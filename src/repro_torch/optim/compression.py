"""Top-k gradient compression with error feedback, PyTorch port of
``repro.optim.compression``.

A compressed gradient keeps the ``frac`` largest-magnitude entries of
gradient + error (flat indices and values); what it leaves behind is the
next round's error, so over rounds every entry is transmitted (Stich et
al., "Sparsified SGD with Memory"). Ties in magnitude keep the lower index
first, as ``jax.lax.top_k`` does: the selection is a stable descending
sort, not ``torch.topk``, whose order among equal values is unspecified.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class CompressedGrad(NamedTuple):
    idx: torch.Tensor     # int32 [k] flat indices
    vals: torch.Tensor    # float32 [k]
    shape: tuple


def topk_compress(g: torch.Tensor, err: torch.Tensor, frac: float = 0.01):
    """Returns (compressed, new_err). ``err`` is the error-feedback carry."""
    flat = (g + err).reshape(-1).to(torch.float32)
    k = max(int(flat.shape[0] * frac), 1)
    order = torch.sort(flat.abs(), descending=True, stable=True).indices
    idx = order[:k]
    taken = flat[idx]
    new_flat = flat.clone()
    new_flat[idx] = 0.0
    return (CompressedGrad(idx=idx.to(torch.int32), vals=taken,
                           shape=tuple(g.shape)),
            new_flat.reshape(g.shape))


def decompress(c: CompressedGrad) -> torch.Tensor:
    out = torch.zeros((math.prod(c.shape),), dtype=torch.float32,
                      device=c.vals.device)
    out[c.idx.long()] = c.vals
    return out.reshape(c.shape)


def compression_ratio(c: CompressedGrad) -> float:
    return (2 * c.idx.shape[0]) / max(math.prod(c.shape), 1)
