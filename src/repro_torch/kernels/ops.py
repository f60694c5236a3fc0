"""Public entry points of the port's kernels (counterpart of
``repro.kernels.ops``). The JAX wrappers flatten and pad to TPU tiles; here
the kernels take the states' own layouts, so these are thin: they derive the
flags the engines pass and change layouts only where a caller's differs.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.buffer_fold import buffer_fold
from repro_torch.kernels.delta_extract import delta_extract
from repro_torch.kernels.digest_blocks import digest_blocks
from repro_torch.kernels.join import join
from repro_torch.kernels.lex_join import lex_join_delta
from repro_torch.kernels.masked_extract import masked_extract
from repro_torch.kernels.merkle_descent import merkle_descent
from repro_torch.kernels.round_recv import round_recv
from repro_torch.kernels.round_step import round_step

__all__ = ["buffer_fold", "delta_extract", "digest_blocks", "join",
           "lex_join_delta", "masked_extract", "merkle_descent", "pack_bits",
           "round_recv", "sync_round", "unpack_bits"]


def sync_round(delta, x, buf, active, delivered, *, nbrs, rev,
               kind: str = "max", per_origin: bool = False,
               extracts: bool = False, want_inbox: bool = False):
    """One full Algorithm 1/2 round in one ``round_step`` launch, on the
    canonical operands of ``repro.kernels.ops.sync_round``: delta/x
    [B, N, U], buf [K, B, N, U] or None, active [B, N, P], delivered
    [B, N]. The masked inbox [P, B, N, U] comes out for the classic/bp
    flavours (buffered, not extracting), whose keep gate needs it, and
    for any flavour with ``want_inbox`` (the provenance replay); else it
    is None. Returns ``(x', buf', inbox, dsz_op, xsz, ssend, cnt,
    dsz)``."""
    has_buffer = buf is not None
    return round_step(delta, x, buf, active, delivered, nbrs, rev,
                      kind=kind, per_origin=per_origin,
                      extracts=bool(extracts and has_buffer),
                      emit_inbox=(has_buffer and not extracts) or want_inbox)


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """bool [..., U] -> int32 bit-views [..., ceil(U/32)], little-endian
    (the JAX package's uint32 words, viewed as int32)."""
    u = mask.shape[-1]
    m = torch.nn.functional.pad(mask.to(torch.int64), (0, (-u) % 32))
    m = m.reshape(mask.shape[:-1] + (-1, 32))
    w = (m << torch.arange(32, device=mask.device)).sum(-1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def unpack_bits(words: torch.Tensor, universe: int) -> torch.Tensor:
    """int32 bit-views [..., W] -> bool [..., universe]."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :universe].to(torch.bool)
