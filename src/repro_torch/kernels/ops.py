"""Public entry points of the port's kernels (counterpart of
``repro.kernels.ops``). The JAX wrappers flatten and pad to TPU tiles; here
the kernels take the states' own layouts, so these are thin: they derive the
flags the engines pass and change layouts only where a caller's differs.
"""

from __future__ import annotations

import time

import torch

from repro_torch.kernels import common
from repro_torch.kernels import round_step as _rs
from repro_torch.kernels.buffer_fold import buffer_fold
from repro_torch.kernels.delta_extract import delta_extract
from repro_torch.kernels.digest_blocks import digest_blocks
from repro_torch.kernels.join import join
from repro_torch.kernels.lex_join import lex_join_delta
from repro_torch.kernels.masked_extract import masked_extract
from repro_torch.kernels.round_recv import round_recv
from repro_torch.kernels.round_step import round_step

__all__ = ["buffer_fold", "delta_extract", "digest_blocks", "join",
           "lex_join_delta", "masked_extract", "pack_bits", "round_recv",
           "sync_round", "sync_round_block", "unpack_bits"]


def sync_round_block(b: int, n: int, u: int, *, p: int, k: int,
                     per_origin: bool, kind: str = "max", elem_size: int = 4,
                     aligned: bool = True, device="cuda", tune_bench=None):
    """Resolve ``round_step``'s launch plan for these shapes — autotuned
    (``common.tuned_block``) among ``round_step.plans``, whose first,
    ``round_step.plan``, is the default.

    ``b``: configs, ``n``: nodes, ``u``: columns, ``p``: degree, ``k``:
    buffer slots (0 = state-based), ``elem_size``: bytes an element,
    ``aligned``: every operand 16-byte aligned; ``device`` names the card
    the key is for. ``tune_bench(plan)`` launches the kernel under a
    candidate (only called with ``REPRO_AUTOTUNE=1`` on a cache miss, and
    timed with CUDA events). Returns ``(Plan, source)``.
    """
    cands = _rs.plans(n, p, k, bool(per_origin), elem_size, u, bool(aligned))
    key = (common.backend_key(device), kind, f"p{p}", f"k{k}",
           f"po{int(bool(per_origin))}", f"n{n}",
           f"b{common.shape_bucket(b)}", f"u{common.shape_bucket(u)}",
           f"e{elem_size}", f"a{int(bool(aligned))}")
    timer = common.event_timer(device) \
        if tune_bench is not None and torch.device(device).type == "cuda" \
        else time.perf_counter
    bench = None if tune_bench is None \
        else (lambda cand: tune_bench(_rs.Plan(*cand)))
    cfg, source = common.tuned_block("round_step", key, cands, bench,
                                     timer=timer)
    return _rs.Plan(*cfg), source


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
