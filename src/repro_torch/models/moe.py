"""Mixture-of-Experts FFN with sort-based (ragged) dispatch, PyTorch port of
``repro.models.moe``.

Tokens are grouped by batch row (or into ``group_len`` routing groups),
bucketed to experts by a stable sort under a per-group capacity, processed
by grouped products over the stacked expert weights, and combined with
renormalised top-k gate weights. Over-capacity assignments go to a dummy
slot (``e·cap``) and count as dropped.

Top-k takes a stable descending sort of the fp32 router probabilities, so
that among equal probabilities the lower expert index wins on every
device, as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import MoEConfig


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor       # load-balance loss (Switch-style)
    dropped_frac: torch.Tensor   # tokens dropped by capacity


def top_k(probs, k: int):
    """(values, indices) of the k largest entries of the last axis; ties
    keep the lower index first."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(cfg: MoEConfig, x, wr, wg, wu, wd):
    """x: [G, T, d]; wr: [d, E]; wg/wu: [E, d, f]; wd: [E, f, d].

    Returns (y [G, T, d], MoEMetrics).
    """
    # long sequences: split rows into routing groups of group_len tokens
    gl = cfg.group_len
    if gl is not None and x.shape[1] > gl and x.shape[1] % gl == 0:
        g0, t0, d0 = x.shape
        out, mm = moe_ffn(dataclasses.replace(cfg, group_len=None),
                          x.reshape(g0 * (t0 // gl), gl, d0), wr, wg, wu, wd)
        return out.reshape(g0, t0, d0), mm
    g_, t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = max(int(t * k / e * cfg.capacity_factor), 1)
    dev = x.device

    logits = x.float() @ wr.float()
    probs = torch.softmax(logits, dim=-1)                       # fp32
    gate, eidx = top_k(probs, k)                                # [G, T, K]
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)

    tk = t * k
    ids = eidx.reshape(g_, tk)
    sids, order = torch.sort(ids, dim=-1, stable=True)          # [G, TK]
    tok = order // k                                            # source token

    counts = torch.zeros((g_, e), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, sids, torch.ones_like(sids))
    offsets = torch.cumsum(counts, dim=-1) - counts             # exclusive
    pos = torch.arange(tk, device=dev)[None, :] - torch.gather(offsets, 1,
                                                               sids)
    keep = pos < cap
    slot = torch.where(keep, sids * cap + pos, e * cap)         # dummy slot

    x_sorted = torch.gather(x, 1, tok[..., None].expand(g_, tk, d))
    xbuf = torch.zeros((g_, e * cap + 1, d), dtype=x.dtype, device=dev)
    xbuf.scatter_(1, slot[..., None].expand(g_, tk, d),
                  torch.where(keep[..., None], x_sorted, 0))

    h = xbuf[:, : e * cap].reshape(g_, e, cap, d)
    a = torch.einsum("gecd,edf->gecf", h, wg)
    b = torch.einsum("gecd,edf->gecf", h, wu)
    act = F.silu(a.float()).to(x.dtype) * b
    y = torch.einsum("gecf,efd->gecd", act, wd)

    ybuf = torch.cat([y.reshape(g_, e * cap, d),
                      torch.zeros((g_, 1, d), dtype=y.dtype, device=dev)],
                     dim=1)
    y_sorted = torch.gather(ybuf, 1, slot[..., None].expand(g_, tk, d))
    y_flat = torch.zeros((g_, tk, d), dtype=y.dtype, device=dev)
    y_flat.scatter_(1, order[..., None].expand(g_, tk, d), y_sorted)
    y_tok = y_flat.reshape(g_, t, k, d)
    out = torch.sum(y_tok * gate[..., None].to(y.dtype), dim=2)

    # Switch-style load balance: E · Σ_e f_e · P_e
    f_e = F.one_hot(eidx, e).float().sum(dim=2).mean(dim=(0, 1))
    p_e = probs.mean(dim=(0, 1))
    aux = e * torch.sum(f_e * p_e) * cfg.router_aux_weight
    dropped = 1.0 - keep.float().mean()
    return out, MoEMetrics(aux_loss=aux, dropped_frac=dropped)
