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

Under a mesh (``x`` a DTensor) the groups shard over the data axes, as the
JAX hints keep them: the routing — router logits, top-k, the sort, the
capacity scatter and the combine — runs on each rank's own groups
(``to_local`` / ``from_local`` over G), so routing issues no collective;
the expert products run as DTensor products over the stacked weights,
their activations f-sharded over the model axis; the aux loss and the drop
fraction average the local means over the data ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.models.config import MoEConfig
from repro_torch.models.params import Spec


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor       # load-balance loss (Switch-style)
    dropped_frac: torch.Tensor   # tokens dropped by capacity


def top_k(probs, k: int):
    """(values, indices) of the k largest entries of the last axis; ties
    keep the lower index first."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(cfg: MoEConfig, x, wr, wg, wu, wd, hints=None):
    """x: [G, T, d]; wr: [d, E]; wg/wu: [E, d, f]; wd: [E, f, d].

    ``hints``: ShardingHints; a DTensor ``x`` needs hints that name the
    data axes (the axes its groups shard over).

    Returns (y [G, T, d], MoEMetrics).
    """
    # long sequences: split rows into routing groups of group_len tokens
    gl = cfg.group_len
    if gl is not None and x.shape[1] > gl and x.shape[1] % gl == 0:
        g0, t0, d0 = x.shape
        out, mm = moe_ffn(dataclasses.replace(cfg, group_len=None),
                          x.reshape(g0 * (t0 // gl), gl, d0), wr, wg, wu, wd,
                          hints=hints)
        return out.reshape(g0, t0, d0), mm
    if not isinstance(x, DTensor):
        out, means = _moe_local(cfg, x, wr, lambda h: _experts(h, wg, wu, wd))
        return out, _metrics(cfg, *means)
    if hints is None or hints.data_axes is None:
        raise ValueError("moe_ffn: a sharded x needs ShardingHints naming "
                         "the data axes its groups shard over")
    mesh = x.device_mesh
    groups = hints.batch_only(x)                  # G over the data axes
    rows = groups.placements
    # the ranks' gradients of the router differ by their groups: summed
    # over the data dims, the same on the model dim
    over_data = [Replicate() if p == Replicate() else Partial()
                 for p in rows]
    wr = wr.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=over_data)
    ranks = math.prod(mesh.size(i) for i, p in enumerate(rows)
                      if p != Replicate())

    def experts(h):                               # [G_loc, E, cap, d]
        hd = DTensor.from_local(h, mesh, rows, run_check=False)
        y = _experts(hd, wg, wu, wd, hints)
        return hints.batch_only(y).to_local()

    out, means = _moe_local(cfg, groups.to_local(), wr, experts)
    # the local means, averaged over the ranks G shards across (a sum of
    # the means / ranks, whose gradient is 1 / ranks on each)
    means = [DTensor.from_local(v / ranks, mesh, over_data, run_check=False)
             .redistribute(mesh, [Replicate()] * mesh.ndim) for v in means]
    return (DTensor.from_local(out, mesh, rows, run_check=False),
            _metrics(cfg, *means))


def _experts(h, wg, wu, wd, hints=None):
    """The grouped expert FFN: h [G, E, cap, d] -> [G, E, cap, d]. Under
    hints the weights are gathered over their FSDP dim and keep f sharded
    over the model axis, as the activations are."""
    if hints is not None:
        mp = hints.model_axis
        wg, wu = (hints.constrain(w, Spec(None, None, mp)) for w in (wg, wu))
        wd = hints.constrain(wd, Spec(None, mp, None))
    a = torch.einsum("gecd,edf->gecf", h, wg)
    b = torch.einsum("gecd,edf->gecf", h, wu)
    if hints is not None:
        act_spec = Spec(hints.data_axes, None, None, hints.model_axis)
        a, b = hints.constrain(a, act_spec), hints.constrain(b, act_spec)
    act = F.silu(a.float()).to(h.dtype) * b
    return torch.einsum("gecf,efd->gecd", act, wd)


def _moe_local(cfg: MoEConfig, x, wr, experts):
    """The routing on plain tensors (all groups, or a rank's own): x
    [G, T, d], wr [d, E]; ``experts(h)`` the expert FFN on the dispatch
    buffer [G, E, cap, d]. Returns (y [G, T, d], (f_e, p_e, dropped)): the
    expert load and router probability means and the drop fraction over
    these groups."""
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

    y = experts(xbuf[:, : e * cap].reshape(g_, e, cap, d))

    ybuf = torch.cat([y.reshape(g_, e * cap, d),
                      torch.zeros((g_, 1, d), dtype=y.dtype, device=dev)],
                     dim=1)
    y_sorted = torch.gather(ybuf, 1, slot[..., None].expand(g_, tk, d))
    y_flat = torch.zeros((g_, tk, d), dtype=y.dtype, device=dev)
    y_flat.scatter_(1, order[..., None].expand(g_, tk, d), y_sorted)
    y_tok = y_flat.reshape(g_, t, k, d)
    out = torch.sum(y_tok * gate[..., None].to(y.dtype), dim=2)

    f_e = F.one_hot(eidx, e).float().sum(dim=2).mean(dim=(0, 1))
    p_e = probs.mean(dim=(0, 1))
    return out, (f_e, p_e, 1.0 - keep.float().mean())


def _metrics(cfg: MoEConfig, f_e, p_e, dropped) -> MoEMetrics:
    """Switch-style load balance, E · Σ_e f_e · P_e, and the drop fraction
    from the routing's (f_e, p_e, dropped) means."""
    aux = cfg.num_experts * torch.sum(f_e * p_e) * cfg.router_aux_weight
    return MoEMetrics(aux_loss=aux, dropped_frac=dropped)
