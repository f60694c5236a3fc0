"""RWKV-6 ("Finch", arXiv:2404.05892) time-mix and channel-mix blocks,
PyTorch port of ``repro.models.rwkv``.

Time-mix with data-dependent per-channel decay:

    shifted token-mix:  x̂_* = x + μ_* ⊙ (shift(x) − x)   for * ∈ {r,k,v,w,g}
    decay:              w_t = exp(−exp(w0 + tanh(x̂_w A_w) B_w))   (LoRA)
    state:              S_t = diag(w_t) S_{t-1} + k_tᵀ v_t         [H, K, V]
    output:             o_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)

The WKV recurrence runs chunk by chunk (``_wkv_chunked``: intra-chunk
products with bounded exponents, the [B, H, K, V] state carried across
chunks) when ``chunk and t > 1 and t % chunk == 0``, and step by step
otherwise, decode's T = 1 included. The decay and state math is fp32.

Channel-mix (the RWKV FFN):  r = σ(x̂_r W_r);  y = r ⊙ ((relu(x̂_k W_k))² W_v)
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class RwkvState(NamedTuple):
    s: torch.Tensor          # [B, H, K, V] fp32 wkv state
    last_tm: torch.Tensor    # [B, d] last token input (time-mix shift)
    last_cm: torch.Tensor    # [B, d] last token input (channel-mix shift)


def _shift(x, last: Optional[torch.Tensor]):
    """Token shift: previous token's activations (zeros/cached at t=0)."""
    pad = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([pad.to(x.dtype), x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + mu[None, None, :] * (xs - x)


def _decay(p, xw):
    """Data-dependent decay w_t ∈ (0, 1): [B, T, d] -> fp32 [B, T, d]."""
    lora = xw @ p["w_lora_a"]
    lora = (torch.tanh(lora.float()).to(xw.dtype) @ p["w_lora_b"]).float()
    return torch.exp(-torch.exp(p["w0"].float()[None, None] + lora))


def time_mix(p, x, head_dim: int, state: Optional[RwkvState] = None,
             chunk: int = 32):
    """x: [B, T, d] -> (out [B, T, d], s_final, last_token)."""
    b, t, d = x.shape
    h = d // head_dim
    k_, v_ = head_dim, head_dim

    xs = _shift(x, state.last_tm if state is not None else None)
    xr = _mix(x, xs, p["mu_r"])
    xk = _mix(x, xs, p["mu_k"])
    xv = _mix(x, xs, p["mu_v"])
    xw = _mix(x, xs, p["mu_w"])
    xg = _mix(x, xs, p["mu_g"])

    r = (xr @ p["w_r"]).reshape(b, t, h, k_)
    k = (xk @ p["w_k"]).reshape(b, t, h, k_)
    v = (xv @ p["w_v"]).reshape(b, t, h, v_)
    g = F.silu((xg @ p["w_g"]).float())
    w = _decay(p, xw).reshape(b, t, h, k_)                    # fp32
    u = p["u"].float()                                        # [H, K]

    rf, kf, vf = r.float(), k.float(), v.float()
    s0 = (state.s if state is not None
          else torch.zeros((b, h, k_, v_), dtype=torch.float32,
                           device=x.device))

    if chunk and t > 1 and t % chunk == 0:
        o, s_fin = _wkv_chunked(rf, kf, vf, w, u, s0, chunk)
    else:
        o, s_fin = _wkv_sequential(rf, kf, vf, w, u, s0)
    o = o.reshape(b, t, d) * g.reshape(b, t, d)
    out = o.to(x.dtype) @ p["w_o"]
    return out, s_fin, x[:, -1]


def _wkv_sequential(rf, kf, vf, w, u, s0):
    s = s0
    outs = []
    for i in range(rf.shape[1]):
        rt, kt, vt, wt = rf[:, i], kf[:, i], vf[:, i], w[:, i]  # [B, H, K/V]
        kv = kt[..., :, None] * vt[..., None, :]              # [B, H, K, V]
        outs.append(torch.einsum("bhk,bhkv->bhv", rt,
                                 s + u[None, :, :, None] * kv))
        s = wt[..., :, None] * s + kv
    return torch.stack(outs, dim=1), s


def _wkv_chunked(rf, kf, vf, w, u, s0, c: int):
    b, t, h, k_ = rf.shape
    v_ = vf.shape[-1]
    n = t // c

    def resh(a):
        return a.reshape(b, n, c, h, a.shape[-1])

    rc, kc, vc, wc = resh(rf), resh(kf), resh(vf), resh(w)
    lw = torch.log(torch.clamp(wc, min=1e-30))                # [B,N,C,H,K]
    L = torch.cumsum(lw, dim=2)                               # inclusive
    L_prev = torch.cat([torch.zeros_like(L[:, :, :1]), L[:, :, :-1]],
                       dim=2)                                 # L_{i-1}
    L_tot = L[:, :, -1]                                       # [B,N,H,K]

    # intra-chunk attention with bounded exponents:
    #   A_ij = Σ_k r_i k_j exp(L_{i-1} − L_j)   (j < i)
    ar = torch.arange(c, device=rf.device)
    mask = (ar[:, None] > ar[None, :])[None, :, :, None, None]  # i > j

    s = s0
    outs = []
    for ci in range(n):
        r_i, k_i, v_i = rc[:, ci], kc[:, ci], vc[:, ci]       # [B,C,H,*]
        L_i, Lp_i, Lt_i = L[:, ci], L_prev[:, ci], L_tot[:, ci]
        E = Lp_i[:, :, None] - L_i[:, None, :, :]             # [B,C,C,H,K]
        E = torch.where(mask, E, -torch.inf)
        A = torch.einsum("bihk,bjhk,bijhk->bijh", r_i, k_i, torch.exp(E))
        diag = torch.einsum("bihk,hk,bihk->bih", r_i, u, k_i)
        o_intra = torch.einsum("bijh,bjhv->bihv", A, v_i)
        o_intra = o_intra + diag[..., None] * v_i
        o_cross = torch.einsum("bihk,bhkv->bihv", r_i * torch.exp(Lp_i), s)
        # state to end of chunk: decay old + inject new (exponents ≤ 0)
        k_dec = k_i * torch.exp(Lt_i[:, None] - L_i)
        s = (torch.exp(Lt_i)[..., None] * s
             + torch.einsum("bihk,bihv->bhkv", k_dec, v_i))
        outs.append(o_intra + o_cross)
    o = torch.stack(outs, dim=1).reshape(b, t, h, v_)
    return o, s


def channel_mix(p, x, state: Optional[RwkvState] = None):
    xs = _shift(x, state.last_cm if state is not None else None)
    xr = _mix(x, xs, p["cm_mu_r"])
    xk = _mix(x, xs, p["cm_mu_k"])
    r = torch.sigmoid((xr @ p["cm_w_r"]).float())
    kk = xk @ p["cm_w_k"]
    kk = torch.square(F.relu(kk.float())).to(x.dtype)
    y = kk @ p["cm_w_v"]
    return r.to(x.dtype) * y, x[:, -1]


def rwkv_block(p, x, head_dim: int, state: Optional[RwkvState] = None):
    """Full RWKV layer (time-mix + channel-mix with their own norms is
    assembled by the transformer; this returns the time-mix output and the
    new state)."""
    tm_out, s_fin, last_tm = time_mix(p, x, head_dim, state)
    return tm_out, RwkvState(
        s=s_fin, last_tm=last_tm,
        last_cm=(state.last_cm if state is not None
                 else torch.zeros_like(last_tm)),
    )
