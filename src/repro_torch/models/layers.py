"""Shared neural layers: norms, rotary embeddings, chunked attention, MLPs
(PyTorch port of ``repro.models.layers``).

Attention never materialises the [Tq, Tk] score matrix: it streams KV
chunks with an online-softmax accumulator (fp32). ``unroll_q=True`` takes
the triangular schedule (KV chunks past a q chunk's causal frontier are
skipped); the default visits every tile and masks, as the JAX scan does.
Every cast sits where the JAX package has it: products that JAX asks for
with ``preferred_element_type=float32`` take fp32 operands (a bf16 value
is exact in fp32), and the probabilities are cast to ``v.dtype`` before
the PV product.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -2.0 ** 30


def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def _freqs(half: int, theta: float, device):
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def rotary(x, positions, theta: float = 10000.0):
    """x: [B, T, H, D]; positions: [T] or [B, T]."""
    d = x.shape[-1]
    half = d // 2
    freqs = _freqs(half, theta, x.device)
    ang = positions[..., None].float() * freqs            # [T | B, T, half]
    ang = ang[None, :, None, :] if positions.dim() == 1 else ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal(positions, d_model: int):
    half = d_model // 2
    freqs = _freqs(half, 10000.0, positions.device)
    ang = positions[:, None].float() * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _softcap(scores, cap: Optional[float]):
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def _tile_mask(qpos, kpos, window: Optional[int]):
    """bool [.., Tq, Tk]: causal ∧ (window)."""
    m = kpos[..., None, :] <= qpos[..., :, None]
    if window is not None:
        m &= kpos[..., None, :] > (qpos[..., :, None] - window)
    return m


def _attend_tile(q, k, v, qpos, kpos, *, scale, window, softcap, m_prev,
                 l_prev, acc):
    """One online-softmax step over a KV tile.

    q: [B, Tq, Hkv, R, D]; k/v: [B, Tk, Hkv, D]; accumulators fp32.
    """
    s = torch.einsum("bqhrd,bkhd->bhrqk", q.float(), k.float()) * scale
    s = _softcap(s, softcap)
    mask = _tile_mask(qpos, kpos, window)                 # [Tq, Tk]
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m_prev - m_new)
    l_new = l_prev * corr + p.sum(dim=-1)
    pv = torch.einsum("bhrqk,bkhd->bhrqd", p.to(v.dtype).float(), v.float())
    return m_new, l_new, acc * corr[..., None] + pv


def chunked_attention(
    q, k, v, *,
    q_positions, k_positions,
    scale: float,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    unroll_q: bool = False,
):
    """q: [B, Tq, H, D]; k/v: [B, Tk, Hkv, D] -> [B, Tq, H, D].

    ``q_positions``/``k_positions`` are absolute positions ([Tq]/[Tk]); the
    causal/window mask is evaluated per tile from them.
    """
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    r = h // hkv
    qg = q.reshape(b, tq, hkv, r, d)

    qc = min(q_chunk, tq)
    kc = min(kv_chunk, tk)
    assert tq % qc == 0 and tk % kc == 0, (tq, qc, tk, kc)
    nq, nk = tq // qc, tk // kc

    outs = []
    for iq in range(nq):
        if unroll_q and tq == tk:
            # causal frontier: kv blocks strictly after this q block's last
            # position can never attend (assumes monotone positions)
            n_kv = max(int(min(nk, math.ceil((iq + 1) * qc / kc))), 1)
        else:
            n_kv = nk
        qs = qg[:, iq * qc:(iq + 1) * qc]
        qp = q_positions[iq * qc:(iq + 1) * qc]
        m = torch.full((b, hkv, r, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hkv, r, qc), dtype=torch.float32, device=q.device)
        a = torch.zeros((b, hkv, r, qc, d), dtype=torch.float32,
                        device=q.device)
        for ik in range(n_kv):
            sl = slice(ik * kc, (ik + 1) * kc)
            m, l, a = _attend_tile(qs, k[:, sl], v[:, sl], qp,
                                   k_positions[sl], scale=scale,
                                   window=window, softcap=softcap,
                                   m_prev=m, l_prev=l, acc=a)
        out = a / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.to(q.dtype))                      # [B,Hkv,R,qc,D]
    out = torch.cat(outs, dim=3)                          # [B,Hkv,R,Tq,D]
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, h, d)


def decode_attention(q, k, v, *, k_positions, q_position, scale,
                     window=None, softcap=None):
    """Single-step attention over a (possibly ring) cache.

    q: [B, 1, H, D]; k/v: [B, S, Hkv, D]; k_positions: [B, S] absolute
    positions (empty slots = huge sentinel so causal masks them).
    """
    b, _, h, d = q.shape
    hkv = k.shape[2]
    r = h // hkv
    qg = q.reshape(b, hkv, r, d)
    s = torch.einsum("bhrd,bkhd->bhrk", qg.float(), k.float()) * scale
    s = _softcap(s, softcap)
    mask = k_positions <= q_position                       # [B, S]
    if window is not None:
        mask &= k_positions > (q_position - window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhrk,bkhd->bhrd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def mlp(x, wg, wu, wd, act: str = "swiglu"):
    """Gated MLP. x: [B, T, d]; wg/wu: [d, f]; wd: [f, d]."""
    g = x @ wg
    u = x @ wu
    if act == "swiglu":
        h = F.silu(g.float()).to(x.dtype) * u
    elif act == "geglu":
        h = gelu_tanh(g.float()).to(x.dtype) * u
    else:
        raise ValueError(act)
    return h @ wd
