"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427),
PyTorch port of ``repro.models.rglru``.

Block structure (mixer only; norms/residual live in the transformer):

    x_b = W_x·u ;  g_b = W_g·u                 (two linear branches)
    x_c = causal_conv1d(x_b, width=4)
    i_t = σ(BD_i(x_c)) ;  r_t = σ(BD_a(x_c))   (block-diagonal gates)
    a_t = exp(-c · r_t · softplus(Λ)),  c = 8
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_c)
    out = W_o · (GeLU(g_b) ⊙ h)

The linear recurrence runs in fp32 as a log-step (Hillis–Steele) scan over
time with the JAX package's ``combine`` — ⌈log₂ T⌉ whole-tensor steps
where ``jax.lax.associative_scan`` has its own tree — so a 2,048-token
prefill is 11 steps, not 2,048. Decode is the O(1) single-step update.
Cache = (h, last conv taps).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import gelu_tanh

RG_LRU_C = 8.0


class RecState(NamedTuple):
    h: torch.Tensor        # [B, R] fp32
    conv: torch.Tensor     # [B, W-1, R] previous inputs


def _block_diag(x, w):
    """x: [B, T, R]; w: [H, R/H, R/H] block-diagonal linear."""
    h = w.shape[0]
    b, t, r = x.shape
    xh = x.reshape(b, t, h, r // h)
    return torch.einsum("bthk,hkj->bthj", xh, w).reshape(b, t, r)


def _causal_conv(x, w, prev: Optional[torch.Tensor]):
    """Depthwise causal conv. x: [B, T, R]; w: [W, R]; prev: [B, W-1, R]."""
    width = w.shape[0]
    if prev is None:
        prev = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                           dtype=x.dtype, device=x.device)
    xp = torch.cat([prev, x], dim=1)
    t = x.shape[1]
    out = xp[:, 0:t] * w[0][None, None, :]
    for i in range(1, width):
        out = out + xp[:, i:i + t] * w[i][None, None, :]
    return out, xp[:, -(width - 1):]


def _gates(p, x_c):
    i_t = torch.sigmoid(_block_diag(x_c, p["w_i"]).float() + p["b_i"].float())
    r_t = torch.sigmoid(_block_diag(x_c, p["w_a"]).float() + p["b_a"].float())
    log_a = -RG_LRU_C * r_t * F.softplus(p["lam"].float())
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    gated = beta * i_t * x_c.float()
    return a, gated


def linear_scan(a, b):
    """Inclusive scan of h_t = a_t·h_{t-1} + b_t over axis 1 (h_{-1} = 0):
    (Π a, h), by doubling strides with ``combine((a1, b1), (a2, b2)) =
    (a1·a2, a2·b1 + b2)``."""
    t = a.shape[1]
    d = 1
    while d < t:
        a_new, b_new = a.clone(), b.clone()
        b_new[:, d:] = a[:, d:] * b[:, :-d] + b[:, d:]
        a_new[:, d:] = a[:, :-d] * a[:, d:]
        a, b = a_new, b_new
        d *= 2
    return a, b


def rglru_scan(p, x_c, h0=None):
    """Full-sequence recurrence. x_c: [B, T, R] -> h: [B, T, R] fp32."""
    a, gated = _gates(p, x_c)
    a_s, h = linear_scan(a, gated)
    if h0 is not None:
        h = h + a_s * h0[:, None, :]
    return h


def rglru_block(p, u, state: Optional[RecState] = None):
    """u: [B, T, d] -> (out [B, T, d], new_state). Train/prefill path."""
    x_b = u @ p["w_x"]
    g_b = u @ p["w_g"]
    prev = state.conv if state is not None else None
    x_c, conv_tail = _causal_conv(x_b, p["conv_w"], prev)
    h0 = state.h if state is not None else None
    h = rglru_scan(p, x_c, h0)
    gate = gelu_tanh(g_b.float())
    mixed = (gate * h).to(u.dtype)
    out = mixed @ p["w_o"]
    return out, RecState(h=h[:, -1], conv=conv_tail)


def rglru_step(p, u, state: RecState):
    """Single-token decode. u: [B, 1, d]."""
    x_b = u @ p["w_x"]
    g_b = u @ p["w_g"]
    x_c, conv_tail = _causal_conv(x_b, p["conv_w"], state.conv)
    a, gated = _gates(p, x_c)
    h = a[:, 0] * state.h + gated[:, 0]
    gate = gelu_tanh(g_b.float())
    out = (gate * h[:, None]).to(u.dtype) @ p["w_o"]
    return out, RecState(h=h, conv=conv_tail)
