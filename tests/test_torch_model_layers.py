"""The model side's layer functions in the port (``repro_torch.models``)
against the JAX package's (``repro.models``), in float32 on the CPU.

Every input is drawn once with numpy from a seed and handed to both
packages. Tolerance: atol = rtol = 1e-4 (float32; the two packages sum in
different orders — the RG-LRU scan's tree in particular — which moves
results by a few float32 ulps, far below it). MoE's ``dropped_frac``, a
count of capacity drops, must be equal exactly: with normal draws no two
router probabilities tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import rglru as JR
from repro.models import rwkv as JW
from repro.models.config import MoEConfig
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import rglru as TR
from repro_torch.models import rwkv as TW

TOL = 1e-4


def close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def both(a):
    """The same numpy array for the JAX package and for the port."""
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def both_tree(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


def test_rms_norm_rotary_sinusoidal(rng):
    x, tx = both(normal(rng, 2, 12, 4, 16))
    s, ts = both(normal(rng, 16))
    close(TL.rms_norm(tx, ts, 1e-6), JL.rms_norm(x, s, 1e-6))
    pos1 = np.arange(3, 15, dtype=np.int32)
    pos2 = rng.integers(0, 500, (2, 12)).astype(np.int32)
    for pos in (pos1, pos2):
        jp, tp = both(pos)
        close(TL.rotary(tx, tp, 1e6), JL.rotary(x, jp, 1e6))
    jp, tp = both(pos1)
    close(TL.sinusoidal(tp, 64), JL.sinusoidal(jp, 64))


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("unroll_q", [False, True])
def test_chunked_attention(window, softcap, unroll_q, rng):
    b, t, h, hkv, d = 2, 128, 4, 2, 16
    q, tq = both(normal(rng, b, t, h, d))
    k, tk = both(normal(rng, b, t, hkv, d))
    v, tv = both(normal(rng, b, t, hkv, d))
    pos, tpos = both(np.arange(t, dtype=np.int32))
    kw = dict(scale=d ** -0.5, window=window, softcap=softcap, q_chunk=32,
              kv_chunk=32, unroll_q=unroll_q)
    close(TL.chunked_attention(tq, tk, tv, q_positions=tpos,
                               k_positions=tpos, **kw),
          JL.chunked_attention(q, k, v, q_positions=pos, k_positions=pos,
                               **kw))


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("softcap", [None, 50.0])
def test_decode_attention(window, softcap, rng):
    b, s, h, hkv, d = 2, 24, 4, 2, 16
    q, tq = both(normal(rng, b, 1, h, d))
    k, tk = both(normal(rng, b, s, hkv, d))
    v, tv = both(normal(rng, b, s, hkv, d))
    # a ring cache: slots hold positions 20..43 out of order, two empty
    kpos = (np.arange(s) + 20).astype(np.int32)[None].repeat(b, 0)
    kpos[:, [3, 17]] = 2 ** 30
    kp, tkp = both(rng.permuted(kpos, axis=1))
    kw = dict(scale=d ** -0.5, window=window, softcap=softcap)
    close(TL.decode_attention(tq, tk, tv, k_positions=tkp, q_position=40,
                              **kw),
          JL.decode_attention(q, k, v, k_positions=kp, q_position=40, **kw))


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_mlp(act, rng):
    x, tx = both(normal(rng, 2, 8, 32))
    ws = [both(normal(rng, *shp, scale=0.2))
          for shp in ((32, 64), (32, 64), (64, 32))]
    close(TL.mlp(tx, *[w[1] for w in ws], act),
          JL.mlp(x, *[w[0] for w in ws], act))


@pytest.mark.parametrize("cf,group_len", [(4.0, None), (0.25, None),
                                          (1.25, 8)])
def test_moe_ffn(cf, group_len, rng):
    g, t, d, e, k, f = 2, 16, 8, 4, 2, 12
    cfg = MoEConfig(num_experts=e, top_k=k, d_ff_expert=f,
                    capacity_factor=cf, group_len=group_len)
    tcfg = TM.MoEConfig(**cfg.__dict__)
    x, tx = both(normal(rng, g, t, d))
    wr, twr = both(normal(rng, d, e))
    ws = [both(normal(rng, *shp, scale=0.2))
          for shp in ((e, d, f), (e, d, f), (e, f, d))]
    out, mm = JM.moe_ffn(cfg, x, wr, *[w[0] for w in ws])
    tout, tmm = TM.moe_ffn(tcfg, tx, twr, *[w[1] for w in ws])
    close(tout, out)
    close(tmm.aux_loss, mm.aux_loss)
    assert float(tmm.dropped_frac) == float(mm.dropped_frac)
    if cf != 1.25:
        assert (float(mm.dropped_frac) > 0) == (cf < 1)


def test_top_k_keeps_the_lower_index_among_ties():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = TM.top_k(probs, 2)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(want_idx).tolist() == [[1, 2], [0, 1]]
    close(vals, want_vals)


def rglru_params(rng, d, r, h, width=4):
    blk = r // h
    return {"w_x": normal(rng, d, r, scale=d ** -0.5),
            "w_g": normal(rng, d, r, scale=d ** -0.5),
            "conv_w": normal(rng, width, r, scale=0.5),
            "w_i": normal(rng, h, blk, blk, scale=0.3),
            "w_a": normal(rng, h, blk, blk, scale=0.3),
            "b_i": normal(rng, r, scale=0.1), "b_a": normal(rng, r, scale=0.1),
            "lam": normal(rng, r), "w_o": normal(rng, r, d, scale=r ** -0.5)}


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_block_and_step(with_state, rng):
    b, t, d, r, h = 2, 37, 16, 32, 4
    p, tp = both_tree(rglru_params(rng, d, r, h))
    u, tu = both(normal(rng, b, t, d))
    st = tst = None
    if with_state:
        h0, th0 = both(normal(rng, b, r))
        c0, tc0 = both(normal(rng, b, 3, r))
        st, tst = JR.RecState(h0, c0), TR.RecState(th0, tc0)
    out, new = JR.rglru_block(p, u, st)
    tout, tnew = TR.rglru_block(tp, tu, tst)
    close(tout, out)
    close(tnew.h, new.h)
    close(tnew.conv, new.conv)
    # then one decode step from that state
    u1, tu1 = both(normal(rng, b, 1, d))
    out1, new1 = JR.rglru_step(p, u1, new)
    tout1, tnew1 = TR.rglru_step(tp, tu1, tnew)
    close(tout1, out1)
    close(tnew1.h, new1.h)
    close(tnew1.conv, new1.conv)


def test_rglru_log_step_scan_matches_the_recurrence(rng):
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 100, 8)).astype(np.float32))
    x = torch.from_numpy(normal(rng, 2, 100, 8))
    a_s, h = TR.linear_scan(a, x)
    hs, prod, hp = [], torch.ones(2, 8), torch.zeros(2, 8)
    for i in range(100):
        hp = a[:, i] * hp + x[:, i]
        prod = prod * a[:, i]
        hs.append(hp)
        torch.testing.assert_close(a_s[:, i], prod, rtol=TOL, atol=TOL)
    torch.testing.assert_close(h, torch.stack(hs, 1), rtol=TOL, atol=TOL)


def rwkv_params(rng, d, f, hk, lora=64):
    h = d // hk
    p = {"u": normal(rng, h, hk, scale=0.5), "w0": normal(rng, d, scale=0.5),
         "w_lora_a": normal(rng, d, lora, scale=d ** -0.5),
         "w_lora_b": normal(rng, lora, d, scale=lora ** -0.5),
         "cm_w_r": normal(rng, d, d, scale=d ** -0.5),
         "cm_w_k": normal(rng, d, f, scale=d ** -0.5),
         "cm_w_v": normal(rng, f, d, scale=f ** -0.5)}
    for n in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "cm_mu_r", "cm_mu_k"):
        p[n] = rng.uniform(0, 1, d).astype(np.float32)
    for n in ("w_r", "w_k", "w_v", "w_g", "w_o"):
        p[n] = normal(rng, d, d, scale=d ** -0.5)
    return p


@pytest.mark.parametrize("t,chunk,with_state", [
    (64, 16, False),     # chunked WKV, 4 chunks
    (64, 16, True),
    (40, 16, False),     # t % chunk != 0: sequential
    (24, 0, True),       # chunk 0: sequential
    (1, 16, True),       # decode's T = 1: sequential
])
def test_time_mix_and_channel_mix(t, chunk, with_state, rng):
    b, d, f, hk = 2, 32, 48, 8
    p, tp = both_tree(rwkv_params(rng, d, f, hk))
    x, tx = both(normal(rng, b, t, d))
    st = tst = None
    if with_state:
        s0, ts0 = both(normal(rng, b, d // hk, hk, hk, scale=0.3))
        ltm, tltm = both(normal(rng, b, d))
        lcm, tlcm = both(normal(rng, b, d))
        st, tst = JW.RwkvState(s0, ltm, lcm), TW.RwkvState(ts0, tltm, tlcm)
    out, s_fin, last = JW.time_mix(p, x, hk, st, chunk=chunk)
    tout, ts_fin, tlast = TW.time_mix(tp, tx, hk, tst, chunk=chunk)
    close(tout, out)
    close(ts_fin, s_fin)
    close(tlast, last)
    cm, cm_last = JW.channel_mix(p, x, st)
    tcm, tcm_last = TW.channel_mix(tp, tx, tst)
    close(tcm, cm)
    close(tcm_last, cm_last)


def test_wkv_chunked_matches_sequential_under_strong_decay(rng):
    """The port's chunked WKV against the JAX package's sequential one,
    with decays down to 1e-6 (exponents bounded, no overflow)."""
    b, t, h, k = 2, 64, 2, 8
    r, tr = both(normal(rng, b, t, h, k))
    kk, tkk = both(normal(rng, b, t, h, k))
    v, tv = both(normal(rng, b, t, h, k))
    u, tu = both(normal(rng, h, k))
    s0, ts0 = both(normal(rng, b, h, k, k))
    w, tw = both(rng.uniform(1e-6, 0.05, (b, t, h, k)).astype(np.float32))
    o, s = JW._wkv_sequential(r, kk, v, w, u, s0)
    to, ts = TW._wkv_chunked(tr, tkk, tv, tw, tu, ts0, 16)
    close(to, o)
    close(ts, s)
