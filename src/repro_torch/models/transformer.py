"""Composable decoder-only stack covering all 10 assigned architectures,
PyTorch port of ``repro.models.transformer``.

Structure: embeddings → layers (the config's pattern repeated, then the
tail) → final norm → (tied/untied) LM head. A ``Decoder`` holds one
``nn.Module`` per layer in an ``nn.ModuleList``, by kind:

* ``AttentionLayer`` (``global``/``local``) — GQA attention (RoPE or
  sinusoidal, qk-norm, QKV bias, logit softcap, sliding window) + gated
  MLP or MoE
* ``RecurrentLayer`` (``rec``) — RG-LRU recurrent mixer + gated MLP
* ``RwkvLayer`` (``rwkv``) — RWKV-6 time-mix + channel-mix

A layer's weights carry the JAX package's names (``layer["wq"]``). Where the
JAX stack scans stacked group weights and then applies the tail layers,
the port loops over its layers; ``convert.params_to_torch`` unstacks a
JAX tree into them.

Execution modes: ``train``/``prefill`` (full sequences, chunked attention,
optionally building a cache) and ``decode`` (single token against a full
or ring cache / recurrent state). A cache is a list with one dict per
layer; decode writes each attention layer's k/v/position into its cache
tensors in place (slot ``pos % s`` of a ``local`` ring, ``min(pos, s-1)``
of a ``global`` cache) and returns the same list with the recurrent
states replaced.

The weights are created frozen (serving runs without autograd);
``train.steps.init_train_state`` makes them trainable. In ``train`` mode
with ``cfg.remat`` other than ``"none"``, each pattern group of the stack
is checkpointed (``torch.utils.checkpoint``, non-reentrant) as the JAX
package checkpoints its scanned group body; the tail layers are not.
``"nothing"`` keeps only a group's input for the backward pass;
``"dots"`` also keeps the outputs of the weight products (``mm`` and
``addmm``: products without batch dimensions, as
``checkpoint_dots_with_no_batch_dims`` keeps them) and recomputes the rest.
Remat changes no value, only what backward recomputes.

Sharding: the weights may be DTensors on a ``DeviceMesh`` with named dims
(``train.sharding.to_named``), the batch a DTensor sharded over the data
axes. ``ShardingHints`` are the JAX package's activation constraints:
``residual`` and ``batch_only`` redistribute a DTensor to their spec; on a
plain tensor, or with no axes (``NO_HINTS``), they return it unchanged, so
a step without a mesh runs exactly as before. Under a mesh the step runs
inside ``implicit_replication`` (``ShardingHints.context``): the positions,
masks and scalars the layers make as plain tensors count as replicated.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Dict

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils import checkpoint as CK

from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import rwkv as W
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (ParamDef, Spec, init_tree,
                                      placements, shard_range, tree_map)
from repro_torch.sync.simulator import resolve_device

POS_SENTINEL = 2 ** 30


# ---------------------------------------------------------------------------
# Sharding hints (activation constraints; no-ops without a mesh)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardingHints:
    """Activation sharding constraints applied inside the step."""
    data_axes: Any = None      # batch dim's mesh axes, e.g. ("pod", "data")
    model_axis: Any = None     # mesh axis for tp, e.g. "model"
    seq_shard: bool = False    # shard saved residual carries over seq

    @property
    def active(self) -> bool:
        return self.data_axes is not None or self.model_axis is not None

    def constrain(self, x, spec):
        """``x`` redistributed to ``spec`` on its mesh if it is a DTensor
        and the hints name axes; else ``x`` itself."""
        if not self.active or not isinstance(x, DTensor):
            return x
        want = placements(spec, x.device_mesh)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)

    def residual(self, x):
        """Inter-block residual [B, S, d], and each mixer's and FFN's
        output before it joins the residual (with ``seq_shard`` a
        reduce-scatter over the sequence, whose backward gathers the
        gradient before the output projection's)."""
        seq = self.model_axis if self.seq_shard else None
        return self.constrain(x, Spec(self.data_axes, seq, None))

    def batch_only(self, x):
        """[B, ...] over the data axes only: a layer's normed input before
        its products (with ``seq_shard``, Megatron-SP's all-gather of the
        sequence)."""
        return self.constrain(
            x, Spec(*([self.data_axes] + [None] * (x.dim() - 1))))

    def context(self):
        """``implicit_replication`` while the hints name axes (plain
        tensors in the step count as replicated), else nothing. Nests: a
        step enters it around its forward, backward (which recomputes
        remat groups) and update, and ``forward`` again inside."""
        return _replicating() if self.active else contextlib.nullcontext()


_REPLICATING = [0]          # depth of nested ShardingHints.context()


@contextlib.contextmanager
def _replicating():
    # implicit_replication() resets its flag on exit, so only the
    # outermost context enters it
    _REPLICATING[0] += 1
    try:
        if _REPLICATING[0] == 1:
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _REPLICATING[0] -= 1


NO_HINTS = ShardingHints()


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------

def _attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "ln": ParamDef((d,), (None,), "zeros"),
        "wq": ParamDef((d, h * hd), ("fsdp", "tp")),
        "wk": ParamDef((d, kv * hd), ("fsdp", "tp")),
        "wv": ParamDef((d, kv * hd), ("fsdp", "tp")),
        "wo": ParamDef((h * hd, d), ("tp", "fsdp")),
    }
    if cfg.qkv_bias:
        p.update(
            bq=ParamDef((h * hd,), ("tp",), "zeros"),
            bk=ParamDef((kv * hd,), ("tp",), "zeros"),
            bv=ParamDef((kv * hd,), ("tp",), "zeros"),
        )
    if cfg.qk_norm:
        p.update(
            q_norm=ParamDef((hd,), (None,), "zeros"),
            k_norm=ParamDef((hd,), (None,), "zeros"),
        )
    if cfg.post_norms:
        p["post_ln"] = ParamDef((d,), (None,), "zeros")
    return p


def _mlp_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    p = {"ln2": ParamDef((d,), (None,), "zeros")}
    if cfg.moe is not None:
        e, fe = cfg.moe.num_experts, cfg.moe.d_ff_expert
        p.update(
            router=ParamDef((d, e), ("fsdp", None)),
            moe_wg=ParamDef((e, d, fe), ("expert", "fsdp", "tp")),
            moe_wu=ParamDef((e, d, fe), ("expert", "fsdp", "tp")),
            moe_wd=ParamDef((e, fe, d), ("expert", "tp", "fsdp")),
        )
    else:
        p.update(
            wg=ParamDef((d, f), ("fsdp", "tp")),
            wu=ParamDef((d, f), ("fsdp", "tp")),
            wd=ParamDef((f, d), ("tp", "fsdp")),
        )
    if cfg.post_norms:
        p["post_ln2"] = ParamDef((d,), (None,), "zeros")
    return p


def _rec_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, r = cfg.d_model, cfg.rnn_width
    h = cfg.num_heads
    blk = r // h
    return {
        "ln": ParamDef((d,), (None,), "zeros"),
        "w_x": ParamDef((d, r), ("fsdp", "tp")),
        "w_g": ParamDef((d, r), ("fsdp", "tp")),
        "conv_w": ParamDef((cfg.conv_width, r), (None, "tp")),
        "w_i": ParamDef((h, blk, blk), (None, None, None)),
        "w_a": ParamDef((h, blk, blk), (None, None, None)),
        "b_i": ParamDef((r,), ("tp",), "zeros"),
        "b_a": ParamDef((r,), ("tp",), "zeros"),
        "lam": ParamDef((r,), ("tp",), "rnn_lambda"),
        "w_o": ParamDef((r, d), ("tp", "fsdp")),
    }


def _rwkv_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    hk = cfg.rwkv_head_dim
    h = d // hk
    lora = 64
    p = {
        "ln": ParamDef((d,), (None,), "zeros"),
        "ln2": ParamDef((d,), (None,), "zeros"),
        "u": ParamDef((h, hk), ("tp", None), "zeros"),
        "w0": ParamDef((d,), ("tp",), "zeros"),
        "w_lora_a": ParamDef((d, lora), ("fsdp", None)),
        "w_lora_b": ParamDef((lora, d), (None, "tp")),
        "cm_w_r": ParamDef((d, d), ("fsdp", None)),
        "cm_w_k": ParamDef((d, f), ("fsdp", "tp")),
        "cm_w_v": ParamDef((f, d), ("tp", "fsdp")),
    }
    for n in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "cm_mu_r", "cm_mu_k"):
        p[n] = ParamDef((d,), (None,), "zeros")
    for n in ("w_r", "w_k", "w_v", "w_g"):
        p[n] = ParamDef((d, d), ("fsdp", "tp"))
    p["w_o"] = ParamDef((d, d), ("tp", "fsdp"))
    return p


def _layer_defs(cfg: ModelConfig, kind: str) -> Dict[str, ParamDef]:
    if kind in ("global", "local"):
        return {**_attn_defs(cfg), **_mlp_defs(cfg)}
    if kind == "rec":
        return {**_rec_defs(cfg), **_mlp_defs(cfg)}
    if kind == "rwkv":
        return _rwkv_defs(cfg)
    raise ValueError(kind)


def _stack_defs(defs: Dict[str, ParamDef], n: int) -> Dict[str, ParamDef]:
    return {
        k: ParamDef((n,) + d.shape, ("stack",) + d.logical, d.init, d.dtype)
        for k, d in defs.items()
    }


def _head_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, v = cfg.d_model, cfg.padded_vocab
    tree = {
        "embed": ParamDef((v, d), ("tp", "fsdp"), "embed"),
        "final_norm": ParamDef((d,), (None,), "zeros"),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamDef((d, v), ("fsdp", "tp"))
    return tree


def param_defs(cfg: ModelConfig):
    """Full ParamDef tree for a config, in the JAX package's layout
    (``blocks``: one stacked dict per pattern position; ``tail``)."""
    tree: Dict[str, Any] = _head_defs(cfg)
    g = cfg.num_groups
    tree["blocks"] = [
        _stack_defs(_layer_defs(cfg, kind), g) for kind in cfg.pattern
    ]
    tree["tail"] = [_layer_defs(cfg, kind) for kind in cfg.tail_pattern]
    return tree


def layer_param_defs(cfg: ModelConfig):
    """The port's ParamDef tree: the head's leaves and ``layers``, one
    dict a layer in stack order."""
    tree: Dict[str, Any] = _head_defs(cfg)
    tree["layers"] = [_layer_defs(cfg, kind) for kind in cfg.layer_kinds]
    return tree


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def _cache_len(cfg: ModelConfig, kind: str, seq_len: int) -> int:
    if kind == "local":
        return min(cfg.window, seq_len)
    return seq_len


def _layer_cache(cfg: ModelConfig, kind: str, b: int, seq_len: int, device):
    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    if kind in ("global", "local"):
        s = _cache_len(cfg, kind, seq_len)
        kvh, hd = cfg.num_kv_heads, cfg.head_dim
        return {
            "k": z((b, s, kvh, hd), torch.bfloat16),
            "v": z((b, s, kvh, hd), torch.bfloat16),
            "kpos": torch.full((b, s), POS_SENTINEL, dtype=torch.int32,
                               device=device),
        }
    if kind == "rec":
        r = cfg.rnn_width
        return {
            "h": z((b, r), torch.float32),
            "conv": z((b, cfg.conv_width - 1, r), torch.bfloat16),
        }
    if kind == "rwkv":
        hk = cfg.rwkv_head_dim
        h = cfg.d_model // hk
        return {
            "s": z((b, h, hk, hk), torch.float32),
            "last_tm": z((b, cfg.d_model), torch.bfloat16),
            "last_cm": z((b, cfg.d_model), torch.bfloat16),
        }
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device="cuda"):
    """One cache dict a layer, in stack order, on ``device``."""
    dev = resolve_device(device)
    return [_layer_cache(cfg, kind, batch, seq_len, dev)
            for kind in cfg.layer_kinds]


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _project_qkv(cfg: ModelConfig, p, x):
    b, t, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = _split_heads(q, h, hd)
    k = _split_heads(k, kv, hd)
    v = _split_heads(v, kv, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _split_heads(t, heads: int, hd: int):
    """[B, T, heads·hd] -> [B, T, heads, hd]. A DTensor whose last dim is
    split over more ranks than it has heads (8 KV heads on a 16-wide model
    axis) cannot be viewed so: it is gathered over those ranks first."""
    if isinstance(t, DTensor):
        mesh = t.device_mesh
        want = [Replicate() if isinstance(pl, Shard) and pl.dim == 2
                and heads % mesh.size(i) else pl
                for i, pl in enumerate(t.placements)]
        if want != list(t.placements):
            t = t.redistribute(mesh, want)
    return t.reshape(t.shape[0], t.shape[1], heads, hd)


def _attn_scale(cfg: ModelConfig) -> float:
    if cfg.name.startswith("gemma2"):
        return (cfg.d_model / cfg.num_heads) ** -0.5
    return cfg.head_dim ** -0.5


def _fill_cache(cache, k, v, positions):
    """Prefill's cache: the last ``s`` positions of the prompt (ring and
    window caches), or the prompt followed by empty sentinel slots."""
    b, s = cache["kpos"].shape
    tq = k.shape[1]
    if s <= tq:
        kk, vv, kp = k[:, -s:], v[:, -s:], positions[-s:]
    else:
        pad = s - tq
        kk = torch.cat([k, k.new_zeros((b, pad) + k.shape[2:])], dim=1)
        vv = torch.cat([v, v.new_zeros((b, pad) + v.shape[2:])], dim=1)
        kp = torch.cat([positions[:tq].to(torch.int32),
                        positions.new_full((pad,), POS_SENTINEL,
                                           dtype=torch.int32)])
    return {
        "k": kk.to(cache["k"].dtype).contiguous(),
        "v": vv.to(cache["v"].dtype).contiguous(),
        "kpos": kp.to(torch.int32)[None].expand(b, s).contiguous(),
    }


def _heads_local(fn, q, k, v, hints):
    """``fn(q, k, v)`` (an attention over plain [B, T, heads, D] tensors)
    on each rank's own batch rows and heads, with no collective inside:
    the batch over the data axes, and over the model axis (m ranks) the KV
    heads where m divides them; else the query heads where m divides them
    and each rank's share of query heads falls within whole KV groups,
    with k and v gathered and each rank taking the KV heads its query
    heads read (GQA on a model axis wider than the KV heads); else all
    heads on every rank. The output comes back with q's placements."""
    if not hints.active:
        raise ValueError("attention over DTensors needs ShardingHints")
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    ma = hints.model_axis
    m = mesh.size(names.index(ma)) if ma in names else 1
    h, hkv = q.shape[2], k.shape[2]
    r = h // hkv
    hq = h // m
    kv_split = m > 1 and hkv % m == 0
    q_split = m > 1 and not kv_split and h % m == 0 and (
        hq % r == 0 or r % hq == 0)
    q_spec = Spec(hints.data_axes, None, ma if kv_split or q_split else None,
                  None)
    kv_spec = Spec(hints.data_axes, None, ma if kv_split else None, None)
    q = hints.constrain(q, q_spec)
    k, v = (hints.constrain(t, kv_spec) for t in (k, v))
    if not q_split:
        out = fn(q.to_local(), k.to_local(), v.to_local())
        return DTensor.from_local(out, mesh, q.placements, run_check=False)
    # the KV heads of this rank's query heads; each rank's gradient of the
    # gathered k and v covers its own heads only: a sum over the model axis
    i = mesh.get_local_rank(names.index(ma))
    lo, hi = i * hq // r, -(-(i + 1) * hq // r)
    grad = [Partial() if n == ma else pl for n, pl in zip(names,
                                                          k.placements)]
    kl, vl = (t.to_local(grad_placements=grad)[:, :, lo:hi] for t in (k, v))
    out = fn(q.to_local(), kl, vl)
    return DTensor.from_local(out, mesh, q.placements, run_check=False)


def _write_slot(cache_leaf, slot: int, value):
    """``cache_leaf[:, slot] = value`` in place. A sharded cache leaf is
    written on the ranks whose shard holds ``slot``, into their local
    shard, with ``value`` taken on the leaf's batch rows (a select on a
    sharded dim would gather the whole cache)."""
    if not isinstance(cache_leaf, DTensor):
        cache_leaf[:, slot] = value
        return
    start, size = shard_range(cache_leaf, 1)
    if isinstance(value, DTensor):
        want = [Replicate() if isinstance(pl, Shard) and pl.dim == 1
                else pl for pl in cache_leaf.placements]
        value = value.redistribute(value.device_mesh, want).to_local()
    if start <= slot < start + size:
        cache_leaf.to_local()[:, slot - start] = value


def _decode_sharded(q, cache, *, pos, scale, window, softcap):
    """``L.decode_attention`` over a cache whose sequence is sharded
    (flash-decoding): each rank attends q to its own cache slots; the
    ranks along the sequence combine [B, H(, D)] partials — the scores'
    max, the exponentials' sum, the weighted values — never the cache. q
    is taken on the cache's batch rows."""
    k, v, kpos = cache["k"], cache["v"], cache["kpos"]
    mesh, cp = k.device_mesh, k.placements
    over_seq = [isinstance(pl, Shard) and pl.dim == 1 for pl in cp]
    rows = [Shard(0) if isinstance(pl, Shard) and pl.dim == 0
            else Replicate() for pl in cp]
    ql = q.redistribute(mesh, rows).to_local()
    b, _, h, d = ql.shape
    kl, vl, pl_ = k.to_local(), v.to_local(), kpos.to_local()
    hkv = kl.shape[2]
    qg = ql.reshape(b, hkv, h // hkv, d)
    s = torch.einsum("bhrd,bkhd->bhrk", qg.float(), kl.float()) * scale
    s = L._softcap(s, softcap)
    mask = pl_ <= pos
    if window is not None:
        mask &= pl_ > (pos - window)
    s = torch.where(mask[:, None, None, :], s, L.NEG_INF)

    def combine(t, op):
        parts = [Partial(op) if o else r for o, r in zip(over_seq, rows)]
        return DTensor.from_local(t, mesh, parts, run_check=False) \
            .redistribute(mesh, rows).to_local()

    # the softmax's max and sum over all slots first, so that the
    # probabilities are rounded to the cache's dtype normalised, as
    # L.decode_attention rounds them
    e = torch.exp(s - combine(s.amax(dim=-1), "max")[..., None])
    p = e / combine(e.sum(dim=-1), "sum")[..., None]
    out = combine(torch.einsum("bhrk,bkhd->bhrd", p.to(vl.dtype).float(),
                               vl.float()), "sum")
    out = out.reshape(b, 1, h, d).to(ql.dtype)
    return DTensor.from_local(out, mesh, rows, run_check=False)


def _apply_attn(cfg, p, x, positions, kind, mode, cache, pos, hints):
    """Attention mixer. Returns (out, new_cache)."""
    window = cfg.window if kind == "local" else None
    scale = _attn_scale(cfg)
    q, k, v = _project_qkv(cfg, p, x)
    if mode == "decode":                                     # t == 1
        if cfg.pos == "rope":
            # a fill, not a host-to-device copy (which would synchronise)
            pos_arr = torch.full((1,), pos, dtype=torch.int32,
                                 device=x.device)
            q = L.rotary(q, pos_arr, cfg.rope_theta)
            k = L.rotary(k, pos_arr, cfg.rope_theta)
        s = cache["k"].shape[1]
        slot = (pos % s) if window is not None else min(pos, s - 1)
        _write_slot(cache["k"], slot, k[:, 0])
        _write_slot(cache["v"], slot, v[:, 0])
        _write_slot(cache["kpos"], slot, pos)
        if isinstance(cache["k"], DTensor):
            out = _decode_sharded(q, cache, pos=pos, scale=scale,
                                  window=window, softcap=cfg.attn_softcap)
        else:
            out = L.decode_attention(
                q, cache["k"], cache["v"], k_positions=cache["kpos"],
                q_position=pos, scale=scale, window=window,
                softcap=cfg.attn_softcap,
            )
        new_cache = cache
    else:
        if cfg.pos == "rope":
            q = L.rotary(q, positions, cfg.rope_theta)
            k = L.rotary(k, positions, cfg.rope_theta)
        def attend(q, k, v):
            return L.chunked_attention(
                q, k, v, q_positions=positions, k_positions=positions,
                scale=scale, window=window, softcap=cfg.attn_softcap,
                q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk,
            )
        out = _heads_local(attend, q, k, v, hints) \
            if isinstance(q, DTensor) else attend(q, k, v)
        new_cache = None if cache is None else _fill_cache(cache, k, v,
                                                           positions)
    out = out.reshape(out.shape[0], out.shape[1], -1) @ p["wo"]
    return out, new_cache


def _apply_ffn(cfg, p, x, hints):
    """Gated MLP or MoE. Returns (out, aux_loss)."""
    if cfg.moe is not None:
        out, mm = M.moe_ffn(cfg.moe, x, p["router"], p["moe_wg"],
                            p["moe_wu"], p["moe_wd"], hints=hints)
        return out, mm.aux_loss
    return (L.mlp(x, p["wg"], p["wu"], p["wd"], cfg.act),
            torch.zeros((), dtype=torch.float32, device=x.device))


class _Layer(nn.Module):
    """One layer's weights under their JAX names (``layer["wq"]``)."""

    def __init__(self, kind: str, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        self.kind = kind
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._parameters[name]

    def _mixer_then_ffn(self, cfg, x, mix, hints):
        """The residual mixer output, then the FFN block (post-norms where
        the config has them). Returns (x, aux)."""
        if cfg.post_norms:
            mix = L.rms_norm(mix, self["post_ln"], cfg.norm_eps)
        x = x + hints.residual(mix)
        h2 = hints.batch_only(L.rms_norm(x, self["ln2"], cfg.norm_eps))
        ffn, aux = _apply_ffn(cfg, self, h2, hints)
        if cfg.post_norms:
            ffn = L.rms_norm(ffn, self["post_ln2"], cfg.norm_eps)
        return hints.residual(x + hints.residual(ffn)), aux


class AttentionLayer(_Layer):
    def forward(self, cfg, x, positions, mode, cache, pos,
                hints=NO_HINTS):
        """Residual block. Returns (x, new_cache, aux)."""
        h = hints.batch_only(L.rms_norm(x, self["ln"], cfg.norm_eps))
        mix, new_cache = _apply_attn(cfg, self, h, positions, self.kind,
                                     mode, cache, pos, hints)
        x, aux = self._mixer_then_ffn(cfg, x, mix, hints)
        return x, new_cache, aux


class RecurrentLayer(_Layer):
    def forward(self, cfg, x, positions, mode, cache, pos,
                hints=NO_HINTS):
        h = hints.batch_only(L.rms_norm(x, self["ln"], cfg.norm_eps))
        if mode == "decode":
            mix, new_st = R.rglru_step(
                self, h, R.RecState(h=cache["h"], conv=cache["conv"]))
        else:
            mix, new_st = R.rglru_block(self, h, None)
        new_cache = None
        if cache is not None:
            new_cache = {"h": new_st.h,
                         "conv": new_st.conv.to(torch.bfloat16)}
        x, aux = self._mixer_then_ffn(cfg, x, mix, hints)
        return x, new_cache, aux


class RwkvLayer(_Layer):
    def forward(self, cfg, x, positions, mode, cache, pos,
                hints=NO_HINTS):
        h = hints.batch_only(L.rms_norm(x, self["ln"], cfg.norm_eps))
        st = None
        if mode == "decode":
            st = W.RwkvState(s=cache["s"], last_tm=cache["last_tm"],
                             last_cm=cache["last_cm"])
        tm_out, s_fin, last_tm = W.time_mix(self, h, cfg.rwkv_head_dim, st,
                                            chunk=cfg.rwkv_chunk)
        x = x + hints.residual(tm_out)
        h2 = hints.batch_only(L.rms_norm(x, self["ln2"], cfg.norm_eps))
        cm_out, last_cm = W.channel_mix(self, h2, st)
        x = x + hints.residual(cm_out)
        new_cache = None
        if cache is not None:
            new_cache = {"s": s_fin, "last_tm": last_tm.to(torch.bfloat16),
                         "last_cm": last_cm.to(torch.bfloat16)}
        return hints.residual(x), new_cache, torch.zeros(
            (), dtype=torch.float32, device=x.device)


LAYER_MODULES = {"global": AttentionLayer, "local": AttentionLayer,
                 "rec": RecurrentLayer, "rwkv": RwkvLayer}


class Decoder(nn.Module):
    """The model's weights: ``embed``, ``final_norm``, ``lm_head`` (untied
    configs) and ``layers``, one module a layer in stack order."""

    def __init__(self, cfg: ModelConfig, tensors):
        super().__init__()
        self.cfg = cfg
        for name in ("embed", "final_norm", "lm_head"):
            if name in tensors:
                self.register_parameter(
                    name, nn.Parameter(tensors[name], requires_grad=False))
        if len(tensors["layers"]) != cfg.num_layers:
            raise ValueError(f"{len(tensors['layers'])} layers of weights "
                             f"for a {cfg.num_layers}-layer config")
        self.layers = nn.ModuleList(
            LAYER_MODULES[kind](kind, t)
            for kind, t in zip(cfg.layer_kinds, tensors["layers"]))

    def tensors(self):
        """The weights as the tree ``Decoder(cfg, tree)`` takes."""
        tree = dict(self._parameters)
        tree["layers"] = [dict(m._parameters) for m in self.layers]
        return tree

    def copy_to(self, device) -> "Decoder":
        """A copy of the weights on ``device`` (this model unchanged)."""
        dev = torch.device(device)
        return Decoder(self.cfg, tree_map(
            lambda _, t: t.detach().to(dev, copy=True), self.tensors()))


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Decoder:
    """A model with weights drawn on ``device`` from ``seed``."""
    dev = resolve_device(device)
    return Decoder(cfg, init_tree(layer_param_defs(cfg), seed, dev))


# ---------------------------------------------------------------------------
# Stack application
# ---------------------------------------------------------------------------

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_dots(ctx, op, *args, **kwargs):
    return (CK.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CK.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(cfg: ModelConfig):
    """The ``context_fn`` of a checkpointed group for ``cfg.remat``."""
    if cfg.remat == "dots":
        return functools.partial(CK.create_selective_checkpoint_contexts,
                                 _keep_dots)
    return CK.noop_context_fn


def _train_group(cfg: ModelConfig, layers, x, positions, hints):
    """One pattern group in train mode (no cache). Returns (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in layers:
        x, _, a = layer(cfg, x, positions, "train", None, None, hints)
        aux = aux + a
    return x, aux


def apply_stack(cfg: ModelConfig, params: Decoder, x, positions, *,
                mode: str, cache=None, pos=None,
                hints: ShardingHints = NO_HINTS):
    """Apply all layers. Returns (x, new_cache, aux_total)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = None if cache is None else []
    start = 0
    if mode == "train" and cfg.remat != "none" and torch.is_grad_enabled():
        p, ctx = cfg.pattern_len, _remat_context(cfg)
        for g in range(cfg.num_groups):
            x, a = CK.checkpoint(_train_group, cfg,
                                 params.layers[g * p:(g + 1) * p], x,
                                 positions, hints, use_reentrant=False,
                                 context_fn=ctx)
            aux_total = aux_total + a
        start = cfg.num_groups * p
    for i in range(start, cfg.num_layers):
        c_i = cache[i] if cache is not None else None
        x, nc, a = params.layers[i](cfg, x, positions, mode, c_i, pos,
                                    hints)
        aux_total = aux_total + a
        if cache is not None:
            new_cache.append(nc)
    return x, new_cache, aux_total


# ---------------------------------------------------------------------------
# Embeddings & heads
# ---------------------------------------------------------------------------

def _embed_sharded(table: DTensor, tokens):
    """The lookup of a DTensor table, vocab-parallel in named code (the
    sharding rules of index, index_put and embedding differ between torch
    releases): the table keeps its vocab shards and is gathered over its
    other dims; each rank looks up the tokens in its own vocab range,
    zeros elsewhere, and the ranks along the vocab sum (one non-zero a
    position, so the sum is exact). The tokens keep their batch shards
    where the table is not vocab-sharded."""
    mesh = table.device_mesh
    vocab = [isinstance(pl, Shard) and pl.dim == 0 for pl in table.placements]
    table = table.redistribute(mesh, [Shard(0) if v else Replicate()
                                      for v in vocab])
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    rows = [Replicate() if v else pl for v, pl in zip(vocab,
                                                      tokens.placements)]
    tokens = tokens.redistribute(mesh, rows)
    lo, n = shard_range(table, 0)
    # each rank's table gradient covers its own tokens: summed over the
    # dims the tokens are split on
    grad = [Shard(0) if v else (Partial() if isinstance(r, Shard)
                                else Replicate())
            for v, r in zip(vocab, rows)]
    local = table.to_local(grad_placements=grad)
    t = tokens.to_local().long()
    inside = ((t >= lo) & (t < lo + n))[..., None].to(local.dtype)
    out = local[(t - lo).clamp(0, n - 1)] * inside
    return DTensor.from_local(out, mesh, [Partial() if v else r for v, r in
                                          zip(vocab, rows)], run_check=False)


def embed(cfg: ModelConfig, params: Decoder, tokens):
    x = _embed_sharded(params.embed, tokens) \
        if isinstance(params.embed, DTensor) else params.embed[tokens.long()]
    if cfg.scale_embeddings:
        # sqrt(d) rounded to the activations' dtype first, as in the JAX
        # package; a 0-d host tensor, so no host-to-device copy
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def build_inputs(cfg: ModelConfig, params: Decoder, batch):
    """Assemble input embeddings from tokens and/or stub-frontend embeds."""
    if cfg.frontend is None:
        x = embed(cfg, params, batch["tokens"])
    elif cfg.frontend == "audio":
        # stub: EnCodec frame embeddings provided directly
        x = batch["embeds"].to(params.embed.dtype)
    elif cfg.frontend == "vision":
        img = batch["embeds"].to(params.embed.dtype)            # [B, F, d]
        txt = embed(cfg, params, batch["tokens"])               # [B, S-F, d]
        x = torch.cat([img, txt], dim=1)
    else:
        raise ValueError(cfg.frontend)
    if cfg.pos == "sinusoidal":
        s = x.shape[1]
        x = x + L.sinusoidal(torch.arange(s, device=x.device),
                             cfg.d_model)[None].to(x.dtype)
    return x


def lm_head(cfg: ModelConfig, params: Decoder, x):
    """x: [B, T, d] -> logits [B, T, V] (callers take the positions they
    need)."""
    # one 2-D product: a strided [B, T, d] (``feats[:, -1:]``) would make
    # ``matmul`` broadcast the head to [B, d, V] and copy it
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    b, t, d = x.shape
    logits = (x.reshape(b * t, d) @ w).reshape(b, t, -1)
    if cfg.padded_vocab != cfg.vocab_size:
        logits = logits[..., : cfg.vocab_size]
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(
            logits.float() / cfg.final_softcap).to(logits.dtype)
    return logits


def forward(cfg: ModelConfig, params: Decoder, batch, *, mode: str = "train",
            cache=None, pos=None, hints: ShardingHints = NO_HINTS):
    """Full forward. train: returns (features, aux). prefill: (features,
    cache, aux). decode: (logits, cache); ``pos`` is the step's position."""
    with hints.context():
        return _forward(cfg, params, batch, mode, cache, pos, hints)


def _forward(cfg, params, batch, mode, cache, pos, hints):
    if mode == "decode":
        pos = int(pos)
        # audio frames are rounded to bf16 as in the JAX package, then
        # taken in the weights' dtype (JAX promotes at the first product)
        x = (embed(cfg, params, batch["tokens"]) if cfg.frontend != "audio"
             else batch["embeds"].to(torch.bfloat16).to(params.embed.dtype))
        if cfg.pos == "sinusoidal":
            x = x + L.sinusoidal(torch.full((1,), pos, device=x.device),
                                 cfg.d_model)[None].to(x.dtype)
        x, new_cache, _ = apply_stack(cfg, params, x, None, mode="decode",
                                      cache=cache, pos=pos, hints=hints)
        x = hints.batch_only(L.rms_norm(x, params.final_norm, cfg.norm_eps))
        return lm_head(cfg, params, x), new_cache

    x = hints.residual(build_inputs(cfg, params, batch))
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x, new_cache, aux = apply_stack(cfg, params, x, positions, mode=mode,
                                    cache=cache, pos=pos, hints=hints)
    x = hints.batch_only(L.rms_norm(x, params.final_norm, cfg.norm_eps))
    if mode == "prefill":
        return x, new_cache, aux
    return x, aux
