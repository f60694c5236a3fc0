"""Model configuration for the composable decoder stack, PyTorch port.

A copy of ``repro.models.config`` kept in the port (it imports nothing of
the JAX package): one config class covers all 10 assigned architectures
(dense GQA, MoE, local/global alternation, SWA, RG-LRU hybrid, RWKV-6,
modality-stub frontends). A layer *pattern* (e.g. ``("local", "global")``
for Gemma-2, ``("rec", "rec", "local")`` for RecurrentGemma) repeats down
the stack, with any remainder layers (the *tail*) appended; the port
applies the layers one by one (``transformer.Decoder.layers``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

LAYER_KINDS = ("global", "local", "rec", "rwkv")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # split long sequences into routing groups of this many tokens:
    # dispatch-buffer memory scales with per-group capacity (E·C·d), so
    # 32k-token prefill groups are capped (§Perf iter 10). None = one
    # group per batch row (GShard grouping).
    group_len: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # layer pattern, repeated; remainder layers appended unscanned
    pattern: Tuple[str, ...] = ("global",)

    # attention features
    window: int = 4096                  # for "local" layers
    rope_theta: float = 10000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None    # gemma2: 50.0
    final_softcap: Optional[float] = None   # gemma2: 30.0
    post_norms: bool = False            # gemma2 sandwich norms
    pos: str = "rope"                   # "rope" | "sinusoidal" | "none"

    # mlp
    act: str = "swiglu"                 # "swiglu" | "geglu"
    moe: Optional[MoEConfig] = None

    # recurrent blocks
    d_rnn: Optional[int] = None         # RG-LRU width (default d_model)
    conv_width: int = 4                 # RG-LRU temporal conv taps
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 32                # chunked-parallel WKV (0=sequential)

    # embeddings / frontends
    tie_embeddings: bool = False
    scale_embeddings: bool = False      # gemma-style sqrt(d) scaling
    frontend: Optional[str] = None      # None | "audio" | "vision"
    frontend_len: int = 256             # patch/frame positions (stub)

    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    # training-side knobs (hillclimb axes; see EXPERIMENTS.md §Perf)
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    seq_shard_activations: bool = True  # Megatron-SP style saved-carry shard
    remat: str = "nothing"              # "nothing" | "dots" | "none"

    def __post_init__(self):
        for k in self.pattern:
            assert k in LAYER_KINDS, k
        assert self.num_heads % self.num_kv_heads == 0

    @property
    def pattern_len(self) -> int:
        return len(self.pattern)

    @property
    def num_groups(self) -> int:
        return self.num_layers // self.pattern_len

    @property
    def tail_pattern(self) -> Tuple[str, ...]:
        return self.pattern[: self.num_layers % self.pattern_len]

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        full = self.pattern * self.num_groups + self.tail_pattern
        assert len(full) == self.num_layers
        return full

    @property
    def rnn_width(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows padded (minimally) so the vocab dim shards
        evenly over TP=16 — jit argument shardings must divide exactly.
        Logits are sliced back to ``vocab_size`` (internvl2: 92553→92560)."""
        if self.vocab_size % 16 == 0:
            return self.vocab_size
        return -(-self.vocab_size // 16) * 16

    @property
    def attention_free(self) -> bool:
        return all(k in ("rec", "rwkv") for k in self.pattern + self.tail_pattern)

    @property
    def max_cache_layers_window(self) -> bool:
        """True when every attention layer is windowed (bounded cache)."""
        kinds = set(self.layer_kinds)
        return "global" not in kinds

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, kv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        n = v * d  # embed
        if not self.tie_embeddings:
            n += v * d
        for kind in self.layer_kinds:
            if kind in ("global", "local"):
                n += d * (h + 2 * kv) * hd + h * hd * d
            elif kind == "rec":
                r = self.rnn_width
                n += 2 * d * r + r * d + self.conv_width * r + 3 * r
            elif kind == "rwkv":
                n += 5 * d * d + d * 2 * 64  # time-mix + decay lora (approx)
            if kind == "rwkv":
                n += 2 * d * f + d * d      # channel mix
            elif self.moe is not None:
                e = self.moe
                n += e.num_experts * 3 * d * e.d_ff_expert + d * e.num_experts
            else:
                n += 3 * d * f
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        e = self.moe
        total = self.param_count()
        moe_layers = sum(1 for k in self.layer_kinds if k not in ("rwkv",))
        all_experts = moe_layers * e.num_experts * 3 * d * e.d_ff_expert
        active = moe_layers * e.top_k * 3 * d * e.d_ff_expert
        return total - all_experts + active
