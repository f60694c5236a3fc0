"""qwen3-moe-30b-a3b [moe] (hf:Qwen/Qwen3-30B-A3B; hf).

48L d_model=2048 32H (GQA kv=4) d_ff=768 (per expert) vocab=151936.
MoE 128 experts top-8, qk-norm.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    pattern=("global",),
    qk_norm=True,
    rope_theta=1000000.0,
    act="swiglu",
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
)

SMOKE = ModelConfig(
    name="qwen3-moe-30b-a3b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=64,
    vocab_size=256,
    pattern=("global",),
    qk_norm=True,
    act="swiglu",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64),
    attn_q_chunk=32,
    attn_kv_chunk=32,
)
