"""qwen3-0.6b [dense] (hf:Qwen/Qwen3-0.6B family; hf).

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936. QK-norm, GQA.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    pattern=("global",),
    qk_norm=True,
    rope_theta=1000000.0,
    act="swiglu",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen3-0.6b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    pattern=("global",),
    qk_norm=True,
    act="swiglu",
    tie_embeddings=True,
    attn_q_chunk=32,
    attn_kv_chunk=32,
)
