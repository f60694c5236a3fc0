"""qwen2.5-14b [dense] (hf:Qwen/Qwen2.5-14B family; hf).

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064. GQA, QKV bias.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    pattern=("global",),
    qkv_bias=True,
    rope_theta=1000000.0,
    act="swiglu",
)

SMOKE = ModelConfig(
    name="qwen2.5-14b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    pattern=("global",),
    qkv_bias=True,
    act="swiglu",
    attn_q_chunk=32,
    attn_kv_chunk=32,
)
