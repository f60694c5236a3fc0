"""deepseek-coder-33b [dense, llama-arch] (arXiv:2401.14196; hf).

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    pattern=("global",),
    rope_theta=100000.0,
    act="swiglu",
)

SMOKE = ModelConfig(
    name="deepseek-coder-33b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    pattern=("global",),
    act="swiglu",
    attn_q_chunk=32,
    attn_kv_chunk=32,
)
