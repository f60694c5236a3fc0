"""rwkv6-1.6b [ssm] ("Finch", arXiv:2404.05892; unverified).

24L d_model=2048 (attention-free) d_ff=7168 vocab=65536.
Data-dependent per-channel decay, head_dim 64.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    num_layers=24,
    d_model=2048,
    num_heads=32,          # d_model / rwkv_head_dim
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    pattern=("rwkv",),
    rwkv_head_dim=64,
    pos="none",
)

SMOKE = ModelConfig(
    name="rwkv6-1.6b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    pattern=("rwkv",),
    rwkv_head_dim=16,
    pos="none",
)
