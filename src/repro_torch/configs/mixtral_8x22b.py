"""mixtral-8x22b [moe] (arXiv:2401.04088; hf).

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768.
MoE 8 experts top-2; sliding-window attention (4096) per the assignment.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    pattern=("local",),           # SWA on every layer (bounded ring cache)
    window=4096,
    rope_theta=1000000.0,
    act="swiglu",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384),
)

SMOKE = ModelConfig(
    name="mixtral-8x22b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    pattern=("local",),
    window=16,
    act="swiglu",
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
    attn_q_chunk=32,
    attn_kv_chunk=32,
)
