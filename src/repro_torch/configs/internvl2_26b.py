"""internvl2-26b [vlm] (arXiv:2404.16821; hf).

Backbone: InternLM2-20B-style — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553. The InternViT vision frontend is a STUB — ``input_specs()``
provides precomputed patch embeddings (256 positions) prepended to the text.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    pattern=("global",),
    rope_theta=1000000.0,
    act="swiglu",
    frontend="vision",
    frontend_len=256,
)

SMOKE = ModelConfig(
    name="internvl2-26b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    pattern=("global",),
    act="swiglu",
    frontend="vision",
    frontend_len=8,
    attn_q_chunk=32,
    attn_kv_chunk=32,
)
