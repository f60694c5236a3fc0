"""gemma2-27b [dense] (arXiv:2408.00118; hf).

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.
Local(4096)/global alternating attention, attn softcap 50, final softcap 30,
sandwich (post) norms, GeGLU, sqrt(d)-scaled tied embeddings,
query scale (d_model/num_heads)^-0.5 = 144^-0.5.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    pattern=("local", "global"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,
    act="geglu",
    tie_embeddings=True,
    scale_embeddings=True,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="gemma2-27b-smoke",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    pattern=("local", "global"),
    window=16,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,
    act="geglu",
    tie_embeddings=True,
    scale_embeddings=True,
    attn_q_chunk=32,
    attn_kv_chunk=32,
)
