"""musicgen-large [audio] (arXiv:2306.05284; hf).

48L d_model=2048 32H (GQA kv=32, i.e. MHA) d_ff=8192 vocab=2048.
Decoder-only over EnCodec tokens; the EnCodec frontend is a STUB —
``input_specs()`` provides precomputed frame embeddings. Sinusoidal
positions (as in the original), standard (non-gated) GELU approximated here
by GeGLU for uniformity of the stack; documented deviation.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    pattern=("global",),
    pos="sinusoidal",
    act="geglu",
    frontend="audio",
)

SMOKE = ModelConfig(
    name="musicgen-large-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=64,
    pattern=("global",),
    pos="sinusoidal",
    act="geglu",
    frontend="audio",
    attn_q_chunk=32,
    attn_kv_chunk=32,
)
