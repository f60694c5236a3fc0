"""recurrentgemma-2b [hybrid] (Griffin, arXiv:2402.19427; hf).

26L d_model=2560 10H (GQA kv=1, i.e. MQA) d_ff=7680 vocab=256000.
RG-LRU + local attention, (rec, rec, local) repeating — 8 full groups + 2
trailing rec layers. RNN width 2560, local window 2048, GeGLU MLP,
sqrt(d)-scaled embeddings.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    pattern=("rec", "rec", "local"),
    window=2048,
    d_rnn=2560,
    conv_width=4,
    act="geglu",
    tie_embeddings=True,
    scale_embeddings=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke",
    num_layers=5,                 # 1 group + (rec, rec) tail — same shape
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    pattern=("rec", "rec", "local"),
    window=16,
    d_rnn=64,
    conv_width=4,
    act="geglu",
    tie_embeddings=True,
    scale_embeddings=True,
    attn_q_chunk=32,
    attn_kv_chunk=32,
)
