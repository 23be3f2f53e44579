"""qwen2-72b [dense] — 80L, d_model=8192, 64H (GQA kv=8), d_ff=29568,
vocab=152064.  GQA with QKV bias.  [arXiv:2407.10671]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    attn_bias=True,
    rope_theta=1e6,
    tie_embeddings=False,
    remat="full",
    fsdp=True,
)
