"""nemotron-4-15b [dense] — 32L, d_model=6144, 48H (GQA kv=8), d_ff=24576,
vocab=256000.  Squared-ReLU MLP, LayerNorm.  [arXiv:2402.16819]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    norm_type="layernorm",
    mlp_type="relu2",
    tie_embeddings=False,
    remat="full",
    fsdp=True,
)
