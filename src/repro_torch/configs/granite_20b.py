"""granite-20b [dense] — 52L, d_model=6144, 48H (MQA kv=1), d_ff=24576,
vocab=49152.  Llama-style code model with multi-query attention.
[arXiv:2405.04324]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    tie_embeddings=False,
    remat="full",
    fsdp=True,
)
