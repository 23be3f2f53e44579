"""mixtral-8x7b [moe] — 32L, d_model=4096, 32H (GQA kv=8), expert d_ff=14336,
vocab=32000, 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,  # per-expert hidden size
    vocab=32000,
    moe=True,
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    rope_theta=1e6,
    tie_embeddings=False,
    remat="full",
    fsdp=True,
)
