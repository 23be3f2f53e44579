"""olmoe-1b-7b [moe] — 16L, d_model=2048, 16H (kv=16), expert d_ff=1024,
vocab=50304, 64 experts top-8.  [arXiv:2409.02060]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,  # per-expert hidden size
    vocab=50304,
    moe=True,
    n_experts=64,
    top_k=8,
    tie_embeddings=False,
    remat="full",
    fsdp=False,
)
