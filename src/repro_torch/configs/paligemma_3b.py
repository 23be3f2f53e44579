"""paligemma-3b [vlm] — SigLIP vision frontend (STUBBED: ``input_specs``
provides 256 precomputed patch embeddings at d_model) + gemma-2b decoder:
18L, d_model=2048, 8H (MQA kv=1), d_ff=16384, vocab=257216.
Prefix (image) tokens attend bidirectionally.  [arXiv:2407.07726]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab=257216,
    prefix_tokens=256,
    mlp_type="geglu",
    embed_scale=True,
    tie_embeddings=True,
    remat="full",
    fsdp=True,
)
