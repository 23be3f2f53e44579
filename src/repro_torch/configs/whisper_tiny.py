"""whisper-tiny [audio] — enc-dec, conv frontend stubbed (precomputed frame
embeddings).  4L encoder + 4L decoder, d_model=384, 6H (kv=6), d_ff=1536,
vocab=51865.  [arXiv:2212.04356]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    encoder_layers=4,
    encoder_seq=1500,  # 30s of mel frames after the (stubbed) conv frontend
    use_rope=False,  # learned positional embeddings
    norm_type="layernorm",
    mlp_type="gelu",
    tie_embeddings=True,
    remat="none",
    fsdp=False,  # 37M params: FSDP all-gathers would cost more than they save
)
