"""mamba2-780m [ssm] — 48L, d_model=1536, attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality) mixer.  [arXiv:2405.21060]

The paper's paged-KV technique is INAPPLICABLE here (DESIGN.md §5): the SSM
state is a fixed-size register file — there is nothing to page or reclaim.
Implemented without the technique, as the assignment requires.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,  # no MLP: pure mixer stack
    vocab=50280,
    ssm_state=128,
    tie_embeddings=True,
    remat="full",
    fsdp=False,
)
