"""recurrentgemma-9b [hybrid] — 38L (pattern rec,rec,local-attn = 2:1),
d_model=4096, 16H (MQA kv=1), d_ff=12288, vocab=256000, RG-LRU recurrence,
local attention window 2048.  [arXiv:2402.19427]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,  # 12 (rec,rec,attn) groups + 2 trailing recurrent layers
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    local_window=2048,
    rnn_width=4096,
    mlp_type="geglu",
    embed_scale=True,
    tie_embeddings=True,
    remat="full",
    fsdp=True,
)
