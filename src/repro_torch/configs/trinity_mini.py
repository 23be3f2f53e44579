"""trinity-mini [afmoe] — arcee-ai Trinity-Mini: 32L in periods of three
sliding-window layers (W=2048, split-half RoPE) and one full layer (no
position encoding), d_model=2048, 32H on 4 KV heads of 128, QK-norm, a
sigmoid gate on the attention output, four RMSNorms a layer (eps 1e-5),
embeddings × sqrt(d_model); the first 2 layers a SwiGLU of 6144, then 128
experts of 1024, top-8 by sigmoid scores with a selection bias, gates
renormalised and × 2.826, plus one shared expert of 1024; vocab=200192,
untied.  [https://huggingface.co/arcee-ai/Trinity-Mini/blob/main/config.json]

Served by the paged path only: the JAX package has no counterpart, so the
name is in ``configs.PORT_ARCH_IDS`` and not in ``ARCH_IDS``.  ``TINY`` is
its CPU-test preset (``configs.reduced``): every kind of layer at a small
width, a window of 8 that crosses 4-token pages.
"""

import dataclasses

from .base import PortArchConfig

_PERIOD = ("sliding_attention",) * 3 + ("full_attention",)

CONFIG = PortArchConfig(
    name="trinity-mini",
    family="afmoe",
    n_layers=32,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1024,  # per-expert hidden size (moe_intermediate_size)
    vocab=200192,
    rope_theta=10000.0,
    moe=True,
    n_experts=128,
    top_k=8,
    tie_embeddings=False,
    embed_scale=True,  # mup_enabled
    layer_types=_PERIOD * 8,
    attn_window=2048,
    rope_layers="sliding",
    qk_norm=True,
    attn_gate=True,
    sandwich_norm=True,
    norm_eps=1e-5,
    dense_layers=2,
    dense_ff=6144,
    shared_ff=1024,
    router_score="sigmoid",
    router_bias=True,
    route_scale=2.826,
    remat="none",
    fsdp=False,
)

TINY = dataclasses.replace(
    CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=32, vocab=512, vocab_padded=512, n_experts=8, top_k=2,
    layer_types=_PERIOD + _PERIOD[:1], attn_window=8, dense_layers=1,
    dense_ff=96, shared_ff=32, attn_chunk=16, loss_chunk=32, max_seq=128)
