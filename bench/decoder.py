"""The family contract (``bench/cells.py``) of ``dense`` and ``moe``, the
decoder LMs the benchmark first served (``olmo-1b``, ``olmoe-1b-7b``):
every layer full causal attention with split-half RoPE, then a SwiGLU MLP
or (``moe``) the dropless top-k SwiGLU expert layer.
``bench/families/dense.py`` and ``bench/families/moe.py`` are this
module; ``ModelSpec.family`` tells the two apart.

Sizes: ``bench/spec.py``.  Weights: ``bench/weights.py``.  The plain
reference and its fp8 control: ``bench/reference/model.py``.  One
layer's attention work: ``bench/roofline.py``.
"""

from __future__ import annotations

from bench.reference.model import forward_logits  # noqa: F401
from bench.roofline import attention_work as layer_attention_work
from bench.spec import ModelSpec
from bench.spec import model_spec as spec  # noqa: F401
from bench.weights import make_weights as weights  # noqa: F401


def program_config(spec: ModelSpec):
    """The program's config object for ``spec``."""
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(
        name=spec.name, family=spec.family, n_layers=spec.n_layers,
        d_model=spec.d_model, n_heads=spec.n_heads,
        n_kv_heads=spec.n_kv_heads, d_ff=spec.d_ff, vocab=spec.vocab,
        vocab_padded=spec.vocab, head_dim=spec.head_dim,
        rope_theta=spec.rope_theta, norm_type=spec.norm, mlp_type="swiglu",
        moe=spec.family == "moe", n_experts=spec.n_experts,
        top_k=spec.top_k, tie_embeddings=spec.tied, remat="none",
        fsdp=False)


def model_flops(spec: ModelSpec, spans, generated: int) -> float:
    """Model FLOPs of the window's useful work: 2 × active parameters a
    computed position, attention's 4·L·Hq·D·(position + 1), and the
    unembedding's 2·d·vocab a generated token.  ``spans``: each request's
    (c0, c1), its positions c0 .. c1 - 1 computed in the window."""
    n = sum(c1 - c0 for c0, c1 in spans)
    ctx = sum((c1 * (c1 + 1) - c0 * (c0 + 1)) // 2 for c0, c1 in spans)
    return (2.0 * spec.active_params() * n
            + 4.0 * spec.n_layers * spec.n_heads * spec.head_dim * ctx
            + 2.0 * spec.d_model * spec.vocab * generated)


def attention_work(spec: ModelSpec, rows):
    """(bytes, ops) of one step's attention over ``rows`` in every layer:
    the same launch in each."""
    byts, ops = layer_attention_work(spec, rows)
    return spec.n_layers * byts, spec.n_layers * ops


def attention_launches(spec: ModelSpec) -> int:
    """``paged_attention_kernel`` launches a step: one a layer."""
    return spec.n_layers
