"""Family ``afmoe`` (``trinity-mini``, arcee-ai's Trinity-Mini): periods of
three sliding-window layers and one full-attention layer, QK-norm, a
sigmoid gate on the attention output, four RMSNorms a layer, leading dense
SwiGLU layers, then sigmoid-routed experts with a selection bias and a
shared expert.  The family contract of ``bench/cells.py``, and
:func:`expert_work` and :data:`EXPERT_KERNELS` for the expert layer's
roofline (``bench/metrics/expert_roofline.py``).  Sizes and the plain
reference: ``bench/reference/afmoe.py``.
"""

from __future__ import annotations

import torch

from bench.reference.afmoe import AfmoeSpec
from bench.reference.afmoe import forward_logits  # noqa: F401
from bench.reference.afmoe import spec  # noqa: F401

#: the device kernels of the serving path's grouped expert products
#: (``torch._grouped_mm`` on sm_90, read from a traced run on the H100):
#: CUTLASS's grouped GEMM, whose name holds ``GroupProblemShape``, and the
#: kernel that lays out its problem sizes
EXPERT_KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def weights(spec: AfmoeSpec, seed: int, device,
            dtype=torch.bfloat16) -> dict:
    """The weights from ``seed``, drawn kind by kind for every layer at once
    on ``device`` (``bench/weights.py``'s scheme), in the nested dicts the
    program's ``DecoderLM`` takes.  Norm scales follow the served
    convention ``x̂ · (1 + scale)``; the router and its selection bias are
    float32, as the program keeps them."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    L, d, Dh = spec.n_layers, spec.d_model, spec.head_dim
    Hq, Hkv, V = spec.n_heads, spec.n_kv_heads, spec.vocab
    Ld, Lm = spec.n_dense, spec.n_layers - spec.n_dense
    E, ff, sff = spec.n_experts, spec.moe_ff, spec.shared_ff
    std, out = spec.init_std, spec.out_std

    def draw(shape, s, dt=dtype):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dt).mul_(s)

    tok = draw((V, d), std)
    wq = draw((L, d, Hq * Dh), std)
    wk = draw((L, d, Hkv * Dh), std)
    wv = draw((L, d, Hkv * Dh), std)
    wg = draw((L, d, Hq * Dh), std)
    wo = draw((L, Hq * Dh, d), out)
    qk = draw((2 * L, Dh), spec.norm_scale_std)
    norms = draw((4 * L + 1, d), spec.norm_scale_std)
    mlp = (draw((Ld, d, spec.d_ff), std), draw((Ld, d, spec.d_ff), std),
           draw((Ld, spec.d_ff, d), out))
    router = draw((Lm, d, E), std, torch.float32)
    bias = draw((Lm, E), spec.bias_std, torch.float32)
    gate, up = draw((Lm, E, d, ff), std), draw((Lm, E, d, ff), std)
    down = draw((Lm, E, ff, d), out)
    shared = (draw((Lm, d, sff), std), draw((Lm, d, sff), std),
              draw((Lm, sff, d), out))
    blocks = []
    for l in range(L):
        blk = {"ln1": {"scale": norms[4 * l]},
               "attn": {"wq": wq[l], "wk": wk[l], "wv": wv[l], "wo": wo[l],
                        "wg": wg[l], "q_norm": qk[2 * l],
                        "k_norm": qk[2 * l + 1]},
               "post_attn": {"scale": norms[4 * l + 1]},
               "ln2": {"scale": norms[4 * l + 2]},
               "post_mlp": {"scale": norms[4 * l + 3]}}
        if l < Ld:
            blk["mlp"] = {"w_gate": mlp[0][l], "w_up": mlp[1][l],
                          "w_down": mlp[2][l]}
        else:
            m = l - Ld
            blk["moe"] = {"w_router": router[m], "router_bias": bias[m],
                          "w_gate": gate[m], "w_up": up[m],
                          "w_down": down[m], "ws_gate": shared[0][m],
                          "ws_up": shared[1][m], "ws_down": shared[2][m]}
        blocks.append(blk)
    return {"embed": {"tok": tok}, "blocks": blocks,
            "final_norm": {"scale": norms[4 * L]},
            "lm_head": draw((d, V), std)}


def program_config(spec: AfmoeSpec):
    """The program's config object for ``spec``."""
    from repro_torch.configs.base import PortArchConfig

    return PortArchConfig(
        name=spec.name, family="afmoe", n_layers=spec.n_layers,
        d_model=spec.d_model, n_heads=spec.n_heads,
        n_kv_heads=spec.n_kv_heads, d_ff=spec.moe_ff, vocab=spec.vocab,
        vocab_padded=spec.vocab, head_dim=spec.head_dim,
        rope_theta=spec.rope_theta, norm_type="rmsnorm", mlp_type="swiglu",
        moe=True, n_experts=spec.n_experts, top_k=spec.top_k,
        tie_embeddings=False, embed_scale=True,
        layer_types=spec.layer_types, attn_window=spec.window,
        rope_layers="sliding", qk_norm=True, attn_gate=True,
        sandwich_norm=True, norm_eps=spec.norm_eps,
        dense_layers=spec.n_dense, dense_ff=spec.d_ff,
        shared_ff=spec.shared_ff, router_score="sigmoid", router_bias=True,
        route_scale=spec.route_scale, remat="none",
        fsdp=False)


def _seen(c0: int, c1: int, W: int) -> int:
    """Σ over positions p = c0 .. c1 - 1 of the keys p sees: p + 1, or at
    most W (0: no window)."""
    def upto(n):  # Σ_{p < n} min(p + 1, W)
        if not W or n <= W:
            return n * (n + 1) // 2
        return W * (W + 1) // 2 + (n - W) * W
    return upto(c1) - upto(c0)


def model_flops(spec: AfmoeSpec, spans, generated: int) -> float:
    """Model FLOPs of the window's useful work: 2 × active parameters a
    computed position, attention's 4·Hq·D a (position, key it sees) pair in
    each layer — position + 1 keys in a full layer, at most W in a sliding
    one — and the head's 2·d·vocab a generated token.  ``spans``: each
    request's (c0, c1), its positions c0 .. c1 - 1 computed in the
    window."""
    n = sum(c1 - c0 for c0, c1 in spans)
    n_full = spec.n_layers - spec.n_sliding
    pairs = sum(n_full * _seen(c0, c1, 0)
                + spec.n_sliding * _seen(c0, c1, spec.window)
                for c0, c1 in spans)
    return (2.0 * spec.active_params() * n
            + 4.0 * spec.n_heads * spec.head_dim * pairs
            + 2.0 * spec.d_model * spec.vocab * generated)


def _layer_work(spec: AfmoeSpec, rows, W: int, itemsize: int = 2):
    """(bytes, ops) of one layer's fused append-and-attention launch over
    ``rows`` ((context before the step, tokens appended) per row), as
    ``bench/roofline.py`` counts them, with window W: the keys read are
    those some query of the chunk sees, from ``before + 1 − W`` on."""
    Hq, Hkv, D = spec.n_heads, spec.n_kv_heads, spec.head_dim
    byts = ops = 0
    for before, n in rows:
        if n <= 0:
            continue
        first = max(0, before + 1 - W) if W else 0
        byts += 2 * (before + n - first) * Hkv * D * itemsize  # K/V read
        byts += 2 * 2 * n * Hkv * D * itemsize  # new K/V in, then written
        byts += 2 * n * Hq * D * itemsize  # q in, out written
        ops += 4 * D * Hq * _seen(before, before + n, W)
    return byts, ops


def attention_work(spec: AfmoeSpec, rows):
    """(bytes, ops) of one step's attention over ``rows`` in every layer:
    the full layers' launches over every key, the sliding layers' over
    their windows."""
    full = _layer_work(spec, rows, 0)
    slid = _layer_work(spec, rows, spec.window)
    n_full = spec.n_layers - spec.n_sliding
    return (n_full * full[0] + spec.n_sliding * slid[0],
            n_full * full[1] + spec.n_sliding * slid[1])


def attention_launches(spec: AfmoeSpec) -> int:
    """``paged_attention_kernel`` launches a step: one a layer."""
    return spec.n_layers


def expert_work(spec: AfmoeSpec, tokens: int, itemsize: int = 2):
    """(bytes, FLOPs) of one step's grouped expert products, in all its
    expert layers, over its ``tokens`` live tokens: each token's ``top_k``
    assignments through the gate, up and down products (2·3·d·ff FLOPs an
    assignment); each product's input read and output written once; and
    the weights of the experts the step touches, E·(1 − (1 − k/E)^tokens)
    of them, the expected count under uniform routing.  The shared expert
    is a plain product and not counted here."""
    if tokens <= 0:
        return 0, 0
    d, ff, E, k = spec.d_model, spec.moe_ff, spec.n_experts, spec.top_k
    A = tokens * k
    touched = E * (1.0 - (1.0 - k / E) ** tokens)
    byts = (touched * 3 * d * ff + A * 3 * (d + ff)) * itemsize
    flops = 2.0 * A * 3 * d * ff
    n_moe = spec.n_layers - spec.n_dense
    return n_moe * byts, n_moe * flops
