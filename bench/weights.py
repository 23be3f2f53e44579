"""Seeded weights, made where they are served, in a few large draws.

One ``torch.Generator`` on the target device, seeded with the run's seed,
draws each kind of weight for every layer at once (``wq`` of all layers in
one call, the experts' ``w_gate`` of all layers in one call, ...), in the
dtype the weights are served in; the per-layer tensors are views of those
draws.  The result is the nested-dict layout the program's ``DecoderLM``
takes (``[in, out]`` matrices, ``blocks`` a list of per-layer dicts), and
the plain reference reads the same dicts.  The same seed gives the same
bits, so the reference can draw them again after the program is gone.
"""

from __future__ import annotations

import torch

from bench.spec import ModelSpec


def make_weights(spec: ModelSpec, seed: int, device,
                 dtype=torch.bfloat16) -> dict:
    """The model's weights from ``seed`` (module docstring).  Norm scales
    follow the served model's convention (``x̂ · (1 + scale)``); the MoE
    router is float32, as the program keeps it."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    L, d, Dh = spec.n_layers, spec.d_model, spec.head_dim
    Hq, Hkv, ff, V = spec.n_heads, spec.n_kv_heads, spec.d_ff, spec.vocab

    def draw(shape, std, dt=dtype):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dt).mul_(std)

    tok = draw((V, d), spec.init_std)
    wq = draw((L, d, Hq * Dh), spec.init_std)
    wk = draw((L, d, Hkv * Dh), spec.init_std)
    wv = draw((L, d, Hkv * Dh), spec.init_std)
    wo = draw((L, Hq * Dh, d), spec.out_std)
    if spec.family == "moe":
        E = spec.n_experts
        router = draw((L, d, E), spec.init_std, torch.float32)
        gate = draw((L, E, d, ff), spec.init_std)
        up = draw((L, E, d, ff), spec.init_std)
        down = draw((L, E, ff, d), spec.out_std)
    else:
        gate = draw((L, d, ff), spec.init_std)
        up = draw((L, d, ff), spec.init_std)
        down = draw((L, ff, d), spec.out_std)
    scales = (draw((2 * L + 1, d), spec.norm_scale_std)
              if spec.norm == "rmsnorm" else None)

    def norm(i):
        return {} if scales is None else {"scale": scales[i]}

    blocks = []
    for l in range(L):
        blk = {"ln1": norm(2 * l),
               "attn": {"wq": wq[l], "wk": wk[l], "wv": wv[l], "wo": wo[l]},
               "ln2": norm(2 * l + 1)}
        if spec.family == "moe":
            blk["moe"] = {"w_router": router[l], "w_gate": gate[l],
                          "w_up": up[l], "w_down": down[l]}
        else:
            blk["mlp"] = {"w_gate": gate[l], "w_up": up[l],
                          "w_down": down[l]}
        blocks.append(blk)
    params = {"embed": {"tok": tok}, "blocks": blocks,
              "final_norm": norm(2 * L)}
    if not spec.tied:
        params["lm_head"] = draw((d, V), spec.init_std)
    return params
