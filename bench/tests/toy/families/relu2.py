"""Family ``relu2``, a toy for the tests: a dense decoder LM whose every
layer is non-parametric LayerNorm, full causal attention with split-half
RoPE, non-parametric LayerNorm and a squared-ReLU MLP (no gate), with tied
embeddings.  Written against the family contract of ``bench/cells.py``
alone; its plain reference is ``reference/relu2.py`` beside this file's
directory, loaded by path."""

from __future__ import annotations

import dataclasses
import pathlib

import torch

from bench.cells import load_file
from bench.roofline import attention_work as layer_attention_work

forward_logits = load_file(
    pathlib.Path(__file__).resolve().parents[1] / "reference" / "relu2.py",
    "bench_reference").forward_logits


@dataclasses.dataclass(frozen=True)
class Relu2Spec:
    name: str
    vocab: int
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    rope_theta: float
    init_std: float

    @property
    def out_std(self) -> float:
        return self.init_std / (2 * self.n_layers) ** 0.5


def spec(raw: dict) -> Relu2Spec:
    heads = raw["num_attention_heads"]
    return Relu2Spec(
        name=raw["name"], vocab=raw["vocab_size"],
        n_layers=raw["num_hidden_layers"], d_model=raw["hidden_size"],
        n_heads=heads, n_kv_heads=raw.get("num_key_value_heads", heads),
        head_dim=raw["hidden_size"] // heads,
        d_ff=raw["intermediate_size"], rope_theta=float(raw["rope_theta"]),
        init_std=float(raw["assumed"]["init_std"]))


def weights(spec: Relu2Spec, seed: int, device,
            dtype=torch.bfloat16) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    L, d, Dh = spec.n_layers, spec.d_model, spec.head_dim
    Hq, Hkv, ff = spec.n_heads, spec.n_kv_heads, spec.d_ff

    def draw(shape, std):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dtype).mul_(std)

    tok = draw((spec.vocab, d), spec.init_std)
    wq = draw((L, d, Hq * Dh), spec.init_std)
    wk = draw((L, d, Hkv * Dh), spec.init_std)
    wv = draw((L, d, Hkv * Dh), spec.init_std)
    wo = draw((L, Hq * Dh, d), spec.out_std)
    up = draw((L, d, ff), spec.init_std)
    down = draw((L, ff, d), spec.out_std)
    blocks = [{"ln1": {}, "ln2": {},
               "attn": {"wq": wq[l], "wk": wk[l], "wv": wv[l], "wo": wo[l]},
               "mlp": {"w_up": up[l], "w_down": down[l]}} for l in range(L)]
    return {"embed": {"tok": tok}, "blocks": blocks, "final_norm": {}}


def program_config(spec: Relu2Spec):
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(
        name=spec.name, family="dense", n_layers=spec.n_layers,
        d_model=spec.d_model, n_heads=spec.n_heads,
        n_kv_heads=spec.n_kv_heads, d_ff=spec.d_ff, vocab=spec.vocab,
        vocab_padded=spec.vocab, head_dim=spec.head_dim,
        rope_theta=spec.rope_theta, norm_type="nonparam_ln",
        mlp_type="relu2", tie_embeddings=True, remat="none", fsdp=False)


def model_flops(spec: Relu2Spec, spans, generated: int) -> float:
    d, Dh, Hq, Hkv = spec.d_model, spec.head_dim, spec.n_heads, spec.n_kv_heads
    active = spec.n_layers * (d * Dh * (2 * Hq + 2 * Hkv) + 2 * d * spec.d_ff)
    n = sum(c1 - c0 for c0, c1 in spans)
    ctx = sum((c1 * (c1 + 1) - c0 * (c0 + 1)) // 2 for c0, c1 in spans)
    return (2.0 * active * n + 4.0 * spec.n_layers * Hq * Dh * ctx
            + 2.0 * d * spec.vocab * generated)


def attention_work(spec: Relu2Spec, rows):
    byts, ops = layer_attention_work(spec, rows)
    return spec.n_layers * byts, spec.n_layers * ops


def attention_launches(spec: Relu2Spec) -> int:
    return spec.n_layers
