"""The plain float32 forward of family ``afmoe`` (arcee-ai's Trinity-Mini,
``model_type: afmoe``), its fp8 control and its bf16 witness.

One sequence at a time, whole, from the benchmark's own nested dicts of
weights (``bench/families/afmoe.py::weights``), upcast one product at a
time, so that a layer is float32 only while it runs and the reference
fits beside the bf16 weights.  Every product runs in float32 with TF32 off
(:func:`bench.reference.model.strict_float32`).  No cache, no batching,
no kernel, nothing of the program.

The equations (the configuration file's ``equations``, each with its
source), x the residual stream, RMSNorm ``x̂ · (1 + scale)`` with the
configuration's eps:

- ``x = E[tok] · sqrt(d)`` (``mup_enabled``);
- per layer: ``h = norm_in(x)``; ``q, k, v, g = h·Wq, h·Wk, h·Wv, h·Wg``;
  q and k RMS-normalised over each head's D dims (QK-norm); split-half
  RoPE on q and k in ``sliding_attention`` layers only; causal GQA with
  scale 1/√D, in a sliding layer query i seeing key j only when i − j <
  W; ``o = (attn · sigmoid(g)) · Wo``; ``x = x + norm_post_attn(o)``;
  ``x = x + norm_post_mlp(F(norm_pre_mlp(x)))``;
- F: a SwiGLU of ``intermediate_size`` in the first ``num_dense_layers``
  layers; after them the experts: ``s = sigmoid(h·Wr)`` in float32, the
  k experts of ``top_k(s + b)`` (b the selection bias; a stable sort, ties
  to the lower index), gates ``s[chosen] / (Σ s[chosen] + 1e-20) ·
  route_scale``, and ``F(h) = shared(h) + Σ gate_e · expert_e(h)``, every
  expert a SwiGLU of ``moe_intermediate_size`` run on the tokens routed to
  it, gathered, not padded;
- the final norm and the untied head.

Attention runs over blocks of ``block`` queries, each against the keys it
can see only (its window's in a sliding layer), so a 17k-token sequence
fits.  ``precision="fp8"`` is the control of the correctness check: every
matrix product of a weight takes its operands rounded to float8 e4m3 (per
row for activations, per output column for weights; float32
accumulation), the rest stays float32 — the step below the served bf16.
``precision="bf16"`` is the witness of ``bench/tools/witness.py``: every
such product as the program's bf16 one (operands and result rounded to
bfloat16, float32 accumulation), the rest float32 — what rounding the
products to the served precision alone costs.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from bench.reference.model import _Matmul, _rope, strict_float32


@dataclasses.dataclass(frozen=True)
class AfmoeSpec:
    """The sizes of an ``afmoe`` configuration file (:func:`spec`)."""

    name: str
    vocab: int
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int  # the leading dense layers' SwiGLU
    moe_ff: int  # each expert's
    shared_ff: int  # the shared expert's
    n_experts: int
    top_k: int
    n_dense: int
    window: int
    layer_types: tuple
    rope_theta: float
    norm_eps: float
    route_scale: float
    init_std: float = 0.02
    norm_scale_std: float = 0.0
    bias_std: float = 0.0

    @property
    def out_std(self) -> float:
        """Scale of the projections into the residual stream."""
        return self.init_std / (2 * self.n_layers) ** 0.5

    def sliding(self, layer: int) -> bool:
        return self.layer_types[layer] == "sliding_attention"

    @property
    def n_sliding(self) -> int:
        return sum(map(self.sliding, range(self.n_layers)))

    def active_params(self) -> int:
        """Parameters a token's forward multiplies by outside the embedding
        and the head: per layer q, k, v, the gate and o, and the dense
        SwiGLU or the router, the ``top_k`` experts and the shared one."""
        d, Dh = self.d_model, self.head_dim
        attn = d * Dh * (3 * self.n_heads + 2 * self.n_kv_heads)
        dense = 3 * d * self.d_ff
        moe = (d * self.n_experts + self.top_k * 3 * d * self.moe_ff
               + 3 * d * self.shared_ff)
        n_moe = self.n_layers - self.n_dense
        return self.n_layers * attn + self.n_dense * dense + n_moe * moe


def spec(raw: dict) -> AfmoeSpec:
    """The :class:`AfmoeSpec` of a configuration file's object: the
    published keys, and ``assumed`` for what the publication leaves open
    (the weights' scales)."""
    if (raw.get("score_func") != "sigmoid" or not raw.get("route_norm")
            or not raw.get("mup_enabled") or raw.get("tie_word_embeddings")):
        raise ValueError(f"{raw['name']}: family afmoe serves sigmoid "
                         f"routing with route_norm, mup and an untied head")
    assumed = raw.get("assumed", {})
    return AfmoeSpec(
        name=raw["name"], vocab=raw["vocab_size"],
        n_layers=raw["num_hidden_layers"], d_model=raw["hidden_size"],
        n_heads=raw["num_attention_heads"],
        n_kv_heads=raw["num_key_value_heads"], head_dim=raw["head_dim"],
        d_ff=raw["intermediate_size"], moe_ff=raw["moe_intermediate_size"],
        shared_ff=raw["num_shared_experts"] * raw["moe_intermediate_size"],
        n_experts=raw["num_experts"], top_k=raw["num_experts_per_tok"],
        n_dense=raw["num_dense_layers"], window=raw["sliding_window"],
        layer_types=tuple(raw["layer_types"][:raw["num_hidden_layers"]]),
        rope_theta=float(raw["rope_theta"]),
        norm_eps=float(raw["rms_norm_eps"]),
        route_scale=float(raw["route_scale"]),
        init_std=float(assumed.get("init_std", 0.02)),
        norm_scale_std=float(assumed.get("norm_scale_std", 0.0)),
        bias_std=float(assumed.get("router_bias_std", 0.0)))


def _bf16_matmul(x, w):
    return (x.bfloat16() @ w.bfloat16()).float()


def _rms(spec: AfmoeSpec, x, scale):
    y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + spec.norm_eps)
    return y * (1.0 + scale.float())


def _attention(spec: AfmoeSpec, layer: int, h, p, mm, block: int):
    S = h.shape[0]
    Hq, Hkv, D = spec.n_heads, spec.n_kv_heads, spec.head_dim
    G = Hq // Hkv
    W = spec.window if spec.sliding(layer) else 0
    pos = torch.arange(S, device=h.device)
    q = _rms(spec, mm(h, p["wq"]).view(S, Hq, D), p["q_norm"])
    k = _rms(spec, mm(h, p["wk"]).view(S, Hkv, D), p["k_norm"])
    v = mm(h, p["wv"]).view(S, Hkv, D)
    if W:
        q = _rope(q, pos, spec.rope_theta)
        k = _rope(k, pos, spec.rope_theta)
    qg = q.view(S, Hkv, G, D)
    out = torch.empty(S, Hkv, G, D, device=h.device)
    for q0 in range(0, S, block):
        q1 = min(S, q0 + block)
        k0 = max(0, q0 - W + 1) if W else 0
        sc = torch.einsum("qhgd,khd->hgqk", qg[q0:q1], k[k0:q1]) / math.sqrt(D)
        gap = pos[q0:q1, None] - pos[None, k0:q1]  # i - j
        seen = (gap >= 0) & (gap < W) if W else gap >= 0
        sc = sc.masked_fill(~seen, -math.inf)
        out[q0:q1] = torch.einsum("hgqk,khd->qhgd", torch.softmax(sc, -1),
                                  v[k0:q1])
        del sc
    gate = torch.sigmoid(mm(h, p["wg"]))
    return mm(out.reshape(S, Hq * D) * gate, p["wo"])


def _swiglu(h, wg, wu, wd, mm):
    return mm(F.silu(mm(h, wg)) * mm(h, wu), wd)


def _moe(spec: AfmoeSpec, h, p, mm):
    """The shared expert, plus each chosen expert on the tokens routed to
    it under its gate."""
    s = torch.sigmoid(mm(h, p["w_router"]))
    expert = torch.sort(s + p["router_bias"].float(), dim=-1,
                        descending=True, stable=True).indices[:, :spec.top_k]
    gate = torch.gather(s, 1, expert)
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-20) * spec.route_scale
    y = _swiglu(h, p["ws_gate"], p["ws_up"], p["ws_down"], mm)
    for e in torch.unique(expert).tolist():
        rows, slot = torch.nonzero(expert == e, as_tuple=True)
        out = _swiglu(h[rows], p["w_gate"][e], p["w_up"][e], p["w_down"][e],
                      mm)
        y.index_add_(0, rows, out * gate[rows, slot, None])
    return y


def forward_logits(spec: AfmoeSpec, params: dict, tokens,
                   precision: str = "fp32", block: int = 512) -> torch.Tensor:
    """Logits [S, vocab] float32 of one sequence ``tokens`` [S] (position
    ``i``'s row predicts token ``i + 1``)."""
    mm = _bf16_matmul if precision == "bf16" else _Matmul(precision)
    tokens = torch.as_tensor(tokens, device=params["embed"]["tok"].device)
    with strict_float32():
        x = params["embed"]["tok"][tokens].float() * math.sqrt(spec.d_model)
        for layer, blk in enumerate(params["blocks"]):
            h = _rms(spec, x, blk["ln1"]["scale"])
            x = x + _rms(spec, _attention(spec, layer, h, blk["attn"], mm,
                                          block), blk["post_attn"]["scale"])
            h = _rms(spec, x, blk["ln2"]["scale"])
            if "moe" in blk:
                f = _moe(spec, h, blk["moe"], mm)
            else:
                m = blk["mlp"]
                f = _swiglu(h, m["w_gate"], m["w_up"], m["w_down"], mm)
            x = x + _rms(spec, f, blk["post_mlp"]["scale"])
        x = _rms(spec, x, params["final_norm"]["scale"])
        return mm(x, params["lm_head"])
