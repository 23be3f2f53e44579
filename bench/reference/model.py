"""Plain float32 forwards of the benchmark's decoder LMs, and their fp8
control.

One sequence at a time, whole: embed, then per layer a norm, causal
multi-head attention with split-half RoPE, a norm and the feed-forward
layer, then a final norm and the logits.  Every product runs in float32
with TF32 off (:func:`strict_float32`).  No cache, no batching, no
kernel, nothing of the program: the weights are the benchmark's own
nested dicts (``bench/weights.py``), upcast layer by layer.

- Dense (``olmo-1b``): non-parametric LayerNorm (eps 1e-5), SwiGLU, tied
  embeddings — as published (arXiv:2402.00838).
- MoE (``olmoe-1b-7b``): RMSNorm (``x̂ · (1 + scale)``, the eps served),
  a float32 router, top-``k`` of ``E`` experts by a stable descending sort
  (ties to the lower index), the ``k`` gates renormalised to sum to 1, and
  each expert's SwiGLU run on the tokens routed to it, gathered, not
  padded.  Departures from the published OLMoE-1B-7B, which the served
  model makes and this reference follows: no QK-norm, and the top-k gates
  renormalised where the published config sets ``norm_topk_prob: false``;
  the RMSNorm eps is 1e-6 where the published one is 1e-5 (the
  configuration file's ``served`` values).

``precision="fp8"`` is the control of the correctness check: every matrix
product takes its operands rounded to float8 e4m3 (per-row scales for
activations, per-output-column scales for weights; float32 accumulation),
the rest stays float32 — the step below the served bf16.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from bench.spec import ModelSpec

E4M3_MAX = 448.0


@contextlib.contextmanager
def strict_float32():
    """float32 products without TF32 (restored on exit)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to e4m3 with one absmax scale per slice along
    ``dim``, back in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = E4M3_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


class _Matmul:
    """``x @ w`` in float32, or on fp8-rounded operands."""

    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def __call__(self, x, w):
        w = w.float()
        if self.fp8:
            x, w = _fp8(x, -1), _fp8(w, -2)
        return x @ w


def _norm(spec: ModelSpec, x, p):
    if spec.norm == "nonparam_ln":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-5)
    if spec.norm == "rmsnorm":
        y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + spec.norm_eps)
        return y * (1.0 + p["scale"].float())
    raise ValueError(spec.norm)


def _rope(x, positions, theta):
    """Split-half rotary embedding of x [S, H, D] at ``positions`` [S]."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[:, None] * freqs
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(spec, h, p, mm, positions):
    S = h.shape[0]
    Hq, Hkv, D = spec.n_heads, spec.n_kv_heads, spec.head_dim
    q = _rope(mm(h, p["wq"]).view(S, Hq, D), positions, spec.rope_theta)
    k = _rope(mm(h, p["wk"]).view(S, Hkv, D), positions, spec.rope_theta)
    v = mm(h, p["wv"]).view(S, Hkv, D)
    rep = Hq // Hkv
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(D)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, -math.inf)
    out = torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), v)
    return mm(out.reshape(S, Hq * D), p["wo"])


def _swiglu(h, wg, wu, wd, mm):
    return mm(F.silu(mm(h, wg)) * mm(h, wu), wd)


def _moe(spec, h, p, mm):
    """Top-k routing, each expert run on the tokens routed to it."""
    probs = torch.softmax(mm(h, p["w_router"]), dim=-1)
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = gate[:, :spec.top_k], expert[:, :spec.top_k]
    gate = gate / gate.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in torch.unique(expert).tolist():
        rows, slot = torch.nonzero(expert == e, as_tuple=True)
        out = _swiglu(h[rows], p["w_gate"][e], p["w_up"][e], p["w_down"][e],
                      mm)
        y.index_add_(0, rows, out * gate[rows, slot, None])
    return y


def forward_logits(spec: ModelSpec, params: dict, tokens,
                   precision: str = "fp32") -> torch.Tensor:
    """Logits [S, vocab] float32 of one sequence ``tokens`` [S] (position
    ``i``'s row predicts token ``i + 1``)."""
    mm = _Matmul(precision)
    tokens = torch.as_tensor(tokens, device=params["embed"]["tok"].device)
    positions = torch.arange(tokens.shape[0], device=tokens.device)
    with strict_float32():
        x = params["embed"]["tok"][tokens].float()
        for blk in params["blocks"]:
            x = x + _attention(spec, _norm(spec, x, blk["ln1"]), blk["attn"],
                               mm, positions)
            h = _norm(spec, x, blk["ln2"])
            if spec.family == "moe":
                x = x + _moe(spec, h, blk["moe"], mm)
            else:
                m = blk["mlp"]
                x = x + _swiglu(h, m["w_gate"], m["w_up"], m["w_down"], mm)
        x = _norm(spec, x, params["final_norm"])
        head = (params["embed"]["tok"].T if spec.tied
                else params["lm_head"])
        return mm(x, head)
