"""The sizes of the families ``dense`` and ``moe`` (``bench/decoder.py``):
a model configuration file (``bench/configs/<name>.json``) read into the
sizes the weights, the reference and the FLOP arithmetic use.

The file holds the published ``config.json`` keys at its top level;
``family`` (``dense`` or ``moe``), ``norm`` (``nonparam_ln``, eps 1e-5,
or ``rmsnorm`` with ``rms_norm_eps``), the sizes the benchmark assumes
(``assumed``), where the served model departs from the published one
(``departures``) and the values the program serves in their place
(``served``, which the reference follows) sit beside them.  Imports nothing of the
program, so the plain reference can use it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    family: str  # dense | moe
    norm: str  # nonparam_ln | rmsnorm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int  # the MLP's hidden width, or each expert's
    vocab: int
    rope_theta: float
    tied: bool
    n_experts: int = 0
    top_k: int = 0
    norm_eps: float = 1e-5
    init_std: float = 0.02
    norm_scale_std: float = 0.0

    @property
    def out_std(self) -> float:
        """Scale of the projections into the residual stream."""
        return self.init_std / (2 * self.n_layers) ** 0.5

    def active_params(self) -> int:
        """Parameters a token's forward multiplies by outside the embedding
        and the unembedding: attention and the MLP, or the router and the
        ``top_k`` experts a token is routed to."""
        d, Dh = self.d_model, self.head_dim
        attn = d * Dh * (2 * self.n_heads + 2 * self.n_kv_heads)
        if self.family == "moe":
            ffn = d * self.n_experts + self.top_k * 3 * d * self.d_ff
        else:
            ffn = 3 * d * self.d_ff
        return self.n_layers * (attn + ffn)


def model_spec(raw: dict) -> ModelSpec:
    """The :class:`ModelSpec` a configuration file's object describes."""
    heads = raw["num_attention_heads"]
    d = raw["hidden_size"]
    assumed = raw.get("assumed", {})
    served = {**raw, **raw.get("served", {})}
    return ModelSpec(
        name=raw["name"], family=raw["family"], norm=raw["norm"],
        n_layers=raw["num_hidden_layers"], d_model=d, n_heads=heads,
        n_kv_heads=raw.get("num_key_value_heads", heads),
        head_dim=raw.get("head_dim") or d // heads,
        d_ff=raw["intermediate_size"], vocab=raw["vocab_size"],
        rope_theta=float(raw.get("rope_theta", 1e4)),
        tied=bool(raw.get("tie_word_embeddings", False)),
        n_experts=raw.get("num_experts", 0),
        top_k=raw.get("num_experts_per_tok", 0),
        norm_eps=float(served.get("rms_norm_eps", 1e-5)),
        init_std=float(assumed.get("init_std", 0.02)),
        norm_scale_std=float(assumed.get("norm_scale_std", 0.0)))
