"""Architecture config schema + input-shape taxonomy.

Every assigned architecture is an ``ArchConfig``; the four assigned input
shapes are ``SHAPES``.  ``input_specs`` builds fake-tensor stand-ins for
every model input of a given (arch, shape) cell — shapes and dtypes, zero
allocation (torch's ``FakeTensorMode``, the counterpart of jax's
``ShapeDtypeStruct``) — which is what the dry run counts.  The rest is a
copy of ``repro.configs.base``, with one addition: :class:`PortArchConfig`,
the block options of the architectures only the port serves (per-layer
attention kinds, QK-norm, an attention gate, four norms a layer, leading
dense layers, a shared expert, a sigmoid router).  ``ArchConfig`` reads
each of them at its default, today's block, as a class attribute and not a
field, so its fields stay the JAX package's, one for one.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


def _pad128(v: int) -> int:
    return ((v + 127) // 128) * 128


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # derived unless overridden
    head_dim: int = 0
    vocab_padded: int = 0
    # attention
    attn_bias: bool = False
    sliding_window: int | None = None
    use_rope: bool = True
    rope_theta: float = 1e4
    attn_chunk: int = 512  # flash KV-chunk size
    # norm / mlp
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm | nonparam_ln
    mlp_type: str = "swiglu"  # swiglu | geglu | gelu | relu2
    # moe
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    # enc-dec (audio)
    encoder_layers: int = 0
    encoder_seq: int = 0
    # vlm
    prefix_tokens: int = 0
    # hybrid / ssm
    rnn_width: int = 0
    local_window: int | None = None
    ssm_state: int = 0
    ssd_chunk: int = 128
    # embedding / loss / training
    tie_embeddings: bool = True
    embed_scale: bool = False
    max_seq: int = 32768  # learned-pos table size (non-RoPE archs)
    loss_chunk: int = 1024
    remat: str = "full"  # none | dots | full
    # sharding hints (see repro.sharding.rules)
    fsdp: bool = True

    # the block options of :class:`PortArchConfig`, at their defaults (class
    # attributes, not fields: see the module docstring)
    layer_types = None
    attn_window = 0
    rope_layers = "all"
    qk_norm = False
    attn_gate = False
    sandwich_norm = False
    norm_eps = 1e-6
    dense_layers = 0
    dense_ff = 0
    shared_ff = 0
    router_score = "softmax"
    router_bias = False
    route_scale = 1.0

    def __post_init__(self):
        if not self.head_dim and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.vocab_padded:
            object.__setattr__(self, "vocab_padded", _pad128(self.vocab))
        if not self.rnn_width:
            object.__setattr__(self, "rnn_width", self.d_model)

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context without O(S) full-attn cache?"""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs have a decoder

    def window_at(self, layer: int) -> int:
        """Layer ``layer``'s attention window, 0 for full causal
        attention: ``attn_window`` where ``layer_types`` calls the layer
        ``sliding_attention``."""
        if self.layer_types is None:
            return 0
        return (self.attn_window
                if self.layer_types[layer] == "sliding_attention" else 0)

    def rope_at(self, layer: int) -> bool:
        """Does layer ``layer`` rotate q and k (``rope_layers``: ``all``, or
        ``sliding`` for the window layers alone)?"""
        if not self.use_rope:
            return False
        return self.rope_layers == "all" or self.window_at(layer) > 0

    def moe_at(self, layer: int) -> bool:
        """Is layer ``layer``'s feed-forward the expert layer (the first
        ``dense_layers`` layers of an MoE config are a dense MLP of
        ``dense_ff``)?"""
        return self.moe and layer >= self.dense_layers


@dataclass(frozen=True)
class PortArchConfig(ArchConfig):
    """An :class:`ArchConfig` with the port's block options as fields (the
    defaults are ``ArchConfig``'s own block):

    - ``layer_types``: per layer ``"sliding_attention"`` or
      ``"full_attention"`` (None: every layer full); ``attn_window``: the
      window W of the sliding layers (query i sees key j when i − j < W);
      ``rope_layers``: ``"all"``, or ``"sliding"`` where full layers use no
      position encoding;
    - ``qk_norm``: RMSNorm over each head's D dims of q and k (weights
      ``q_norm``, ``k_norm`` [D]); ``attn_gate``: the attention output
      times ``sigmoid(h·Wg)`` before ``wo``; ``sandwich_norm``: four norms
      a layer (``ln1`` before attention, ``post_attn`` on its output,
      ``ln2`` before the MLP, ``post_mlp`` on its output); ``norm_eps``:
      the RMSNorm eps;
    - ``dense_layers``/``dense_ff``: the first layers of an MoE config are
      a SwiGLU of this width; ``shared_ff``: one shared expert of this
      width beside the routed ones (0: none);
    - ``router_score``: ``"softmax"`` or ``"sigmoid"``; ``router_bias``: a
      per-expert selection bias added to the scores for the top-k choice
      only; ``route_scale``: the gates' factor after their
      renormalisation to a sum of 1.
    """

    layer_types: tuple | None = ArchConfig.layer_types
    attn_window: int = ArchConfig.attn_window
    rope_layers: str = ArchConfig.rope_layers
    qk_norm: bool = ArchConfig.qk_norm
    attn_gate: bool = ArchConfig.attn_gate
    sandwich_norm: bool = ArchConfig.sandwich_norm
    norm_eps: float = ArchConfig.norm_eps
    dense_layers: int = ArchConfig.dense_layers
    dense_ff: int = ArchConfig.dense_ff
    shared_ff: int = ArchConfig.shared_ff
    router_score: str = ArchConfig.router_score
    router_bias: bool = ArchConfig.router_bias
    route_scale: float = ArchConfig.route_scale


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Is this (arch, shape) cell runnable?  Returns (ok, reason-if-not)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500k dense-KV decode is the quadratic case the shape taxonomy excludes (DESIGN.md §5)"
    return True, ""


def decode_cache_size(cfg: ArchConfig, shape: ShapeSpec) -> int:
    """Cache slots for a decode shape.  Sliding-window archs ring-buffer at
    the window size once seq exceeds it; SSM archs have O(1) state."""
    if cfg.family == "ssm":
        return 0
    size = shape.seq_len
    if cfg.sliding_window is not None and shape.seq_len > 32768:
        size = cfg.sliding_window  # long-context: ring buffer = window
    if cfg.family == "hybrid":
        size = min(size, cfg.local_window)
    return size


def input_specs(cfg: ArchConfig, shape: ShapeSpec, mode=None) -> dict:
    """Fake tensors (on the CPU, under ``mode``: a ``FakeTensorMode``, a new
    one by default) standing in for the model-input batch of this cell."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    with mode if mode is not None else FakeTensorMode():
        if shape.kind in ("train", "prefill"):
            text = S - cfg.prefix_tokens if cfg.prefix_tokens else S
            batch = {"tokens": torch.empty((B, text), dtype=i32)}
            if cfg.family == "audio":
                batch["frames"] = torch.empty((B, cfg.encoder_seq, cfg.d_model),
                                              dtype=bf16)
            if cfg.prefix_tokens:
                batch["patches"] = torch.empty(
                    (B, cfg.prefix_tokens, cfg.d_model), dtype=bf16)
            return batch
        # decode: one new token against a cache of size seq_len
        return {"token": torch.empty((B,), dtype=i32),
                "pos": torch.empty((B,), dtype=i32)}

