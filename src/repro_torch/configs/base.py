"""Architecture config schema + input-shape taxonomy.

Every assigned architecture is an ``ArchConfig``; the four assigned input
shapes are ``SHAPES``.  ``input_specs`` builds fake-tensor stand-ins for
every model input of a given (arch, shape) cell — shapes and dtypes, zero
allocation (torch's ``FakeTensorMode``, the counterpart of jax's
``ShapeDtypeStruct``) — which is what the dry run counts.  The rest is a
copy of ``repro.configs.base``.
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

