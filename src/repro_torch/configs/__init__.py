"""Architecture registry: ``get_config(arch_id)``, shapes, reduced configs.

Arch ids use dashes (CLI-facing); module names use underscores.
"""

from __future__ import annotations

import dataclasses
import importlib

from .base import (
    ArchConfig,
    ShapeSpec,
    SHAPES,
    cell_supported,
    decode_cache_size,
)

ARCH_IDS = [
    "whisper-tiny",
    "qwen2-72b",
    "granite-20b",
    "olmo-1b",
    "nemotron-4-15b",
    "olmoe-1b-7b",
    "mixtral-8x7b",
    "paligemma-3b",
    "recurrentgemma-9b",
    "mamba2-780m",
]


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f".{arch_id.replace('-', '_')}", __package__)
    return mod.CONFIG


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests (one fwd/train step)."""
    over = dict(
        n_layers=3 if cfg.family == "hybrid" else 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=512,
        vocab_padded=512,
        attn_chunk=16,
        loss_chunk=32,
        ssd_chunk=16,
        max_seq=128,
        remat="none",
        fsdp=False,
    )
    if cfg.family == "audio":
        over.update(encoder_layers=2, encoder_seq=24)
    if cfg.prefix_tokens:
        over.update(prefix_tokens=8)
    if cfg.moe:
        over.update(n_experts=min(cfg.n_experts, 8), top_k=min(cfg.top_k, 2))
    if cfg.family == "hybrid":
        over.update(rnn_width=64, local_window=16)
    else:
        over.update(rnn_width=64)
    if cfg.family == "ssm":
        over.update(ssm_state=16, head_dim=16)
    if cfg.sliding_window:
        over.update(sliding_window=16)
    return dataclasses.replace(cfg, **over)


__all__ = [
    "ArchConfig",
    "ShapeSpec",
    "SHAPES",
    "ARCH_IDS",
    "get_config",
    "reduced",
    "cell_supported",
    "decode_cache_size",
]
