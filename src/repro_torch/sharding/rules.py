"""Tensor-parallel layout of a decoder LM (dense, MoE, VLM text decoder)
and its paged KV arena.

The serving subset of ``repro.sharding.rules`` (``param_specs(serving=True)``
and ``cache_specs(paged=True)`` on the ``'model'`` axis), written for the
port's single-controller mesh (``launch/mesh.py``): where the reference
names a mesh axis per dimension and lets ``device_put`` cut the arrays,
:func:`param_shards` cuts them itself into one contiguous slice per shard.

- column-parallel (``_COL``: q/k/v and gate/up projections and their
  biases) split their LAST axis: shard s computes its own output columns;
- row-parallel (``_ROW``: ``wo``, ``w_down``) split their FIRST axis: shard
  s contracts its own input rows and the shards' partial outputs are summed
  (the reference's ``psum``), so a row-parallel bias (``b_down``) is added
  once, after the sum;
- MoE experts (leaves under ``moe``) split their expert-hidden axis, the
  reference's default ``REPRO_MOE_SHARD=tp``: ``w_gate``/``w_up`` [E, d,
  ff] axis 2 and ``w_down`` [E, ff, d] axis 1, so each shard runs every
  expert on its ff slice and the partial outputs are summed; the router
  ``w_router`` is replicated (every shard routes alike);
- ``lm_head`` [d, V] splits V (the logits are joined);
- the token table, the norms and ``b_down`` are replicated;
- a dimension that ``tp`` does not divide is replicated, never cut unevenly.

The splits are contiguous, so shard s gets q heads ``[s·Hq/T, (s+1)·Hq/T)``
and KV heads ``[s·Hkv/T, (s+1)·Hkv/T)``: GQA is kv-head-major, so those are
exactly the query groups of its KV heads.

When T does not divide Hkv the KV arena is replicated (the reference's
``cache_specs(paged=True)`` falls back to replication), and so are the K/V
projections ``wk``/``wv``/``bk``/``bv``: the reference's spec still cuts
their columns where T divides ``Hkv·Dh`` (GSPMD keeps the global function
all the same), but the port computes with the slices it holds, so each
shard keeps every KV head and appends them to its own copy of the arena.
Shard s's query slab must then fall within one KV head
(:func:`check_heads`): multi-query attention (Hkv = 1) always does.
"""

from __future__ import annotations

from repro_torch.models.transformer import DECODER_FAMILIES

_COL = {"wq", "wk", "wv", "w_gate", "w_up", "bq", "bk", "bv", "b_up"}
_ROW = {"wo", "w_down"}
_KV = {"wk", "wv", "bk", "bv"}
#: the expert-hidden axis of each MoE expert weight (``REPRO_MOE_SHARD=tp``)
_EXPERT_HIDDEN = {"w_gate": 2, "w_up": 2, "w_down": 1}
#: biases of a row-parallel product: replicated, added once after the sum
ROW_BIASES = frozenset({"b_down"})


def kv_split(cfg, tp: int) -> bool:
    """Whether the KV heads (arena and K/V projections) split over ``tp``
    shards; False means every shard holds all of them."""
    return tp > 1 and cfg.n_kv_heads % tp == 0


def split_axis(cfg, name: str, shape, tp: int, group: str | None = None):
    """The axis of leaf ``name`` (one layer's, unstacked ``shape``; under
    parameter group ``group``, e.g. ``"moe"``) that splits over ``tp``
    shards, or None when it is replicated."""
    if tp <= 1 or not shape:
        return None
    if group == "moe" and name in _EXPERT_HIDDEN:
        ax = _EXPERT_HIDDEN[name]
        return ax if shape[ax] % tp == 0 else None
    if name == "lm_head":  # [d, V]
        return 1 if shape[1] % tp == 0 else None
    if name in _KV and not kv_split(cfg, tp):
        return None
    if name in _COL:
        return len(shape) - 1 if shape[-1] % tp == 0 else None
    if name in _ROW:
        return 0 if shape[0] % tp == 0 else None
    return None  # tok, norms, b_down, w_router, unmatched: replicated


def mlp_split(cfg, tp: int) -> bool:
    """Whether :func:`split_axis` cuts the MLP over ``tp`` shards (the
    ``w_gate``/``w_up`` columns and ``w_down`` rows split together)."""
    return split_axis(cfg, "w_down", (cfg.d_ff, cfg.d_model), tp) is not None


def moe_split(cfg, tp: int) -> bool:
    """Whether :func:`split_axis` cuts the experts' hidden axis over ``tp``
    shards (``w_gate``/``w_up`` axis 2 and ``w_down`` axis 1 together)."""
    return split_axis(cfg, "w_down", (cfg.n_experts, cfg.d_ff, cfg.d_model),
                      tp, group="moe") is not None


def lm_head_split(cfg, tp: int) -> bool:
    """Whether the shards hold ``lm_head`` column slices (the logits are then
    joined on V); False for tied embeddings, which use the replicated
    token table."""
    return (not cfg.tie_embeddings and split_axis(
        cfg, "lm_head", (cfg.d_model, cfg.vocab_padded), tp) is not None)


def check_heads(cfg, tp: int) -> None:
    """Raise ``ValueError`` unless ``tp`` shards can each attend on their
    query slab ``[s·Hq/T, (s+1)·Hq/T)``: T must divide Hq, and where T does
    not divide Hkv (the replicated arena) each slab must fall within one KV
    head of an arena that holds one (multi-query attention), since a shard's
    kernel launch takes a contiguous slab of KV heads."""
    if tp <= 1:
        return
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if hq % tp:
        raise ValueError(f"n_heads={hq} is not divisible by tensor_parallel="
                         f"{tp}: the query heads cannot split")
    if not kv_split(cfg, tp) and hkv != 1:
        raise ValueError(
            f"n_kv_heads={hkv} is not divisible by tensor_parallel={tp}: the "
            f"KV arena is replicated, and a shard's query slab of {hq // tp} "
            f"heads would read a strided slice of its {hkv} KV heads; the "
            f"replicated arena is served for one KV head (multi-query)")


def _shard_leaf(cfg, path, t, mesh, s):
    group = path[-2] if len(path) > 1 else None
    ax = split_axis(cfg, path[-1], tuple(t.shape), mesh.tp, group)
    if ax is not None:
        n = t.shape[ax] // mesh.tp
        t = t.narrow(ax, s * n, n)
    return t.detach().to(mesh.devices[s]).contiguous()


def _shard_tree(cfg, tree, mesh, s, path=()):
    if isinstance(tree, dict):
        return {k: _shard_tree(cfg, v, mesh, s, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shard_tree(cfg, v, mesh, s, path) for v in tree]
    return _shard_leaf(cfg, path, tree, mesh, s)


def param_shards(cfg, params, mesh) -> list[dict]:
    """Split ``params`` (a ``DecoderLM`` or its nested dicts, blocks a list
    of per-layer dicts) into ``mesh.tp`` nested dicts of the same
    structure, shard s's slices on ``mesh.devices[s]``."""
    if cfg.family not in DECODER_FAMILIES:
        raise NotImplementedError(
            f"tensor-parallel serving: decoder LMs only, not {cfg.family}")
    tree = params.tree() if hasattr(params, "tree") else params
    return [_shard_tree(cfg, tree, mesh, s) for s in range(mesh.tp)]


def paged_kv_axis(shape, tp: int) -> int | None:
    """The axis of the paged arena ``[L, P, page, Hkv, D]`` that splits over
    ``tp`` shards: the KV-head axis (3) when ``tp`` divides it, else None:
    every shard holds the whole arena.  Pages and in-page slots never split
    (a block-table read must find a whole page on every shard), so every
    shard's pool decisions are the same."""
    return 3 if len(shape) == 5 and shape[3] % tp == 0 else None
