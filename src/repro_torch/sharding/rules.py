"""Tensor-parallel layout of a dense decoder LM and its paged KV arena.

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
- ``lm_head`` [d, V] splits V (the logits are joined);
- the token table, the norms and ``b_down`` are replicated;
- a dimension that ``tp`` does not divide is replicated, never cut unevenly.

The splits are contiguous, so shard s gets q heads ``[s·Hq/T, (s+1)·Hq/T)``
and KV heads ``[s·Hkv/T, (s+1)·Hkv/T)``: GQA is kv-head-major, so those are
exactly the query groups of its KV heads.
"""

from __future__ import annotations

_COL = {"wq", "wk", "wv", "w_gate", "w_up", "bq", "bk", "bv", "b_up"}
_ROW = {"wo", "w_down"}
#: biases of a row-parallel product: replicated, added once after the sum
ROW_BIASES = frozenset({"b_down"})


def split_axis(name: str, shape, tp: int) -> int | None:
    """The axis of leaf ``name`` (one layer's, unstacked ``shape``) that
    splits over ``tp`` shards, or None when it is replicated."""
    if tp <= 1 or not shape:
        return None
    if name == "lm_head":  # [d, V]
        return 1 if shape[1] % tp == 0 else None
    if name in _COL:
        return len(shape) - 1 if shape[-1] % tp == 0 else None
    if name in _ROW:
        return 0 if shape[0] % tp == 0 else None
    return None  # tok, norms, b_down, unmatched: replicated


def mlp_split(cfg, tp: int) -> bool:
    """Whether :func:`split_axis` cuts the MLP over ``tp`` shards (the
    ``w_gate``/``w_up`` columns and ``w_down`` rows split together)."""
    return split_axis("w_down", (cfg.d_ff, cfg.d_model), tp) is not None


def lm_head_split(cfg, tp: int) -> bool:
    """Whether the shards hold ``lm_head`` column slices (the logits are then
    joined on V); False for tied embeddings, which use the replicated
    token table."""
    return (not cfg.tie_embeddings and split_axis(
        "lm_head", (cfg.d_model, cfg.vocab_padded), tp) is not None)


def _shard_leaf(name, t, mesh, s):
    ax = split_axis(name, tuple(t.shape), mesh.tp)
    if ax is not None:
        n = t.shape[ax] // mesh.tp
        t = t.narrow(ax, s * n, n)
    return t.detach().to(mesh.devices[s]).contiguous()


def _shard_tree(tree, mesh, s, name=None):
    if isinstance(tree, dict):
        return {k: _shard_tree(v, mesh, s, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shard_tree(v, mesh, s, name) for v in tree]
    return _shard_leaf(name, tree, mesh, s)


def param_shards(cfg, params, mesh) -> list[dict]:
    """Split ``params`` (a ``DecoderLM`` or its nested dicts, blocks a list
    of per-layer dicts) into ``mesh.tp`` nested dicts of the same
    structure, shard s's slices on ``mesh.devices[s]``."""
    if cfg.family != "dense" or cfg.moe:
        raise NotImplementedError("tensor-parallel serving: dense decoder "
                                  "LMs only")
    tree = params.tree() if hasattr(params, "tree") else params
    return [_shard_tree(tree, mesh, s) for s in range(mesh.tp)]


def paged_kv_axis(shape, tp: int) -> int | None:
    """The axis of the paged arena ``[L, P, page, Hkv, D]`` that splits over
    ``tp`` shards: the KV-head axis (3) when ``tp`` divides it.  Pages and
    in-page slots never split (a block-table read must find a whole page on
    every shard), so every shard's pool decisions are the same."""
    return 3 if len(shape) == 5 and shape[3] % tp == 0 else None
