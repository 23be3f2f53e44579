"""Sharding rules: parameters (TP + FSDP/ZeRO), optimizer state, batches,
caches — and the serving cut of a decoder LM that follows from them.

The port of ``repro.sharding.rules``.  Axis convention as there: mesh axes
are ``('data', 'model')`` single-pod and ``('pod', 'data', 'model')``
multi-pod; 'model' carries tensor/expert parallelism, ('pod', 'data') data
parallelism and, for archs with ``cfg.fsdp``, fully-sharded parameter
storage; optimizer moments also shard over the data axes where the
parameters do not (ZeRO-1).  Anything unmatched is replicated.

The rule functions run over an abstract mesh — anything with a ``.shape``
dict of axis name -> size (``launch/mesh.py::AbstractMesh``; no devices) —
and return, per leaf, a spec tuple as long as the leaf's rank whose parts
are None, an axis name or a tuple of axis names: the reference's
``PartitionSpec`` as a tuple.  :func:`param_specs` and :func:`opt_specs`
take the port's parameters (a model module, or its nested dicts, each
stacked group a list of per-layer dicts) and answer in the reference's
stacked layout (:func:`shape_tree`): one spec per leaf name of a stacked
group, the layer axis first, as ``jax.eval_shape`` of the reference's
``init`` gives it.

The serving cut (:func:`param_shards`, the fused step's questions
:func:`split_axis`, :func:`mlp_split`, :func:`moe_axis`,
:func:`lm_head_split`, :func:`paged_kv_axis`) is read off
:func:`param_specs` ``(serving=True)`` and :func:`cache_specs`
``(paged=True)`` on a ``(1, T)`` serving mesh, so one rule set decides it.
Where the reference names a mesh axis per dimension and lets
``device_put`` cut the arrays, :func:`param_shards` cuts them itself into
one contiguous slice per shard: shard s computes with what it holds, and
the partial outputs of row-parallel products (``wo``, ``w_down``) are
summed by the caller (the reference's ``psum``), a row-parallel bias
(``b_down``) added once after the sum.

``REPRO_MOE_SHARD`` picks the expert layout, as in the reference: ``tp``
(default) cuts each expert's hidden axis, ``ep`` the expert axis where T
divides E, ``data`` the expert axis over the data axes (size 1 on a
serving mesh: replicated there), ``none`` — and any other value —
replicates.

The port's one deviation, the KV heads: the reference's spec cuts the
``wk``/``wv``/``bk``/``bv`` columns wherever T divides ``Hkv·Dh`` and,
where T does not divide Hkv, replicates the paged arena (GSPMD computes
the rest).  Here shard s holds the contiguous KV heads its query slab
``[s·Hq/T, (s+1)·Hq/T)`` reads (:func:`kv_heads`) — the projections'
columns of those heads and its own slab of the arena — so each shard's
kernel launch takes a contiguous slab.  Where T divides Hkv that is the
reference's split; where Hkv = 1 a whole copy per shard; where each query
slab falls within one KV head (e.g. Hq=8, Hkv=2, T=4) the shards reading
one head hold equal copies of it.  A slab that straddles a KV-head group
(e.g. Hkv=3 at T=2) is refused (:func:`check_heads`).

The reference's GSPMD annotations (``constrain``, ``shard_seq``,
``shard_logits``, ``shard_experts``, ``to_named``) have no counterpart in
an eager single-controller port (the package docstring).
"""

from __future__ import annotations

import functools
import math
import os

from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models.transformer import DECODER_FAMILIES

STACKED_CONTAINERS = ("blocks", "groups", "tail", "enc_blocks")

# weights whose LAST dim is the "output" (column-parallel; shard out over model)
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "w_in", "in_proj", "w_a", "w_x",
        "bq", "bk", "bv", "b_up"}
# weights whose FIRST (non-stacked) dim is the contracted "input" (row-parallel)
_ROW = {"wo", "w_down", "w_out", "out_proj"}
_REPLICATED = {"scale", "bias", "lam", "A_log", "D", "dt_bias", "conv_b",
               "b_down", "w_router", "pos", "enc_pos"}
_KV = {"wk", "wv", "bk", "bv"}
_EXPERT = ("w_gate", "w_up", "w_down")
#: biases of a row-parallel product: replicated, added once after the sum
ROW_BIASES = frozenset({"b_down"})


def moe_shard_mode() -> str:
    """The expert layout ``REPRO_MOE_SHARD`` names (default ``tp``)."""
    return os.environ.get("REPRO_MOE_SHARD", "tp")


def dp_axes_for(batch: int, mesh) -> tuple[str, ...]:
    """Data-parallel axes that evenly divide this batch (possibly none)."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    n = math.prod(mesh.shape[a] for a in axes) if axes else 1
    if axes and batch % n == 0:
        return axes
    if "data" in mesh.shape and batch % mesh.shape["data"] == 0:
        return ("data",)
    return ()


def _fsdp_axes(cfg, mesh):
    if not cfg.fsdp:
        return ()
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _div(n, mesh, axes):
    if not axes:
        return False
    return n % math.prod(mesh.shape[a] for a in axes) == 0


def leaf_spec(cfg, names, dims, mesh, *, serving: bool = False,
              moe_shard: str | None = None) -> list:
    """The reference's rule for one parameter leaf: ``names`` its dict path
    (e.g. ``["blocks", "attn", "wq"]``), ``dims`` its shape without the
    stacked layer axis.  Returns one part per dim."""
    tp = mesh.shape["model"]
    fsdp = () if serving else _fsdp_axes(cfg, mesh)
    name = names[-1]
    dims = list(dims)
    spec = [None] * len(dims)
    daxes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    if "moe" in names and name in _EXPERT:  # [E, d, ff] / [E, ff, d]
        mode = moe_shard if moe_shard is not None else moe_shard_mode()
        if mode == "ep" and dims[0] % tp == 0:
            spec[0] = "model"  # expert parallelism
        elif mode == "data" and daxes and _div(dims[0], mesh, daxes):
            spec[0] = daxes  # ZeRO-style storage, gathered per layer
        elif mode == "tp":
            hid = 2 if name != "w_down" else 1
            if dims[hid] % tp == 0:
                spec[hid] = "model"
        # mode == "none": replicated
    elif name == "tok":
        # [V, d]: never the indexed V; d over the data axes for untied
        # tables, replicated for tied ones (the unembed stays local)
        if not cfg.tie_embeddings and daxes and _div(dims[1], mesh, daxes):
            spec[1] = daxes
    elif name == "lm_head":  # [d, V]
        if dims[1] % tp == 0:
            spec[1] = "model"
        if _div(dims[0], mesh, fsdp):
            spec[0] = fsdp
    elif name in _REPLICATED or len(dims) == 0:
        pass
    elif name == "conv_w":  # [4, ch] depthwise
        if dims[1] % tp == 0:
            spec[1] = "model"
    elif name in _COL:
        if dims[-1] % tp == 0:
            spec[-1] = "model"
        if len(dims) >= 2 and _div(dims[-2], mesh, fsdp):
            spec[-2] = fsdp
    elif name in _ROW:
        if dims[0] % tp == 0:
            spec[0] = "model"
        if len(dims) >= 2 and _div(dims[-1], mesh, fsdp):
            spec[-1] = fsdp
    return spec  # unmatched: replicated


# ---------------------------------------------------------------------------
# the rule functions over trees


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def _stack(layers: list) -> dict:
    """Per-layer dicts of one stacked group -> one dict of stacked shapes."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lay[k] for lay in layers]) for k in first}
    return (len(layers),) + _shape(first)


def shape_tree(params) -> dict:
    """The port's parameters (a module with ``tree()``, or its nested dicts)
    as the reference's stacked layout: nested dicts of shape tuples, each
    stacked group (a list of per-layer dicts) one dict whose leaves carry
    the layer count in front.  Shape tuples and dicts of them pass as
    they are."""
    tree = params.tree() if hasattr(params, "tree") else params

    def walk(t):
        if isinstance(t, dict):
            return {k: (_stack(v) if isinstance(v, list) else walk(v))
                    for k, v in t.items()}
        return _shape(t)
    return walk(tree)


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs(cfg, params, mesh, *, serving: bool = False,
                moe_shard: str | None = None) -> dict:
    """Spec per leaf of :func:`shape_tree` ``(params)``.  ``serving=True``
    disables FSDP (decode wants TP-resident weights, training FSDP);
    ``moe_shard`` None reads ``REPRO_MOE_SHARD``."""
    def assign(path, shape):
        stacked = 1 if path[0] in STACKED_CONTAINERS else 0
        return tuple([None] * stacked + leaf_spec(
            cfg, path, shape[stacked:], mesh, serving=serving,
            moe_shard=moe_shard))
    return _map(assign, shape_tree(params))


def _has_data(part, daxes) -> bool:
    return (part == daxes or part == "data"
            or (isinstance(part, tuple) and bool(set(part) & set(daxes))))


def opt_specs(cfg, params, mesh, *, moe_shard: str | None = None) -> dict:
    """ZeRO-1: the AdamW moments take the parameter spec, then shard the
    largest still-unsharded dim (the stacked layer axis included) over the
    data axes; the step counter is replicated."""
    shapes = shape_tree(params)
    pspecs = param_specs(cfg, shapes, mesh, moe_shard=moe_shard)
    daxes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    dn = math.prod(mesh.shape[a] for a in daxes) if daxes else 1

    def extend(path, shape):
        spec = pspecs
        for k in path:
            spec = spec[k]
        parts = list(spec)
        if daxes and not any(_has_data(p, daxes) for p in parts):
            for i in sorted(range(len(parts)), key=lambda i: -shape[i]):
                if parts[i] is None and shape[i] % dn == 0:
                    parts[i] = daxes
                    break
        return tuple(parts)

    moments = _map(extend, shapes)
    return {"m": moments, "v": moments, "step": ()}


def batch_specs(cfg, batch, mesh) -> dict:
    """Each input's batch axis over the data axes that divide it."""
    def assign(path, shape):
        dp = dp_axes_for(shape[0], mesh)
        return tuple([dp if dp else None] + [None] * (len(shape) - 1))
    return _map(assign, shape_tree(batch))


def cache_specs(cfg, cache, mesh, *, paged: bool = False) -> dict:
    """``paged=False`` (dense decode cache): k/v ``[L,B,S,Hkv,Dh]`` shard
    the SEQUENCE axis over 'model', the batch over the data axes, recurrent
    states their channel axis.  ``paged=True`` (the serving arena
    ``[L,P,page,Hkv,Dh]``): the KV-head axis over 'model' where it divides,
    else replicated — never pages or in-page slots, so every shard's pool
    decisions are the same."""
    tp = mesh.shape["model"]

    def assign(path, shape):
        name = path[-1]
        spec = [None] * len(shape)
        if paged:
            if name in ("k", "v") and len(shape) == 5 and shape[3] % tp == 0:
                spec[3] = "model"
            return tuple(spec)
        if name == "len":
            dp = dp_axes_for(shape[0], mesh)
            return (dp if dp else None,)
        # all other caches are [L/G, B, ...]
        dp = dp_axes_for(shape[1], mesh)
        spec[1] = dp if dp else None
        if name in ("k", "v", "ssm", "h1", "h2", "th"):
            # k/v [L,B,S,Hkv,Dh]: sequence-parallel; ssm [L,B,H,P,N]: heads;
            # h* [G,B,dr]: channels
            if shape[2] % tp == 0:
                spec[2] = "model"
        elif name in ("conv1", "conv2", "tconv", "conv"):  # [G,B,3,ch]
            if shape[3] % tp == 0:
                spec[3] = "model"
        # ck/cv (cross-KV): encoder_seq rarely divides; replicated
        return tuple(spec)
    return _map(assign, shape_tree(cache))


def shard_bytes(shape, itemsize: int, spec, mesh) -> int:
    """Bytes one device holds of a leaf of ``shape`` under ``spec`` (every
    rule shards only dims its axes divide, so this is exact)."""
    n = math.prod(shape) * itemsize
    for part in spec:
        for a in ((part,) if isinstance(part, str) else tuple(part or ())):
            n //= mesh.shape[a]
    return n


# ---------------------------------------------------------------------------
# the serving cut: a (1, T) mesh of the rules above


def _serving_mesh(tp: int) -> AbstractMesh:
    return AbstractMesh({"data": 1, "model": tp})


def _model_axis(spec) -> int | None:
    for i, part in enumerate(spec):
        if part == "model" or (isinstance(part, tuple) and "model" in part):
            return i
    return None


@functools.cache
def kv_split(cfg, tp: int) -> bool:
    """Whether the KV heads (arena and K/V projections) split evenly over
    ``tp`` shards, as the reference's paged arena does; False means each
    shard holds the KV heads its query slab reads (:func:`kv_heads`)."""
    return tp > 1 and paged_kv_axis(
        (1, 1, 1, cfg.n_kv_heads, cfg.head_dim), tp) is not None


def kv_heads(cfg, tp: int, s: int) -> tuple[int, int]:
    """(first, count) of the KV heads shard ``s`` of ``tp`` holds: those
    its query slab ``[s·Hq/T, (s+1)·Hq/T)`` reads (:func:`check_heads`
    must pass)."""
    if tp <= 1:
        return 0, cfg.n_kv_heads
    slab = cfg.n_heads // tp
    group = cfg.n_heads // cfg.n_kv_heads
    if slab % group == 0:
        return s * slab // group, slab // group
    return s * slab // group, 1


def kv_shards(cfg, tp: int) -> tuple[int, ...]:
    """The shards whose KV slabs, joined in order, are the whole arena: the
    first shard holding each head range."""
    seen, out = set(), []
    for s in range(tp):
        first = kv_heads(cfg, tp, s)[0]
        if first not in seen:
            seen.add(first)
            out.append(s)
    return tuple(out)


def split_axis(cfg, name: str, shape, tp: int, group: str | None = None,
               moe_shard: str = "tp"):
    """The axis of leaf ``name`` (one layer's, unstacked ``shape``; under
    parameter group ``group``, e.g. ``"moe"``) that
    :func:`param_specs` ``(serving=True)`` puts on 'model' of a ``(1, tp)``
    mesh, or None when it is replicated.  The K/V projections are the
    deviation: None unless :func:`kv_split` (:func:`param_shards` then
    cuts them by :func:`kv_heads`)."""
    if tp <= 1 or not shape:
        return None
    if name in _KV and not kv_split(cfg, tp):
        return None
    names = [name] if group is None else ["blocks", group, name]
    return _model_axis(leaf_spec(cfg, names, shape, _serving_mesh(tp),
                                 serving=True, moe_shard=moe_shard))


@functools.cache
def mlp_split(cfg, tp: int) -> bool:
    """Whether :func:`split_axis` cuts the MLP over ``tp`` shards (the
    ``w_gate``/``w_up`` columns and ``w_down`` rows split together)."""
    return split_axis(cfg, "w_down", (cfg.d_ff, cfg.d_model), tp,
                      "mlp") is not None


@functools.cache
def moe_axis(cfg, tp: int, moe_shard: str = "tp") -> int | None:
    """The axis of ``w_down`` [E, ff, d] that the expert layout cuts over
    ``tp`` shards: 0 (``ep``: whole experts a shard), 1 (``tp``: each
    expert's hidden slice) or None (replicated)."""
    return split_axis(cfg, "w_down", (cfg.n_experts, cfg.d_ff, cfg.d_model),
                      tp, "moe", moe_shard)


def moe_split(cfg, tp: int, moe_shard: str = "tp") -> bool:
    """Whether the experts are cut over ``tp`` shards at all."""
    return moe_axis(cfg, tp, moe_shard) is not None


@functools.cache
def lm_head_split(cfg, tp: int) -> bool:
    """Whether the shards hold ``lm_head`` column slices (the logits are then
    joined on V); False for tied embeddings, which use the replicated
    token table."""
    return (not cfg.tie_embeddings and split_axis(
        cfg, "lm_head", (cfg.d_model, cfg.vocab_padded), tp) is not None)


def paged_kv_axis(shape, tp: int) -> int | None:
    """The axis of the paged arena ``[L, P, page, Hkv, D]`` that
    :func:`cache_specs` ``(paged=True)`` shards over ``tp``: the KV-head
    axis (3) when ``tp`` divides it, else None."""
    return _model_axis(cache_specs(None, {"k": tuple(shape)},
                                   _serving_mesh(tp), paged=True)["k"])


def check_heads(cfg, tp: int) -> None:
    """Raise ``ValueError`` unless ``tp`` shards can each attend on their
    query slab ``[s·Hq/T, (s+1)·Hq/T)`` over a contiguous slab of KV heads:
    T must divide Hq, and the slab must cover whole KV-head groups (T
    divides Hkv) or fall within one group (Hq/Hkv a multiple of Hq/T)."""
    if tp <= 1:
        return
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if hq % tp:
        raise ValueError(f"n_heads={hq} is not divisible by tensor_parallel="
                         f"{tp}: the query heads cannot split")
    slab, group = hq // tp, hq // hkv
    if slab % group and group % slab:
        raise ValueError(
            f"n_kv_heads={hkv} is not divisible by tensor_parallel={tp}, and "
            f"a shard's query slab of {slab} heads straddles the KV-head "
            f"groups of {group} query heads: its KV heads would be a strided "
            f"slice, and a shard's kernel launch takes a contiguous slab")


def _shard_leaf(cfg, path, t, mesh, s):
    group = path[-2] if len(path) > 1 else None
    name = path[-1]
    ax = split_axis(cfg, name, tuple(t.shape), mesh.tp, group,
                    mesh.moe_shard)
    if ax is not None:
        n = t.shape[ax] // mesh.tp
        t = t.narrow(ax, s * n, n)
    elif name in _KV and mesh.tp > 1 and not kv_split(cfg, mesh.tp):
        first, count = kv_heads(cfg, mesh.tp, s)
        t = t.narrow(t.dim() - 1, first * cfg.head_dim, count * cfg.head_dim)
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
    structure, shard s's slices on ``mesh.devices[s]``; the experts as
    ``mesh.moe_shard`` lays them out (the engine refuses head counts that
    :func:`check_heads` refuses)."""
    if cfg.family not in DECODER_FAMILIES:
        raise NotImplementedError(
            f"tensor-parallel serving: decoder LMs only, not {cfg.family}")
    tree = params.tree() if hasattr(params, "tree") else params
    return [_shard_tree(cfg, tree, mesh, s) for s in range(mesh.tp)]
