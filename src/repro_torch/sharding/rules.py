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
one head hold equal copies of it; where a slab straddles KV-head groups
(e.g. Hq=6, Hkv=3 at T=2: shard 0 heads 0-1, shard 1 heads 1-2) the
neighbours hold equal copies of the head they share, and the shard's
launch takes its query slab padded with zero heads to whole groups
(:func:`query_window`).  Where T does not divide the query heads (e.g.
Hq=6, Hkv=3 at T=4) the attention block is not split at all
(:func:`heads_split`): every shard holds the whole of ``wq``/``wk``/``wv``/
``wo`` and their biases and a whole copy of the arena, and attends over
all query heads — the reference leaves unsplit what 'model' does not
divide and replicates such an arena, and the sharded step replicates
attention there too.  No head layout is refused.

The sharded step (``launch/steps.py::sharded``) runs the same rules on a
``DeviceMesh`` of the same axis names: :func:`placements` turns a spec into
DTensor placements (``Shard(d)`` on each mesh dim that names tensor dim
``d``, ``Replicate()`` elsewhere), :func:`to_placed` a tree of specs (the
port of ``to_named``), and :func:`distribute_params` puts a module's
parameters on the mesh.  The port holds a stacked group as a list of
per-layer modules, so each leaf's spec is its stacked spec without the
layer axis (:func:`module_specs`); where ZeRO-1 put the data axes on the
layer axis (:func:`opt_specs`), they move to the largest dim of the
per-layer leaf they divide, else the moment is replicated over them
(:func:`layer_spec`).  The reference's GSPMD annotations (:func:`constrain`,
:func:`shard_seq`, :func:`shard_logits`, :func:`shard_experts`) keep its
rules and redistribute a DTensor under ``launch/mesh.py::mesh_context``;
on a plain tensor, or with no mesh set, each is the identity.  Where the
model runs ops DTensor has no sharding rule for (the flash loop, the
decode attention's scores, the MoE dispatch and combine, the SSD mixer,
the lookups, the gold-label pick, the cache writes), :func:`local` runs
the region on each rank's shards with the placements its call site
states (DTensor's ``local_map``).  The helpers after the annotations pin
layouts that DTensor would otherwise choose itself, differently from one
PyTorch version to the next.
"""

from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.launch.mesh import AbstractMesh, current_mesh

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


def abstract(mesh) -> AbstractMesh:
    """``mesh`` as axis name -> size: an abstract mesh as it is, a
    ``DeviceMesh`` by its dim names and sizes."""
    if isinstance(mesh, AbstractMesh):
        return mesh
    if hasattr(mesh, "mesh_dim_names"):
        return AbstractMesh(dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)))
    return AbstractMesh(dict(mesh.shape))


def dp_axes_for(batch: int, mesh) -> tuple[str, ...]:
    """Data-parallel axes that evenly divide this batch (possibly none)."""
    mesh = abstract(mesh)
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
    mesh = abstract(mesh)
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
    mesh = abstract(mesh)
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
    mesh = abstract(mesh)
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
    mesh = abstract(mesh)
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
# the sharded step: specs as DTensor placements on a DeviceMesh


def _axes(part) -> tuple:
    return (part,) if isinstance(part, str) else tuple(part or ())


def placements(spec, mesh, partial=(), reduce_op: str = "sum") -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``):
    ``Shard(d)`` on each mesh dim that tensor dim ``d`` names (a tuple
    such as ``("pod", "data")`` shards ``d`` over each, and must name them
    in mesh order), ``Partial(reduce_op)`` on the mesh dims ``partial``
    names, ``Replicate()`` elsewhere."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        axes = _axes(part)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec part {part!r} names mesh axes {axes} out of the mesh's "
                f"order {names}: a Shard placement cannot express it")
        for i in idx:
            out[i] = Shard(d)
    for a in partial:
        if isinstance(out[names.index(a)], Replicate):
            out[names.index(a)] = Partial(reduce_op)
    return tuple(out)


class Placed(NamedTuple):
    """A mesh and the placements of a tensor on it (jax's
    ``NamedSharding``)."""

    mesh: object
    placements: tuple


def to_placed(tree_specs, mesh):
    """Every spec of a tree of nested dicts as a :class:`Placed` on
    ``mesh`` (the port of ``to_named``)."""
    if isinstance(tree_specs, dict):
        return {k: to_placed(v, mesh) for k, v in tree_specs.items()}
    return Placed(mesh, placements(tree_specs, mesh))


def layer_spec(spec, shape, mesh) -> tuple:
    """The spec of one layer's leaf of ``shape`` (no layer axis) from its
    stacked spec ``spec``: the layer axis dropped; mesh axes that were on it
    (ZeRO-1's data axes) move to the largest unsharded dim of the leaf that
    they divide, else the leaf is replicated over them.  Bytes a rank holds
    stay those of the stacked spec wherever such a dim exists."""
    mesh = abstract(mesh)
    lead, rest = _axes(spec[0]), list(spec[1:])
    if lead:
        n = math.prod(mesh.shape[a] for a in lead)
        for i in sorted(range(len(rest)), key=lambda i: -shape[i]):
            if rest[i] is None and shape[i] % n == 0:
                rest[i] = spec[0]
                break
    return tuple(rest)


def module_specs(specs, module, mesh) -> dict:
    """Parameter name (``module.named_parameters()``) -> the spec of that
    per-layer tensor, from ``specs`` in the stacked layout
    (:func:`param_specs`, or a moment tree of :func:`opt_specs`)."""
    out = {}
    for name, p in module.named_parameters():
        keys = name.split(".")
        spec = specs
        for k in keys:
            if not k.isdigit():
                spec = spec[k]
        if keys[0] in STACKED_CONTAINERS:
            spec = layer_spec(spec, tuple(p.shape), mesh)
        out[name] = tuple(spec)
    return out


def place(t, mesh, pl):
    """``t`` as a DTensor on ``mesh`` with placements ``pl``: a DTensor of
    that mesh redistributed, one of another mesh gathered first, a plain
    tensor cut (every rank holds the same values: no data moves)."""
    pl = tuple(pl)
    if isinstance(t, DTensor):
        if t.device_mesh == mesh:
            return t if tuple(t.placements) == pl else t.redistribute(mesh, pl)
        t = t.full_tensor()
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    return distribute_tensor(t.detach().to(dev), mesh, pl,
                             src_data_rank=None)


def place_module(module, mesh, specs: dict):
    """Replace each parameter of ``module`` in place by an ``nn.Parameter``
    holding a DTensor with the placements of ``specs[name]``
    (:func:`module_specs`); ``requires_grad`` is kept.  Returns
    ``module``."""
    for name, p in list(module.named_parameters()):
        pl = placements(specs[name], mesh)
        if isinstance(p, DTensor) and p.device_mesh == mesh and \
                tuple(p.placements) == pl:
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        new = torch.nn.Parameter(place(p.detach(), mesh, pl),
                                 requires_grad=p.requires_grad)
        if isinstance(owner, torch.nn.ParameterDict):
            owner[leaf] = new
        else:
            setattr(owner, leaf, new)
    return module


def distribute_params(cfg, module, mesh, *, serving: bool = False,
                      moe_shard: str | None = None):
    """Put ``module``'s parameters on ``mesh`` by :func:`param_specs`, in
    place (each an ``nn.Parameter`` holding a DTensor).  Returns
    ``module``."""
    specs = param_specs(cfg, module, mesh, serving=serving,
                        moe_shard=moe_shard)
    return place_module(module, mesh, module_specs(specs, module, mesh))


# ---------------------------------------------------------------------------
# the annotations: the reference's GSPMD constraints as redistributions


def _mesh_of(x):
    """The ambient mesh when ``x`` is a DTensor and a mesh is set, else
    None (every annotation is then the identity)."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return None
    return mesh


def _divides(x, spec, mesh) -> bool:
    sizes = abstract(mesh).shape
    return all(x.shape[d] % math.prod(sizes[a] for a in _axes(part)) == 0
               for d, part in enumerate(spec))


def constrain(x, *spec):
    """Redistribute ``x`` to ``spec`` under the ambient mesh; the identity
    on a plain tensor, with no mesh set, or where the spec does not
    divide."""
    mesh = _mesh_of(x)
    spec = tuple(spec) + (None,) * (x.ndim - len(spec))
    if mesh is None or not _divides(x, spec, mesh):
        return x
    return x.redistribute(mesh, placements(spec, mesh))


def _data_spec(x, mesh, batch_axis):
    spec = [None] * x.ndim
    dp = dp_axes_for(x.shape[batch_axis], mesh)
    if dp:
        spec[batch_axis] = dp
    return spec


def shard_seq(x, batch_axis: int = 0, seq_axis: int = 1):
    """Sequence-parallel constraint on the residual stream [B, S, d]: batch
    over the data axes, sequence over 'model' (Megatron-SP), each where it
    divides.  The identity outside a mesh context."""
    mesh = _mesh_of(x)
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return x
    sizes = abstract(mesh).shape
    daxes = tuple(a for a in ("pod", "data") if a in sizes)
    dn = math.prod(sizes[a] for a in daxes) if daxes else 1
    spec = [None] * x.ndim
    if daxes and x.shape[batch_axis] % dn == 0:
        spec[batch_axis] = daxes
    if x.shape[seq_axis] % sizes["model"] == 0:
        spec[seq_axis] = "model"
    return x.redistribute(mesh, placements(spec, mesh))


def gather_data(tree):
    """FSDP's all-gather before use: each DTensor of ``tree`` (a tensor, a
    module of one layer's parameters, nested dicts of them) whole over the
    data axes, its 'model' sharding kept; a module comes back as nested
    dicts of its (gathered) parameters.  The gradients flow back through
    the gather (a reduce-scatter).  Without it DTensor may instead shard a
    product's contracted dim over 'data' and scatter the activations.
    The identity with no mesh set."""
    mesh = current_mesh()
    if mesh is None:
        return tree
    if isinstance(tree, DTensor):
        pl = tuple(Replicate() if n in ("pod", "data") and
                   isinstance(p, Shard) else p
                   for n, p in zip(mesh.mesh_dim_names, tree.placements))
        return tree if pl == tuple(tree.placements) else \
            tree.redistribute(mesh, pl)
    if hasattr(tree, "tree"):
        tree = tree.tree()
    if isinstance(tree, (dict, torch.nn.ParameterDict)):
        return {k: gather_data(v) for k, v in tree.items()}
    return tree


def gather_model(x):
    """``x`` whole over 'model' (its other placements kept): the input of
    a column-parallel product whose own input dim 'model' shards, which
    DTensor would otherwise contract shard by shard and scatter.  The
    identity on a plain tensor or with no mesh."""
    mesh = _mesh_of(x)
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return x
    i = mesh.mesh_dim_names.index("model")
    if isinstance(x.placements[i], Replicate):
        return x
    pl = list(x.placements)
    pl[i] = Replicate()
    return x.redistribute(mesh, tuple(pl))


def gather_seq(x, seq_axis: int = 1):
    """The sequence of ``x`` whole on every rank, its other placements
    kept: Megatron-SP's all-gather after a norm, ahead of the products that
    read it.  (A [B, S, d] residual sharded on both B and S flattens, in
    ``x @ w``, into a strided shard that DTensor's product rules replicate
    whole; GSPMD gathers the sequence here by itself.)  The identity on a
    plain tensor, with no mesh set, or where the sequence is whole."""
    mesh = _mesh_of(x)
    if mesh is None or not any(isinstance(p, Shard) and p.dim == seq_axis
                               for p in x.placements):
        return x
    return x.redistribute(mesh, tuple(
        Replicate() if isinstance(p, Shard) and p.dim == seq_axis else p
        for p in x.placements))


def shard_vocab(w):
    """The output (vocab) dim of an unembedding ``w`` [d, V] over 'model'
    where it divides and 'model' holds it whole (a tied table): each rank
    then computes only its slice of the logits, which
    :func:`shard_logits` asks for.  The identity outside a mesh."""
    mesh = _mesh_of(w)
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return w
    i = mesh.mesh_dim_names.index("model")
    if not isinstance(w.placements[i], Replicate) or \
            w.shape[-1] % abstract(mesh).shape["model"]:
        return w
    pl = list(w.placements)
    pl[i] = Shard(w.ndim - 1)
    return w.redistribute(mesh, tuple(pl))


def shard_logits(x, batch_axis: int = 0, vocab_axis: int = -1):
    """Vocab-shard loss-chunk logits [B, chunk, V] over 'model' (each rank
    computes only its vocab slice), batch over the data axes; the identity
    where V does not divide or outside a mesh context."""
    mesh = _mesh_of(x)
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return x
    sizes = abstract(mesh).shape
    if x.shape[vocab_axis] % sizes["model"] != 0:
        return x
    daxes = tuple(a for a in ("pod", "data") if a in sizes)
    dn = math.prod(sizes[a] for a in daxes) if daxes else 1
    spec = [None] * x.ndim
    if daxes and x.shape[batch_axis] % dn == 0:
        spec[batch_axis] = daxes
    spec[vocab_axis % x.ndim] = "model"
    return x.redistribute(mesh, placements(spec, mesh))


def shard_experts(x, expert_axis: int = 1, batch_axis: int = 0):
    """MoE dispatch buffers: batch over the data axes, experts REPLICATED
    (over 'model' only with ``REPRO_MOE_SHARD=ep`` where it divides), as
    the reference measured best; the identity outside a mesh context."""
    mesh = _mesh_of(x)
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return x
    sizes = abstract(mesh).shape
    daxes = tuple(a for a in ("pod", "data") if a in sizes)
    dn = math.prod(sizes[a] for a in daxes) if daxes else 1
    spec = [None] * x.ndim
    if daxes and x.shape[batch_axis] % dn == 0:
        spec[batch_axis] = daxes
    if (moe_shard_mode() == "ep"
            and x.shape[expert_axis] % sizes["model"] == 0):
        spec[expert_axis] = "model"
    return x.redistribute(mesh, placements(spec, mesh))


# ---------------------------------------------------------------------------
# regions that run on each rank's shards


def sharded_on_mesh(x) -> bool:
    """Whether ``x`` is a DTensor under :func:`launch.mesh.mesh_context`:
    the model then takes its sharded branches."""
    return _mesh_of(x) is not None


def model_rank() -> int:
    """This rank's coordinate on the ambient mesh's 'model' dim (0 with no
    such dim)."""
    mesh = current_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank("model")


def model_sharded(x, dim: int) -> bool:
    """Whether dim ``dim`` of DTensor ``x`` is sharded over 'model'."""
    mesh = current_mesh()
    if "model" not in mesh.mesh_dim_names:
        return False
    p = x.placements[mesh.mesh_dim_names.index("model")]
    return isinstance(p, Shard) and p.dim == dim % x.ndim


def shard_offset(x, dim: int) -> int:
    """The first index along ``dim`` of this rank's shard of DTensor ``x``
    (0 where ``dim`` is whole): ``dim`` sharded over 'model' only."""
    if not model_sharded(x, dim):
        return 0
    return model_rank() * (x.shape[dim]
                           // abstract(current_mesh()).shape["model"])


def settle(x):
    """DTensor ``x`` with its partial sums reduced (each ``Partial``
    placement made ``Replicate``, the others kept): where a value meets
    others it should hold one layout, not leave DTensor a choice.  The
    identity on a plain tensor or with no mesh."""
    mesh = _mesh_of(x)
    if mesh is None or not any(isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(mesh, tuple(
        Replicate() if isinstance(p, Partial) else p for p in x.placements))


class _GradLayout(torch.autograd.Function):
    """The identity; its backward brings the gradient to the forward
    value's own placements (a partial sum's gradient replicated)."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh = x.device_mesh
        ctx.placements = tuple(Replicate() if isinstance(p, Partial) else p
                               for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) == ctx.placements:
            return grad
        return grad.redistribute(ctx.mesh, ctx.placements)


def grad_layout(x):
    """``x``, whose gradient comes back in ``x``'s own layout: where two
    uses of a tensor send gradients back (a tied table's lookup and
    unembedding) they then add in one layout, and a view's backward sees
    the layout its forward saw.  The identity on a plain tensor or with
    no mesh."""
    if _mesh_of(x) is None:
        return x
    return _GradLayout.apply(x)


def merge_heads(x):
    """x [B, S, H, D] -> [B, S, H·D], whose gradient comes back in the
    merged tensor's own layout (:func:`grad_layout`): a row-parallel
    product's backward shards it over 'model', and DTensor cannot split H
    heads that 'model' does not divide out of such a shard."""
    return grad_layout(x.reshape(*x.shape[:2], -1))


def split_heads(x, n_heads: int):
    """``x`` [..., H·D] ahead of its reshape into H heads: its last dim
    stays sharded over 'model' only where 'model' divides the H heads
    (else DTensor cannot cut the heads out of the shards), else it is
    gathered whole.  The identity on a plain tensor or with no mesh."""
    mesh = _mesh_of(x)
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return x
    i = mesh.mesh_dim_names.index("model")
    p = x.placements[i]
    if not (isinstance(p, Shard) and p.dim == x.ndim - 1) or \
            n_heads % abstract(mesh).shape["model"] == 0:
        return x
    pl = list(x.placements)
    pl[i] = Replicate()
    return x.redistribute(mesh, tuple(pl))


def head_slab(n_q: int, n_kv: int):
    """How attention splits over the ambient mesh's 'model' dim of size T:
    ``("heads", None)`` where T divides both head counts (each rank its
    query and KV heads), ``("slab", (first, count))`` where T divides only
    the query heads and each rank's query slab reads whole KV-head groups
    or lies within one (``first, count``: this rank's KV heads, the
    serving cut's :func:`kv_heads`), else ``("whole", None)``."""
    mesh = current_mesh()
    T = abstract(mesh).shape.get("model", 1)
    if n_q % T == 0 and n_kv % T == 0:
        return "heads", None
    slab, group = n_q // T, n_q // n_kv
    if n_q % T or (slab % group and group % slab):
        return "whole", None
    r = model_rank()
    if slab % group == 0:
        return "slab", (r * slab // group, slab // group)
    return "slab", (r * slab // group, 1)


def batch_spec(x, batch_axis: int = 0, model_axis: int | None = None,
               model_ok: bool = True) -> tuple:
    """A region's spec for ``x``: ``batch_axis`` over the data axes that
    divide it, ``model_axis`` over 'model' where ``model_ok`` and it
    divides, every other dim whole."""
    mesh = current_mesh()
    spec = _data_spec(x, mesh, batch_axis)
    if (model_axis is not None and model_ok and "model" in
            mesh.mesh_dim_names and x.shape[model_axis]
            % abstract(mesh).shape["model"] == 0):
        spec[model_axis] = "model"
    return tuple(spec)


def _as_placements(s, mesh):
    if s is None:
        return None
    if all(isinstance(p, (Shard, Replicate, Partial)) for p in s) and \
            len(s) == mesh.ndim and s:
        return tuple(s)
    return placements(s, mesh)


def local(fn, args, in_specs, out_specs):
    """``fn(*args)`` on each rank's shards (DTensor's ``local_map``): each
    DTensor argument is redistributed to its entry of ``in_specs`` (a spec
    tuple, placements, or None for a non-tensor), and each output becomes a
    DTensor with its entry of ``out_specs`` (placements, where a partial
    sum is meant).  A gradient flows back as the region implies: an input
    whole on a mesh dim that the region splits (some input or output is
    sharded or partial there) gets a partial-sum gradient over it, an
    input that is itself a partial sum a replicated one."""
    from torch.distributed.tensor.experimental import local_map

    mesh = current_mesh()
    # a plain tensor is the same on every rank: a replicated DTensor
    args = tuple(DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
                 if isinstance(a, torch.Tensor) and
                 not isinstance(a, DTensor) else a for a in args)
    inp = tuple(_as_placements(s, mesh) for s in in_specs)
    multi = isinstance(out_specs, list)
    outp = [_as_placements(s, mesh) for s in
            (out_specs if multi else [out_specs])]
    if out_specs is None:  # a region that only writes its inputs in place
        outp = []
    split = {i for pl in inp + tuple(outp) if pl is not None
             for i, p in enumerate(pl) if not isinstance(p, Replicate)}
    grads = tuple(None if pl is None else tuple(
        Replicate() if isinstance(p, Partial) else
        Partial() if isinstance(p, Replicate) and i in split else p
        for i, p in enumerate(pl)) for pl in inp)
    out = (tuple(outp) if multi else list(outp[0]) if outp else None)
    return local_map(fn, out_placements=out,
                     in_placements=inp, in_grad_placements=grads,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


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


def heads_split(cfg, tp: int) -> bool:
    """Whether the attention block splits over ``tp`` shards by query slab
    ``[s·Hq/T, (s+1)·Hq/T)``: T divides Hq.  Where it does not, nothing of
    the block is split (module docstring): every shard attends over all
    query heads on a whole copy of the arena, and the lead's output enters
    the residual."""
    return tp <= 1 or cfg.n_heads % tp == 0


def kv_heads(cfg, tp: int, s: int) -> tuple[int, int]:
    """(first, count) of the KV heads shard ``s`` of ``tp`` holds: those
    its query slab ``[s·slab, (s+1)·slab)`` reads, ``slab = Hq/T``, with
    ``g = Hq/Hkv`` query heads a KV head: ``[⌊s·slab/g⌋, ⌈(s+1)·slab/g⌉)``;
    all of them where the block is not split (:func:`heads_split`)."""
    if tp <= 1 or not heads_split(cfg, tp):
        return 0, cfg.n_kv_heads
    slab = cfg.n_heads // tp
    group = cfg.n_heads // cfg.n_kv_heads
    first = s * slab // group
    return first, -(-(s + 1) * slab // group) - first


@functools.cache
def query_window(cfg, tp: int, s: int) -> tuple[int, int]:
    """(offset, width) of shard ``s``'s query slab in the query heads its
    kernel launch takes.  A launch over h KV heads maps its query head j to
    KV head ``j // (width/h)``: where the slab covers whole KV-head groups
    or lies within one, that is the slab itself, ``(0, slab)``; where it
    straddles groups (Hq=6, Hkv=3 at T=2: heads 0,1,2 read KV 0,0,1) the
    launch takes ``count·g`` heads, the slab's own at ``s·slab − first·g``
    and zero heads around them, and the caller slices its heads back.
    Where the block is not split (:func:`heads_split`), all query heads."""
    if not heads_split(cfg, tp):
        return 0, cfg.n_heads
    first, count = kv_heads(cfg, tp, s)
    slab = cfg.n_heads // max(tp, 1)
    group = cfg.n_heads // cfg.n_kv_heads
    if tp <= 1 or count == 1 or slab % group == 0:
        return 0, slab
    return s * slab - first * group, count * group


def kv_join(cfg, tp: int) -> tuple[tuple[int, int], ...]:
    """(shard, first local head) of each slab that joins the whole arena,
    in head order, no head twice: each shard holding a head no earlier
    shard holds, from the first such head."""
    out, end = [], 0
    for s in range(max(tp, 1)):
        first, count = kv_heads(cfg, tp, s)
        if first + count > end:
            out.append((s, end - first))
            end = first + count
    return tuple(out)


def split_axis(cfg, name: str, shape, tp: int, group: str | None = None,
               moe_shard: str = "tp"):
    """The axis of leaf ``name`` (one layer's, unstacked ``shape``; under
    parameter group ``group``, e.g. ``"moe"``) that
    :func:`param_specs` ``(serving=True)`` puts on 'model' of a ``(1, tp)``
    mesh, or None when it is replicated.  The K/V projections are the
    deviation: None unless :func:`kv_split` (:func:`param_shards` then
    cuts them by :func:`kv_heads`); so is the attention block where it is
    not split (:func:`heads_split`): None."""
    if tp <= 1 or not shape:
        return None
    if name in _KV and not kv_split(cfg, tp):
        return None
    if group == "attn" and not heads_split(cfg, tp):
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
    ``mesh.moe_shard`` lays them out."""
    from repro_torch.models.transformer import DECODER_FAMILIES

    if cfg.family not in DECODER_FAMILIES:
        raise NotImplementedError(
            f"tensor-parallel serving: decoder LMs only, not {cfg.family}")
    tree = params.tree() if hasattr(params, "tree") else params
    return [_shard_tree(cfg, tree, mesh, s) for s in range(mesh.tp)]
