"""The port's tensor-parallel layout against the JAX package's sharding rules.

``repro_torch.sharding.rules.param_shards`` must cut exactly the axis that
``repro.sharding.rules.param_specs(..., serving=True)`` assigns to the
``'model'`` mesh axis, for every leaf of olmo-1b (full width, on the meta
device: no memory) and of its reduced config, and ``paged_kv_axis`` the
axis that ``cache_specs(..., paged=True)`` shards.  The shards are
contiguous slices that join back to the full tensor.  Also the serving
mesh (``launch/mesh.py``) and the per-shard KV slabs.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.tree_util import DictKey, tree_flatten_with_path

from repro.configs import get_config as jget, reduced as jreduced
from repro.models.transformer import init_decoder_lm as jinit
from repro.sharding import rules as jrules
from repro_torch.configs import get_config as tget, reduced as treduced
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models.transformer import init_decoder_lm
from repro_torch.serving import kv_storage_init
from repro_torch.sharding.rules import (heads_split, kv_split, lm_head_split,
                                        mlp_split, moe_split, param_shards,
                                        paged_kv_axis)

torch.set_num_threads(1)


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _configs(arch, small):
    return (jreduced(jget(arch)), treduced(tget(arch))) if small else \
        (jget(arch), tget(arch))


def _model_axis(spec, stacked):
    parts = tuple(spec)
    for i, p in enumerate(parts):
        axes = (p,) if isinstance(p, str) else tuple(p or ())
        if "model" in axes:
            return i - stacked
    return None


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("small", [False, True], ids=["olmo-1b", "reduced"])
def test_param_shards_split_the_axis_param_specs_marks_model(small, tp):
    jc, tc = _configs("olmo-1b", small)
    shapes = jax.eval_shape(lambda: jinit(jc, jax.random.PRNGKey(0)))
    specs = jrules.param_specs(jc, shapes, _FakeMesh({"data": 1, "model": tp}),
                               serving=True)
    # the port's tree of the same leaves, unstacked, on the meta device
    meta = lambda s: torch.empty(s, device="meta")
    tree = {k: {n: meta(v.shape) for n, v in d.items()}
            for k, d in shapes.items() if k not in ("blocks", "lm_head")}
    tree["blocks"] = [{g: {n: meta(v.shape[1:]) for n, v in d.items()}
                       for g, d in shapes["blocks"].items()}
                      for _ in range(tc.n_layers)]
    if "lm_head" in shapes:
        tree["lm_head"] = meta(shapes["lm_head"].shape)
    shards = param_shards(tc, tree, make_serving_mesh(tp, ["meta"] * tp))
    assert len(shards) == tp
    leaves, _ = tree_flatten_with_path(shapes)
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves) > 0
    checked = split = 0
    for (path, leaf), spec in zip(leaves, spec_leaves):
        names = [str(p.key) for p in path if isinstance(p, DictKey)]
        stacked = 1 if names[0] == "blocks" else 0
        shape = list(leaf.shape[stacked:])
        ax = _model_axis(spec, stacked)
        if ax is not None:
            shape[ax] //= tp
            split += 1
        for s in range(tp):
            layers = shards[s]["blocks"] if stacked else [shards[s]]
            for node in layers:
                for n in names[stacked:]:
                    node = node[n]
                assert tuple(node.shape) == tuple(shape), (names, spec, s)
                checked += 1
    assert checked >= len(leaves) * tp
    assert split == 7  # wq wk wv wo w_gate w_up w_down


def test_param_shards_are_contiguous_slices_that_join_back():
    cfg = treduced(tget("olmo-1b"))
    params = init_decoder_lm(cfg, seed=1, dtype=torch.float32, device="cpu")
    mesh = make_serving_mesh(2, ["cpu", "cpu"])
    shards = param_shards(cfg, params, mesh)
    axes = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "w_gate": 1, "w_up": 1,
            "w_down": 0}
    for layer, full in enumerate(params["blocks"]):
        for grp in ("attn", "mlp"):
            for name, w in full[grp].items():
                parts = [sh["blocks"][layer][grp][name] for sh in shards]
                assert all(p.is_contiguous() for p in parts)
                assert torch.equal(torch.cat(parts, dim=axes[name]), w), name
    # shard s's q heads are the query groups of its KV heads (kv-major)
    hd = cfg.head_dim
    wq = params["blocks"][0]["attn"]["wq"]
    assert torch.equal(shards[1]["blocks"][0]["attn"]["wq"],
                       wq[:, (cfg.n_heads // 2) * hd:])
    assert all(torch.equal(sh["embed"]["tok"], params["embed"]["tok"])
               for sh in shards)


@pytest.mark.parametrize("tp", [1, 2, 3])
@pytest.mark.parametrize("tied,d_ff", [(True, 64), (False, 64), (False, 66)])
def test_split_groups_agree_with_param_shards(tied, d_ff, tp):
    """The fused step asks ``mlp_split``/``lm_head_split`` which groups are
    cut; they must say what ``param_shards`` did to the leaves."""
    cfg = dataclasses.replace(treduced(tget("olmo-1b")), d_ff=d_ff,
                              tie_embeddings=tied)
    params = init_decoder_lm(cfg, seed=1, dtype=torch.float32, device="cpu")
    shards = param_shards(cfg, params, make_serving_mesh(tp, ["cpu"] * tp))
    mlp = shards[0]["blocks"][0]["mlp"]
    assert mlp_split(cfg, tp) == (mlp["w_down"].shape[0] * tp == cfg.d_ff
                                  and tp > 1)
    assert mlp_split(cfg, tp) == (mlp["w_up"].shape[1] < cfg.d_ff)
    head = shards[0].get("lm_head")
    assert lm_head_split(cfg, tp) == (
        head is not None and head.shape[1] < cfg.vocab_padded)


@pytest.mark.parametrize("hkv,tp", [(4, 1), (4, 2), (4, 4), (3, 2), (16, 2),
                                    (16, 3)])
def test_paged_kv_axis_matches_cache_specs(hkv, tp):
    shape = (2, 16, 2, hkv, 16)
    paged = {"k": jax.ShapeDtypeStruct(shape, np.float32)}
    spec = jrules.cache_specs(jget("olmo-1b"), paged,
                              _FakeMesh({"data": 1, "model": tp}),
                              paged=True)["k"]
    want = _model_axis(spec, 0) if tp > 1 else None
    got = paged_kv_axis(shape, tp) if tp > 1 else None
    assert got == want


def test_kv_storage_init_gives_one_contiguous_slab_per_shard():
    cfg = treduced(tget("olmo-1b"))
    full = kv_storage_init(cfg, 8, 4, device="cpu")
    slabs = kv_storage_init(cfg, 8, 4, mesh=make_serving_mesh(2, ["cpu"] * 2))
    assert len(slabs) == 2
    for slab in slabs:
        for n in ("k", "v"):
            assert slab[n].shape == (cfg.n_layers, 8, 4, cfg.n_kv_heads // 2,
                                     cfg.head_dim)
            assert slab[n].is_contiguous() and slab[n].dtype == torch.bfloat16
            assert slab[n].numel() * 2 == full[n].numel()
    # 3 shards do not divide the 4 query heads: a whole copy each
    whole = kv_storage_init(cfg, 8, 4, mesh=make_serving_mesh(3, ["cpu"] * 3))
    assert [s["k"].shape for s in whole] == [full["k"].shape] * 3


def test_make_serving_mesh(monkeypatch):
    mesh = make_serving_mesh(2, ["cpu", "cpu", "cpu"])
    assert mesh.tp == 2 and mesh.devices == (torch.device("cpu"),) * 2
    assert mesh.lead == torch.device("cpu")
    t = torch.zeros(3)
    assert all(r is t for r in mesh.replicate(t))  # no copy on one device
    with pytest.raises(RuntimeError, match="needs 2 devices"):
        make_serving_mesh(2, ["cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs 2 devices"):
        make_serving_mesh(2)  # the default is cuda:0..cuda:1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_serving_mesh(2, ["cuda:0", "cuda:0"])


def _spec_axes(arch, small, tp):
    """{(group, name): the axis the reference's serving spec puts on
    'model'} for one layer's leaves, and the port's shards of the same
    tree (on the meta device)."""
    jc, tc = _configs(arch, small)
    shapes = jax.eval_shape(lambda: jinit(jc, jax.random.PRNGKey(0)))
    specs = jrules.param_specs(jc, shapes, _FakeMesh({"data": 1, "model": tp}),
                               serving=True)
    meta = lambda s: torch.empty(s, device="meta")
    blk = {g: {n: meta(v.shape[1:]) for n, v in d.items()}
           for g, d in shapes["blocks"].items()}
    tree = {"embed": {n: meta(v.shape) for n, v in shapes["embed"].items()},
            "blocks": [blk], "final_norm": {}}
    shard = param_shards(dataclasses.replace(tc, n_layers=1), tree,
                         make_serving_mesh(tp, ["meta"] * tp))[0]
    want = {}
    for g, d in specs["blocks"].items():
        for n, spec in d.items():
            want[(g, n)] = _model_axis(spec, 1)
    return tc, shapes, want, shard["blocks"][0]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("small", [False, True], ids=["olmoe-1b-7b", "reduced"])
def test_moe_param_shards_follow_the_expert_hidden_spec(small, tp):
    """Under ``moe`` the port cuts exactly what the reference's default
    ``REPRO_MOE_SHARD=tp`` spec cuts: each expert's hidden axis (w_gate and
    w_up axis 2, w_down axis 1), the router replicated — and the attention
    as for a dense block."""
    tc, shapes, want, blk = _spec_axes("olmoe-1b-7b", small, tp)
    assert want[("moe", "w_gate")] == want[("moe", "w_up")] == 2
    assert want[("moe", "w_down")] == 1 and want[("moe", "w_router")] is None
    for (g, n), ax in want.items():
        shape = list(shapes["blocks"][g][n].shape[1:])
        if ax is not None:
            shape[ax] //= tp
        assert tuple(blk[g][n].shape) == tuple(shape), (g, n)
    assert moe_split(tc, tp) and "mlp" not in blk


@pytest.mark.parametrize("arch", ["granite-20b", "paligemma-3b"])
@pytest.mark.parametrize("small", [False, True], ids=["full", "reduced"])
def test_mqa_kv_projections_stay_whole(arch, small):
    """One KV head over two shards: the arena is replicated
    (``cache_specs(paged=True)``), and the port keeps ``wk``/``wv`` whole on
    every shard, where the reference's spec cuts their columns inside the
    head (GSPMD keeps the global function; the port computes with the
    slices it holds).  Every other leaf follows the spec."""
    tc, shapes, want, blk = _spec_axes(arch, small, 2)
    assert tc.n_kv_heads == 1 and not kv_split(tc, 2)
    for (g, n), ax in want.items():
        shape = list(shapes["blocks"][g][n].shape[1:])
        if n in ("wk", "wv"):
            assert ax == 1  # the reference's spec cuts inside the one head
        elif ax is not None:
            shape[ax] //= 2
        assert tuple(blk[g][n].shape) == tuple(shape), (g, n)
    assert heads_split(tc, 2)  # the query heads split; the KV head whole


def test_kv_storage_init_replicates_an_arena_the_mesh_does_not_divide():
    """MQA over two shards: each shard gets a whole [L, P, page, Hkv, D]
    copy of its own (the reference's replicated layout); a query slab that
    straddles two KV-head groups (Hkv=3 at T=2) gets the two heads it
    reads; a query head count the mesh does not divide gets a whole copy
    on every shard."""
    cfg = treduced(tget("granite-20b"))
    full = kv_storage_init(cfg, 8, 4, device="cpu")
    copies = kv_storage_init(cfg, 8, 4, mesh=make_serving_mesh(2, ["cpu"] * 2))
    assert len(copies) == 2
    for n in ("k", "v"):
        assert copies[0][n].shape == full[n].shape == (
            cfg.n_layers, 8, 4, 1, cfg.head_dim)
        assert copies[0][n].data_ptr() != copies[1][n].data_ptr()
    straddle = kv_storage_init(
        dataclasses.replace(cfg, n_kv_heads=3, n_heads=6), 8, 4,
        mesh=make_serving_mesh(2, ["cpu"] * 2))
    assert [s["k"].shape[3] for s in straddle] == [2, 2]
    whole = kv_storage_init(dataclasses.replace(cfg, n_heads=6), 8, 4,
                            mesh=make_serving_mesh(4, ["cpu"] * 4))
    assert [s["k"].shape for s in whole] == [full["k"].shape] * 4
