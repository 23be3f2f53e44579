"""The port's sharding rules, whole, against the JAX package's, spec for spec.

``repro_torch.sharding.rules`` over an abstract mesh (axis name -> size)
must give every leaf the spec ``repro.sharding.rules`` gives it, as a
tuple: ``param_specs`` (serving and training, each ``REPRO_MOE_SHARD``
mode), ``opt_specs`` (ZeRO-1), ``batch_specs`` on each shape's
``input_specs`` and ``cache_specs`` on each family's decode cache and the
paged arena — for all ten full-size configs on the meshes ``{data:16,
model:16}``, ``{pod:2, data:16, model:16}``, ``{data:2, model:4}`` and
``{data:1, model:2}``.  The reference's trees come from ``jax.eval_shape``,
the port's from fake tensors (``launch/abstract.py``), so nothing is
allocated.  Also the reference's own property checks
(``tests/test_sharding.py``) on the port's rules.
"""

import functools
import math
import os

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P
from jax.tree_util import DictKey, tree_flatten_with_path

from repro.configs import (ARCH_IDS, SHAPES as JSHAPES, cell_supported,
                           decode_cache_size, get_config as jget,
                           input_specs as jinput_specs)
from repro.models import build_model as jbuild
from repro.sharding import rules as jrules
from repro_torch.configs import SHAPES, get_config, input_specs
from repro_torch.launch.abstract import (abstract_cache, abstract_params,
                                         fake_mode)
from repro_torch.launch.mesh import (AbstractMesh, make_production_mesh,
                                     make_smoke_mesh)
from repro_torch.serving import kv_storage_init
from repro_torch.sharding import rules

torch.set_num_threads(1)

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4},
          "1x2": {"data": 1, "model": 2}}
MODES = ["tp", "ep", "data", "none"]


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _norm(spec):
    """A spec tuple with one-axis tuples as the axis name: jax's
    ``PartitionSpec`` stores ``("data",)`` as ``"data"``, the same
    sharding."""
    if not isinstance(spec, tuple):
        return spec
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in spec)


def _flat(tree):
    """{path: leaf} of a reference tree (``PartitionSpec``s as tuples)."""
    leaves, _ = tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {tuple(str(p.key) for p in path if isinstance(p, DictKey)):
            (_norm(tuple(x)) if isinstance(x, P) else x)
            for path, x in leaves}


def _flat_port(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_port(v, path + (k,)))
        return out
    return {path: _norm(tree)}


@functools.cache
def _ref_params(arch):
    cfg = jget(arch)
    model = jbuild(cfg)
    return cfg, jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))


@functools.cache
def _port(arch):
    """(cfg, mode, fake parameters) of ``arch``."""
    cfg = get_config(arch)
    mode = fake_mode()
    return cfg, mode, abstract_params(cfg, mode)


def _with_mode(mode, fn):
    old = os.environ.get("REPRO_MOE_SHARD")
    os.environ["REPRO_MOE_SHARD"] = mode
    try:
        return fn()
    finally:
        if old is None:
            os.environ.pop("REPRO_MOE_SHARD")
        else:
            os.environ["REPRO_MOE_SHARD"] = old


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference_leaf_for_leaf(arch, mesh):
    jc, jparams = _ref_params(arch)
    tc, mode, tparams = _port(arch)
    m = AbstractMesh(MESHES[mesh])
    jm = _FakeMesh(MESHES[mesh])
    shapes = rules.shape_tree(tparams)
    assert _flat_port(shapes) == {k: tuple(v.shape)
                                  for k, v in _flat(jparams).items()}
    moe_modes = MODES if tc.moe else ["tp"]
    checked = 0
    for moe in moe_modes:
        for serving in (False, True):
            want = _with_mode(moe, lambda: _flat(jrules.param_specs(
                jc, jparams, jm, serving=serving)))
            got = _with_mode(moe, lambda: _flat_port(rules.param_specs(
                tc, tparams, m, serving=serving)))
            assert got == want, (moe, serving)
            # an explicit mode is the environment's
            assert _flat_port(rules.param_specs(
                tc, tparams, m, serving=serving, moe_shard=moe)) == want
            checked += len(want)
        want = _with_mode(moe, lambda: _flat(jrules.opt_specs(jc, jparams,
                                                              jm)))
        got = _with_mode(moe, lambda: _flat_port(rules.opt_specs(tc, tparams,
                                                                 m)))
        assert got == want, moe
    for name, sh in SHAPES.items():
        want = _flat(jrules.batch_specs(jc, jinput_specs(jc, JSHAPES[name]),
                                        jm))
        batch = input_specs(tc, sh, mode)
        assert _flat_port(rules.batch_specs(tc, batch, m)) == want, name
        if sh.kind != "decode" or not cell_supported(tc, sh)[0]:
            continue
        size = decode_cache_size(jc, JSHAPES[name])
        jcache = jax.eval_shape(lambda: jbuild(jc).init_cache(
            sh.global_batch, size))
        tcache = abstract_cache(tc, sh.global_batch, size, mode)
        assert {k: tuple(v.shape) for k, v in tcache.items()} == \
            {k[0]: tuple(v.shape) for k, v in _flat(jcache).items()}
        assert _flat_port(rules.cache_specs(tc, tcache, m)) == \
            _flat(jrules.cache_specs(jc, jcache, jm)), name
    if tc.family in ("dense", "moe", "vlm"):
        with mode:
            arena = kv_storage_init(tc, 64, 16, device="cpu")
        jarena = {n: jax.ShapeDtypeStruct(tuple(t.shape), jnp.bfloat16)
                  for n, t in arena.items()}
        assert _flat_port(rules.cache_specs(tc, arena, m, paged=True)) == \
            _flat(jrules.cache_specs(jc, jarena, jm, paged=True))
    assert checked > 0


def _divides(leaf_shape, spec, shape):
    for dim, part in zip(leaf_shape, spec):
        axes = (part,) if isinstance(part, str) else tuple(part or ())
        if dim % math.prod(shape[a] for a in axes):
            return False
    return True


def _prop_param_specs_divide():
    mesh = make_production_mesh()
    for arch in ARCH_IDS:
        cfg, _, params = _port(arch)
        shapes = _flat_port(rules.shape_tree(params))
        specs = _flat_port(rules.param_specs(cfg, params, mesh))
        assert specs.keys() == shapes.keys()
        for k, spec in specs.items():
            assert len(spec) == len(shapes[k])
            assert _divides(shapes[k], spec, mesh.shape), (arch, k, spec)


def _prop_opt_specs_add_data_sharding():
    mesh = make_production_mesh()
    cfg, _, params = _port("qwen2-72b")
    ospecs = rules.opt_specs(cfg, params, mesh)
    assert set(ospecs) == {"m", "v", "step"}
    flat = list(_flat_port(ospecs["m"]).values())
    has_data = sum(any(p == ("data",) or p == "data"
                       or (isinstance(p, tuple) and "data" in p)
                       for p in spec) for spec in flat)
    assert has_data > len(flat) // 2


def _prop_batch_specs_divisibility_fallback():
    mesh = make_production_mesh(multi_pod=True)
    cfg = get_config("mamba2-780m")
    s1 = rules.batch_specs(cfg, {"tokens": (256, 128)}, mesh)
    assert s1["tokens"][0] == ("pod", "data")
    s2 = rules.batch_specs(cfg, {"tokens": (1, 128)}, mesh)
    assert s2["tokens"][0] is None  # B=1: replicate, don't crash


def _prop_meshes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).size == 512
    smoke = make_smoke_mesh((2, 4))
    assert smoke.axis_names == ("data", "model") and smoke.size == 8


PROPERTIES = {"param_specs_cover_all_archs": _prop_param_specs_divide,
              "opt_specs_add_data_sharding": _prop_opt_specs_add_data_sharding,
              "batch_specs_divisibility_fallback":
                  _prop_batch_specs_divisibility_fallback,
              "meshes": _prop_meshes}


@pytest.mark.parametrize("prop", list(PROPERTIES))
def test_reference_sharding_properties_hold_on_the_port(prop):
    """``tests/test_sharding.py``'s checks of the reference, on the port's
    rules and meshes."""
    PROPERTIES[prop]()


@pytest.mark.parametrize("arch", ["olmo-1b", "olmoe-1b-7b", "qwen2-72b",
                                  "granite-20b"])
@pytest.mark.parametrize("tp", [2, 4, 16])
def test_the_serving_cut_is_read_off_param_specs(arch, tp):
    """``split_axis`` on each leaf of one layer is the axis
    ``param_specs(serving=True)`` puts on 'model' of a (1, tp) mesh, for
    every leaf but the K/V projections where tp does not divide Hkv (the
    port's one deviation: they are cut by KV head)."""
    cfg, _, params = _port(arch)
    for moe in (MODES if cfg.moe else ["tp"]):
        specs = rules.param_specs(cfg, params, AbstractMesh(
            {"data": 1, "model": tp}), serving=True, moe_shard=moe)
        for g, leaves in specs["blocks"].items():
            for n, spec in leaves.items():
                shape = tuple(getattr(params.blocks[0], g)[n].shape)
                want = next((i - 1 for i, p in enumerate(spec)
                             if p == "model"), None)
                got = rules.split_axis(cfg, n, shape, tp, g, moe)
                if n in ("wk", "wv", "bk", "bv") and not rules.kv_split(cfg,
                                                                        tp):
                    assert got is None
                else:
                    assert got == want, (g, n, moe)
