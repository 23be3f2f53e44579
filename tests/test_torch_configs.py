"""The port's configs equal the JAX package's, and the weight bridge is
bit-exact (bf16 leaves cast through float32 lose nothing)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models.transformer import init_decoder_lm as jax_init_decoder_lm
from repro_torch import configs as tcfg
from repro_torch.convert import model_from_jax, params_from_jax
from repro_torch.models.transformer import init_decoder_lm

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", jcfg.ARCH_IDS)
def test_configs_equal_field_by_field(arch):
    assert tcfg.ARCH_IDS == jcfg.ARCH_IDS
    j, t = jcfg.get_config(arch), tcfg.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(tcfg.reduced(t)) == \
        dataclasses.asdict(jcfg.reduced(j))
    for name, shape in jcfg.SHAPES.items():
        assert dataclasses.asdict(tcfg.SHAPES[name]) == dataclasses.asdict(shape)
        assert tcfg.cell_supported(t, tcfg.SHAPES[name]) == \
            jcfg.cell_supported(j, shape)
        assert tcfg.decode_cache_size(t, tcfg.SHAPES[name]) == \
            jcfg.decode_cache_size(j, shape)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-72b", "granite-20b"])
def test_weight_bridge_is_bit_exact(arch):
    cfg = jcfg.reduced(jcfg.get_config(arch))
    jp = jax_init_decoder_lm(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(cfg, tree, dtype=torch.bfloat16, device="cpu")
    n = 0
    for path, leaf in _leaves(tp):
        if path.startswith("/blocks"):
            i = int(path[len("/blocks["):path.index("]")])
            keys = path[path.index("]") + 2:].split("/")
            ref = tree["blocks"]
            for k in keys:
                ref = ref[k]
            ref = ref[i]
        else:
            ref = tree
            for k in path[1:].split("/"):
                ref = ref[k]
        assert leaf.dtype == torch.bfloat16
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      np.asarray(ref, np.float32), err_msg=path)
        n += 1
    outer = {k: v for k, v in jp.items() if k != "blocks"}
    assert n == len(jax.tree.leaves(outer)) + cfg.n_layers * len(
        jax.tree.leaves(jp["blocks"]))
    model = model_from_jax(cfg, tree, dtype=torch.float32, device="cpu")
    assert len(model.blocks) == cfg.n_layers
    assert all(not p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-72b", "nemotron-4-15b"])
def test_seeded_init_matches_reference_shapes_and_scales(arch):
    cfg = jcfg.reduced(jcfg.get_config(arch))
    tree = jax.tree.map(np.asarray, jax_init_decoder_lm(cfg,
                                                        jax.random.PRNGKey(0)))
    ref = params_from_jax(cfg, tree, dtype=torch.float32, device="cpu")
    mine = init_decoder_lm(tcfg.reduced(tcfg.get_config(arch)), seed=0,
                           dtype=torch.float32, device="cpu")
    a, b = dict(_leaves(ref)), dict(_leaves(mine))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape, k
        # same init scale (std within 25% on these small draws; zeros stay 0)
        sa, sb = float(a[k].std()) if a[k].numel() > 1 else 0.0, \
            float(b[k].std()) if b[k].numel() > 1 else 0.0
        assert (sa == 0) == (sb == 0) and abs(sa - sb) <= 0.25 * max(sa, 1e-9), k
