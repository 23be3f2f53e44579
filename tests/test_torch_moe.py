"""The port's MoE layer (``repro_torch.models.moe``) against the JAX package's.

Reduced olmoe-1b-7b (8 experts, top-2) and mixtral-8x7b (8 experts,
top-2): the reference's weights, converted to float32, and numpy-seeded
inputs through both.  Tolerance: 1e-5 abs (``ATOL``), 1e-5 rel — both
sides compute in float32 and differ only in summation order and in the
last bits of exp/silu; routing is compared exactly (a flipped expert
choice would move outputs by orders more than the tolerance).

Also: the grouped path (S = 1024, two groups of 512), capacity drops
(``dropless=False``), the expert-hidden TP=2 split (the partial outputs
of two shards' weight slices sum to the unsharded output), and the weight
bridge's float32 router in a bf16 model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.models import moe as jmoe
from repro.models.transformer import init_decoder_lm as jinit
from repro_torch.configs import get_config as tget, reduced as treduced
from repro_torch.convert import model_from_jax, params_from_jax
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import init_decoder_lm
from repro_torch.sharding.rules import moe_split, param_shards

torch.set_num_threads(1)

ATOL = 1e-5
TOL = dict(atol=ATOL, rtol=1e-5)
ARCHS = ["olmoe-1b-7b", "mixtral-8x7b"]


def _layer(arch, seed=0):
    """(jax cfg, port cfg, jax layer params, port layer params) in float32."""
    jc, tc = jreduced(jget(arch)), treduced(tget(arch))
    jp = jmoe.init_moe(jc, jax.random.PRNGKey(seed), dtype=jnp.float32)
    tp = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()}
    return jc, tc, jp, tp


def _x(B, S, d, seed):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [1, 7, 64, 600])
def test_moe_capacity_matches_reference(arch, S):
    jc, tc = jreduced(jget(arch)), treduced(tget(arch))
    for dropless in (False, True):
        assert tmoe.moe_capacity(tc, S, dropless) == \
            jmoe.moe_capacity(jc, S, dropless)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_shapes_and_dtypes(arch):
    jc, tc, jp, _ = _layer(arch)
    gen = torch.Generator().manual_seed(0)
    mine = tmoe.init_moe(tc, gen, dtype=torch.bfloat16)
    ref = jmoe.init_moe(jc, jax.random.PRNGKey(0))
    assert set(mine) == set(ref)
    for k, v in ref.items():
        assert tuple(mine[k].shape) == tuple(v.shape), k
        want = torch.float32 if k == "w_router" else torch.bfloat16
        assert mine[k].dtype == want, k
        assert str(v.dtype) == ("float32" if k == "w_router" else "bfloat16")


@pytest.mark.parametrize("dropless", [True, False], ids=["dropless", "capped"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("B,S", [(3, 1), (2, 16), (2, 40)])
def test_moe_group_and_apply_match_reference(arch, B, S, dropless):
    jc, tc, jp, tp = _layer(arch, seed=S)
    x = _x(B, S, tc.d_model, seed=B * 100 + S)
    jy, jaux = jmoe._moe_group(jc, jnp.asarray(x), jp, dropless=dropless)
    ty, taux = tmoe._moe_group(tc, torch.from_numpy(x), tp, dropless=dropless)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)
    ay, aaux = tmoe.moe_apply(tc, torch.from_numpy(x), tp, dropless=dropless)
    assert torch.equal(ay, ty) and torch.equal(aaux, taux)
    # the routing itself, exactly
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["w_router"], axis=-1)
    _, jexp = jax.lax.top_k(probs, jc.top_k)
    _, _, texp = tmoe._route(tc, torch.from_numpy(x), tp["w_router"])
    np.testing.assert_array_equal(texp.numpy(), np.asarray(jexp))
    if not dropless and S > 1:
        # capacity really dropped assignments: dropless gives another output
        yd, _ = tmoe._moe_group(tc, torch.from_numpy(x), tp, dropless=True)
        assert not torch.allclose(yd, ty, atol=1e-3)


def test_top_k_ties_go_to_the_lower_expert():
    """Equal router scores: ``jax.lax.top_k`` keeps the lower index, and so
    must the port (a zero router makes every expert tie)."""
    jc, tc, jp, tp = _layer("olmoe-1b-7b")
    jp = dict(jp, w_router=jnp.zeros_like(jp["w_router"]))
    tp = dict(tp, w_router=torch.zeros_like(tp["w_router"]))
    x = _x(2, 5, tc.d_model, seed=3)
    _, _, texp = tmoe._route(tc, torch.from_numpy(x), tp["w_router"])
    assert (texp == torch.arange(tc.top_k)).all()
    jy, _ = jmoe._moe_group(jc, jnp.asarray(x), jp, dropless=False)
    ty, _ = tmoe._moe_group(tc, torch.from_numpy(x), tp, dropless=False)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


@pytest.mark.parametrize("dropless", [True, False], ids=["dropless", "capped"])
def test_grouped_path_matches_reference(dropless):
    """S = 1024 > MOE_SEQ_CHUNK with 512 | S: two groups of 512 tokens (the
    reference's ``lax.scan``), capacity per group."""
    assert tmoe.MOE_SEQ_CHUNK == jmoe.MOE_SEQ_CHUNK == 512
    jc, tc, jp, tp = _layer("olmoe-1b-7b", seed=4)
    x = _x(1, 1024, tc.d_model, seed=4)
    jy, jaux = jmoe.moe_apply(jc, jnp.asarray(x), jp, dropless=dropless)
    ty, taux = tmoe.moe_apply(tc, torch.from_numpy(x), tp, dropless=dropless)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)
    # two groups, not one: the second half alone gives the second half
    half, _ = tmoe._moe_group(tc, torch.from_numpy(x[:, 512:]), tp,
                              dropless=dropless)
    assert torch.equal(ty[:, 512:], half)


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_hidden_tp2_partials_sum_to_the_whole(arch):
    """The reference's default ``REPRO_MOE_SHARD=tp`` layout over two shards:
    each shard's expert-hidden slice gives a partial output; their sum is
    the unsharded output (and the reference's), to 1e-5."""
    jc = jreduced(jget(arch))
    tc = treduced(tget(arch))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jinit(jc, jax.random.PRNGKey(2)))
    model = model_from_jax(tc, jax.tree.map(np.asarray, jp),
                           dtype=torch.float32, device="cpu")
    assert moe_split(tc, 2)
    shards = param_shards(tc, model, make_serving_mesh(2, ["cpu", "cpu"]))
    x = _x(2, 9, tc.d_model, seed=9)
    for layer in range(tc.n_layers):
        full = model.blocks[layer].moe
        parts = [sh["blocks"][layer]["moe"] for sh in shards]
        for p in parts:
            assert p["w_gate"].shape[2] * 2 == full["w_gate"].shape[2]
            assert p["w_down"].shape[1] * 2 == full["w_down"].shape[1]
            assert torch.equal(p["w_router"], full["w_router"])
        whole, _ = tmoe.moe_apply(tc, torch.from_numpy(x), dict(full),
                                  dropless=True)
        summed = sum(tmoe.moe_apply(tc, torch.from_numpy(x), p,
                                    dropless=True)[0] for p in parts)
        np.testing.assert_allclose(summed.numpy(), whole.numpy(), **TOL)
        jlayer = jax.tree.map(lambda a: a[layer], jp["blocks"]["moe"])
        jy, _ = jmoe.moe_apply(jc, jnp.asarray(x), jlayer, dropless=True)
        np.testing.assert_allclose(summed.numpy(), np.asarray(jy), **TOL)


def test_bridge_keeps_the_router_float32_in_a_bf16_model():
    cfg = jreduced(jget("olmoe-1b-7b"))
    jp = jinit(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    params = params_from_jax(cfg, tree, dtype=torch.bfloat16, device="cpu")
    for layer, blk in enumerate(params["blocks"]):
        moe = blk["moe"]
        assert moe["w_router"].dtype == torch.float32
        assert all(moe[k].dtype == torch.bfloat16
                   for k in ("w_gate", "w_up", "w_down"))
        # bit-exact: the reference's router is float32 too
        np.testing.assert_array_equal(
            moe["w_router"].numpy(),
            np.asarray(jp["blocks"]["moe"]["w_router"][layer]))
    model = model_from_jax(cfg, tree, dtype=torch.bfloat16, device="cpu")
    assert model.blocks[0].moe["w_router"].dtype == torch.float32
    assert "mlp" not in model.blocks[0].groups
    # placed() copies keep every leaf's dtype
    assert model.placed("meta").blocks[0].moe["w_router"].dtype == \
        torch.float32


def test_init_decoder_lm_moe_blocks():
    cfg = dataclasses.replace(treduced(tget("olmoe-1b-7b")), n_layers=1)
    params = init_decoder_lm(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    blk = params["blocks"][0]
    assert "moe" in blk and "mlp" not in blk
    assert blk["moe"]["w_router"].dtype == torch.float32
    assert blk["moe"]["w_down"].shape == (cfg.n_experts, cfg.d_ff,
                                          cfg.d_model)
