"""The other tensor-parallel layouts of the port against the JAX package, on
the CPU: the reference's ``REPRO_MOE_SHARD`` modes ``ep``, ``data`` and
``none``, and a KV-head count the TP degree does not divide (Hq=8, Hkv=2
at T=4: each shard holds the one KV head its query slab reads).

- ``moe_apply``'s expert-parallel partials (each of T=2 shards routes over
  all experts and runs only its own) summed against the whole layer, to
  1e-5 in float32, dropless and capacity-bounded;
- the serving engine at ``tensor_parallel=2`` under each mode, reduced
  olmoe-1b-7b and mixtral-8x7b, against ONE subprocess of the JAX engine
  (four forced host devices) under the same ``REPRO_MOE_SHARD``, and
  reduced olmo-1b with ``n_heads=8, n_kv_heads=2`` at ``tensor_parallel=4``
  against the JAX engine at ``tensor_parallel=4`` in the same subprocess:
  tokens, every integer counter, block tables and clock equal (the zoo
  tests' workloads and margin guard, ``tests/test_torch_zoo.py``);
- the layouts themselves: expert bytes per shard, ``ep`` where T does not
  divide E replicated as in the reference, and the shards that hold one KV
  head holding bitwise equal slabs.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.models.transformer import decoder_forward, init_decoder_lm, unembed
from repro.sharding import rules as jrules
from repro_torch.configs import get_config as tget, reduced as treduced
from repro_torch.convert import model_from_jax
from repro_torch.kernels.ops import paged_attention
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import moe as tmoe
from repro_torch.serving import PagedServingEngine
from repro_torch.sharding.rules import (heads_split, kv_heads, kv_join,
                                        moe_axis, param_shards, query_window)
from split_cases import append_case
from test_torch_zoo import MARGIN_TOL, WORKLOADS, ZOO, _hold, _record, _waves

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
MOE_ARCHS = ["olmoe-1b-7b", "mixtral-8x7b"]
MODES = ["ep", "data", "none"]
#: one workload per config keeps the subprocess short; both run under
#: every mode
MOE_WORKLOAD = {"olmoe-1b-7b": "chunked_tight_pool",
                "mixtral-8x7b": "prefix_speculative"}
GQA_HEADS = dict(n_heads=8, n_kv_heads=2)
GQA_SEED = 0

_REF_PROG = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp
from repro.configs import get_config, reduced
from repro.models.transformer import init_decoder_lm
from repro.serving import PagedServingEngine
from test_torch_zoo import ZOO, WORKLOADS, _waves, _record
from test_torch_moe_layouts import (MOE_ARCHS, MODES, MOE_WORKLOAD,
                                    GQA_HEADS, GQA_SEED)

out = {}
for arch in MOE_ARCHS:
    cfg = reduced(get_config(arch))
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          init_decoder_lm(cfg, jax.random.PRNGKey(ZOO[arch])))
    wl = MOE_WORKLOAD[arch]
    for mode in MODES:
        os.environ["REPRO_MOE_SHARD"] = mode  # read where the weights are cut
        eng = PagedServingEngine(cfg, params, tensor_parallel=2,
                                 **WORKLOADS[wl])
        out[f"{arch}/{mode}"] = _record(eng, _waves(arch, wl, cfg.vocab))
os.environ.pop("REPRO_MOE_SHARD")
cfg = dataclasses.replace(reduced(get_config("olmo-1b")), **GQA_HEADS)
params = jax.tree.map(lambda a: a.astype(jnp.float32),
                      init_decoder_lm(cfg, jax.random.PRNGKey(GQA_SEED)))
for wl in WORKLOADS:
    eng = PagedServingEngine(cfg, params, tensor_parallel=4, **WORKLOADS[wl])
    out[f"gqa/{wl}"] = _record(eng, _waves("olmo-1b", wl, cfg.vocab))
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("layouts_reference") / "ref.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")]))
    env.pop("REPRO_MOE_SHARD", None)
    res = subprocess.run([sys.executable, "-c", _REF_PROG, str(path)],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(path.read_text())


def _weights(jc, tc, seed):
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      init_decoder_lm(jc, jax.random.PRNGKey(seed)))
    return jp, model_from_jax(tc, jax.tree.map(np.asarray, jp),
                              dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def moe_weights():
    return {arch: _weights(jreduced(jget(arch)), treduced(tget(arch)),
                           ZOO[arch]) for arch in MOE_ARCHS}


def _gqa_configs():
    return (dataclasses.replace(jreduced(jget("olmo-1b")), **GQA_HEADS),
            dataclasses.replace(treduced(tget("olmo-1b")), **GQA_HEADS))


def _x(B, S, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, d)).astype(np.float32)


@pytest.mark.parametrize("dropless", [True, False])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_parallel_partials_sum_to_the_layer(moe_weights, arch,
                                                   dropless):
    """Each shard routes over all E experts and runs the products of its
    E/T; the T partial outputs sum to the whole layer's (the capacity and
    every slot are counted over all E, so capacity-bounded drops agree
    too)."""
    tc = treduced(tget(arch))
    _, model = moe_weights[arch]
    mesh = make_serving_mesh(2, ["cpu", "cpu"], moe_shard="ep")
    assert moe_axis(tc, 2, "ep") == 0
    shards = param_shards(tc, model, mesh)
    x = torch.from_numpy(_x(2, 9, tc.d_model, seed=4))
    for layer in range(tc.n_layers):
        full = dict(model.blocks[layer].moe)
        parts = [sh["blocks"][layer]["moe"] for sh in shards]
        E = tc.n_experts
        for s, p in enumerate(parts):
            assert torch.equal(p["w_router"], full["w_router"])
            for n in ("w_gate", "w_up", "w_down"):
                assert torch.equal(p[n], full[n][s * E // 2:(s + 1) * E // 2])
        whole, aux = tmoe.moe_apply(tc, x, full, dropless=dropless)
        outs = [tmoe.moe_apply(tc, x, p, dropless=dropless,
                               expert0=s * E // 2) for s, p in enumerate(parts)]
        torch.testing.assert_close(outs[0][0] + outs[1][0], whole,
                                   atol=1e-5, rtol=1e-5)
        assert all(torch.equal(a, aux) for _, a in outs)  # routed over all E
        assert all(o.abs().sum() > 0 for o, _ in outs)


@pytest.mark.parametrize("mode,axis", [("tp", 1), ("ep", 0), ("data", None),
                                       ("none", None)])
def test_moe_layouts_follow_the_reference_serving_spec(mode, axis):
    """The axis each mode cuts on a (1, T) serving mesh is the one the
    reference's ``param_specs(serving=True)`` puts on 'model' under the
    same ``REPRO_MOE_SHARD``; ``ep`` with T not dividing E (3 experts over
    2 shards) is replicated, as there."""
    class Mesh:
        shape = {"data": 1, "model": 2}
    for E in (8, 3):
        jc = dataclasses.replace(jreduced(jget("olmoe-1b-7b")), n_experts=E)
        tc = dataclasses.replace(treduced(tget("olmoe-1b-7b")), n_experts=E)
        shapes = jax.eval_shape(lambda: init_decoder_lm(
            jc, jax.random.PRNGKey(0)))
        os.environ["REPRO_MOE_SHARD"] = mode
        try:
            spec = jrules.param_specs(jc, shapes, Mesh(),
                                      serving=True)["blocks"]["moe"]["w_down"]
        finally:
            os.environ.pop("REPRO_MOE_SHARD")
        want = next((i - 1 for i, p in enumerate(spec) if p == "model"), None)
        got = moe_axis(tc, 2, mode)
        assert got == want
        assert got == (None if (mode == "ep" and E == 3) else axis)


def _expert_bytes(shard):
    return sum(t.numel() * t.element_size() for blk in shard["blocks"]
               for n, t in blk["moe"].items() if n != "w_router")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_modes_match_reference_tp2(moe_weights, reference, monkeypatch,
                                       arch, mode):
    """The engine reads ``REPRO_MOE_SHARD`` where it cuts the weights: under
    ``ep`` each shard holds half the experts whole (its expert bytes half
    the whole set), under ``data`` and ``none`` every shard all of them and
    the layer runs once, on the lead.  Tokens, counters, tables and clock
    equal the JAX engine's at TP=2 under the same mode."""
    jp, model = moe_weights[arch]
    tc = treduced(tget(arch))
    monkeypatch.setenv("REPRO_MOE_SHARD", mode)
    wl = MOE_WORKLOAD[arch]
    eng = PagedServingEngine(tc, model, tensor_parallel=2,
                             devices=["cpu", "cpu"], **WORKLOADS[wl])
    monkeypatch.delenv("REPRO_MOE_SHARD")
    assert eng.mesh.moe_shard == mode
    whole = _expert_bytes(model.tree())
    per = [_expert_bytes(m.tree()) for m in eng.params]
    assert per == [whole // 2] * 2 if mode == "ep" else per == [whole] * 2
    mine = _record(eng, _waves(arch, wl, tc.vocab))
    _hold(arch, wl, mine, reference[f"{arch}/{mode}"], jp)


def test_straddling_query_slabs_are_refused():
    """No head layout is refused any more: a slab within one group, a
    whole number of groups and a slab that straddles groups are split by
    query slab (the straddling one over the heads it reads, its launch
    padded to whole groups); a query head count T does not divide leaves
    the attention block whole on every shard, over all query heads and a
    whole copy of the arena."""
    cfg = treduced(tget("olmo-1b"))
    for heads, tp in ((dict(n_heads=8, n_kv_heads=2), 4),
                      (dict(n_heads=8, n_kv_heads=2), 8),
                      (dict(n_heads=8, n_kv_heads=4), 2),
                      (dict(n_heads=8, n_kv_heads=1), 4),
                      (dict(n_heads=6, n_kv_heads=3), 2),
                      (dict(n_heads=12, n_kv_heads=3), 4)):
        assert heads_split(dataclasses.replace(cfg, **heads), tp)
    whole = dataclasses.replace(cfg, n_heads=6, n_kv_heads=3)
    assert not heads_split(whole, 4)
    assert [kv_heads(whole, 4, s) for s in range(4)] == [(0, 3)] * 4
    assert [query_window(whole, 4, s) for s in range(4)] == [(0, 6)] * 4
    assert kv_join(whole, 4) == ((0, 0),)
    c = dataclasses.replace(cfg, **GQA_HEADS)
    assert [kv_heads(c, 4, s) for s in range(4)] == [(0, 1)] * 2 + [(1, 1)] * 2
    assert kv_join(c, 4) == ((0, 0), (2, 0))
    assert [kv_heads(c, 2, s) for s in range(2)] == [(0, 1), (1, 1)]
    assert [query_window(c, 4, s) for s in range(4)] == [(0, 2)] * 4
    # Hq=12, Hkv=3 at T=4: slabs of 3 over groups of 4 query heads
    c = dataclasses.replace(cfg, n_heads=12, n_kv_heads=3)
    assert [kv_heads(c, 4, s) for s in range(4)] == [(0, 1), (0, 2), (1, 2),
                                                     (2, 1)]
    assert [query_window(c, 4, s) for s in range(4)] == [(0, 3), (3, 8),
                                                         (2, 8), (0, 3)]
    assert kv_join(c, 4) == ((0, 0), (1, 1), (2, 1))


def _min_margin_gqa(jc, jp, run):
    """Smallest top-1/top-2 logit gap of the reference's float32 forward
    over every position that produced a generated token."""
    seqs = [p + t for p, t in zip(run["prompts"], run["tokens"])]
    width = max(map(len, seqs))
    batch = jnp.asarray([s + [0] * (width - len(s)) for s in seqs])
    x, _ = decoder_forward(jc, jp, {"tokens": batch}, dropless=True)
    logits = np.asarray(unembed(jc, jp, x), np.float32)
    worst = np.inf
    for i, (p, s) in enumerate(zip(run["prompts"], seqs)):
        top = np.sort(logits[i, len(p) - 1:len(s) - 1], axis=-1)[:, -2:]
        worst = min(worst, float((top[:, 1] - top[:, 0]).min()))
    return worst


@pytest.mark.parametrize("wl", list(WORKLOADS))
def test_gqa_heads_the_mesh_does_not_divide_match_reference_tp4(reference,
                                                                 wl):
    """Hq=8, Hkv=2 at T=4: shards 0-1 hold KV head 0, shards 2-3 head 1
    (the K/V projections' columns of that head and a one-head slab of the
    arena), each shard's kernel launch on its 2 query heads over it.
    Token-, table-, counter- and clock-equal to the JAX engine at
    ``tensor_parallel=4``, which replicates the arena; the shards that hold
    one head hold bitwise equal slabs after the run."""
    jc, tc = _gqa_configs()
    jp, model = _weights(jc, tc, GQA_SEED)
    eng = PagedServingEngine(tc, model, tensor_parallel=4,
                             devices=["cpu"] * 4, **WORKLOADS[wl])
    mine = _record(eng, _waves("olmo-1b", wl, tc.vocab))
    ref = reference[f"gqa/{wl}"]
    assert _min_margin_gqa(jc, jp, ref) > MARGIN_TOL
    assert mine["tokens"] == ref["tokens"]
    assert mine["stats"] == ref["stats"]
    assert mine["tables"] == ref["tables"]
    assert mine["clock"] == ref["clock"] == mine["stats"]["warnings_fired"]
    assert eng.kv_manager.kv_replicated
    assert eng.kv_manager.kv_join == ((0, 0), (2, 0))
    D = tc.head_dim
    for s, m in enumerate(eng.params):
        h = s // 2
        assert torch.equal(m.blocks[0].attn["wk"],
                           model.blocks[0].attn["wk"][:, h * D:(h + 1) * D])
    for n in ("k", "v"):
        slabs = [kv[n] for kv in eng.kv]
        assert all(t.shape[3] == 1 for t in slabs)
        assert torch.equal(slabs[0], slabs[1]) and torch.equal(slabs[2],
                                                               slabs[3])
        assert slabs[0].abs().sum() > 0 and slabs[2].abs().sum() > 0
    # the joined arena equals a TP=1 engine's within the bf16 arena's rounding
    one = PagedServingEngine(tc, model, device="cpu", **WORKLOADS[wl])
    run1 = _record(one, _waves("olmo-1b", wl, tc.vocab))
    assert run1["tokens"] == mine["tokens"]
    for n in ("k", "v"):
        torch.testing.assert_close(eng.kv_manager.gather_kv()[n].float(),
                                   one.kv[n].float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("C", [1, 4])
def test_sharded_kernel_on_head_slabs_matches_one_call(C):
    """Kernel 3 (plain versions on the CPU) over the per-shard slabs of
    Hq=8, Hkv=2 at T=4 — each shard its 2 query heads over a copy of its one
    KV head, the fused append into each copy — against one call over the
    whole arena: the output to 1e-6 and every copy equal to its head of the
    whole arena."""
    q, k, v, kn, vn, bt, ln, cl, ok = (torch.from_numpy(a) for a in
                                       append_case(C, 8, 2, 16, seed=30 + C))
    full = {"k": k.clone(), "v": v.clone()}
    want = paged_attention(q, full, bt, ln, chunk_lens=cl,
                           append=(kn, vn, ok))
    mesh = make_serving_mesh(4, ["cpu"] * 4)
    heads = [s // 2 for s in range(4)]
    slabs = [{"k": k[:, :, h:h + 1].clone(), "v": v[:, :, h:h + 1].clone()}
             for h in heads]
    outs = paged_attention(
        [q[:, :, 2 * s:2 * s + 2].contiguous() for s in range(4)], slabs, bt,
        ln, chunk_lens=cl, mesh=mesh,
        append=([kn[:, :, h:h + 1].contiguous() for h in heads],
                [vn[:, :, h:h + 1].contiguous() for h in heads], ok))
    torch.testing.assert_close(torch.cat(outs, dim=2), want, atol=1e-6,
                               rtol=1e-6)
    for s, h in enumerate(heads):
        for n in ("k", "v"):
            assert torch.equal(slabs[s][n], full[n][:, :, h:h + 1])
