"""Tensor-parallel serving in the port against the JAX package, on the CPU.

The reference runs in a SUBPROCESS with four forced host devices (the main
test process must keep seeing one jax device); it writes its results to an
``.npz`` that the tests hold the port to.  The port's shards are
``devices=["cpu", "cpu"]`` — its counterpart of those forced devices.

- the sharded paged-attention kernel (plain version per shard on the CPU)
  against the reference's interpret-mode ``paged_attention_sharded``, in
  the decode and chunk forms, GQA 8:4 over 2 shards and 16:4 over 4, to
  1e-5 in float32; and with the fused append (each shard appends to its own
  slab, then attends) against the reference step's scatter followed by its
  sharded kernel, GQA 8:4 over 2 shards: the joined arena exactly, the
  output to 1e-5;
- the port's TP=2 engine against the reference's TP=2 engine on the
  reference's own TP parity workload (chunked prefill + speculation +
  prefix sharing, in two waves): tokens, lengths, block tables and the OA
  counters exactly equal, the joined KV arena within 2e-2 (bf16 arena;
  the row-parallel sums reassociate float32 products, as the reference's
  ``psum`` does);
- the port's TP=2 against its TP=1: the same, and each shard's KV slab
  exactly half the TP=1 arena's bytes;
- copy-on-write of a shared page on every shard's slab;
- configs with QKV and MLP biases (``bq``… column-parallel, ``b_down``
  added once after the row-parallel sum), an untied ``lm_head`` (vocab
  split) and a ``d_ff`` two shards do not divide (MLP replicated), each at
  TP=2 against TP=1;
- the constructor's errors.
"""

import dataclasses
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
from repro.models.transformer import init_decoder_lm as jinit
from repro_torch.configs import get_config as tget, reduced as treduced
from repro_torch.convert import model_from_jax
from repro_torch.kernels.ops import paged_attention
from repro_torch.kernels.paged_attention import paged_attention_sharded_plain
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models.transformer import init_decoder_lm
from repro_torch.serving import PagedServingEngine
from split_cases import append_case

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
ENGINE_KW = dict(num_pages=64, page_size=2, max_batch=4, prefix_cache=True,
                 speculative_k=2, prefill_chunk=4)
PROMPTS = [[5, 7, 11, 13], [5, 7, 11, 13], [3, 1, 4, 1, 5], [2, 2, 2],
           [9, 8, 7, 6, 5, 4], [1, 2, 3, 1, 2, 3, 1, 2]]
WAVE2 = [[5, 7, 11, 13, 99], [5, 7, 11, 13, 98]]
# (name, B, Hq, Hkv, D, P, page, tp): the first is the reference's own
# sharded-kernel case (tests/test_tensor_parallel.py)
KERNEL_CASES = [("gqa8_4_tp2", 3, 8, 4, 16, 12, 4, 2),
                ("gqa16_4_tp4", 3, 16, 4, 16, 12, 4, 4)]
APPEND_CS = [1, 4]  # chunk widths of the fused-append case (Hq 8, Hkv 4)

_REF_PROG = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduced
from repro.kernels.ops import paged_attention
from repro.launch.mesh import make_serving_mesh
from repro.models.transformer import init_decoder_lm
from repro.serving import PagedServingEngine

out = {}
rng = np.random.default_rng(7)
for name, B, Hq, Hkv, D, P_, page, tp in CASES:
    k = rng.standard_normal((P_, page, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((P_, page, Hkv, D)).astype(np.float32)
    tables = rng.permutation(P_)[: B * 3].reshape(B, 3).astype(np.int32)
    lengths = np.asarray([5, 12, 9], np.int32)
    kv = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    out.update({name + "_k": k, name + "_v": v, name + "_tables": tables,
                name + "_lengths": lengths})
    for form, qshape in (("decode", (B, Hq, D)), ("chunk", (B, 2, Hq, D))):
        q = rng.standard_normal(qshape).astype(np.float32)
        got = paged_attention(jnp.asarray(q), kv, jnp.asarray(tables),
                              jnp.asarray(lengths), impl="interpret",
                              mesh=make_serving_mesh(tp))
        out[f"{name}_{form}_q"] = q
        out[f"{name}_{form}_out"] = np.asarray(got)
        out[f"{name}_{form}_shards"] = len(got.sharding.device_set)

from split_cases import append_case
for C in APPEND_CS:
    # the reference step's masked scatter (_chunk_core), then its kernel
    q, k, v, kn, vn, bt, ln, cl, ok = append_case(C, 8, 4, 16, seed=20 + C)
    P, page, M = k.shape[0], k.shape[1], bt.shape[1]
    pos = (ln - cl)[:, None] + np.arange(C)[None]
    pages = np.take_along_axis(bt, np.minimum(pos // page, M - 1), axis=1)
    wvalid = (np.arange(C)[None] < cl[:, None]) & (pages >= 0) \
        & (pos // page < M) & ok[:, None]
    pidx, slot = jnp.asarray(np.where(wvalid, pages, P)), jnp.asarray(pos % page)
    kv = {n: jnp.asarray(a).at[pidx, slot].set(jnp.asarray(b), mode="drop")
          for n, a, b in (("k", k, kn), ("v", v, vn))}
    got = paged_attention(jnp.asarray(q), kv, jnp.asarray(bt), jnp.asarray(ln),
                          impl="interpret", mesh=make_serving_mesh(2),
                          chunk_lens=jnp.asarray(cl))
    out.update({f"append{C}_k": np.asarray(kv["k"]),
                f"append{C}_v": np.asarray(kv["v"]),
                f"append{C}_out": np.asarray(got),
                f"append{C}_shards": len(got.sharding.device_set)})

CFG = reduced(get_config("olmo-1b"))
params = jax.tree.map(lambda a: a.astype(jnp.float32),
                      init_decoder_lm(CFG, jax.random.PRNGKey(0)))
eng = PagedServingEngine(CFG, params, tensor_parallel=2, **ENGINE_KW)
reqs = [eng.submit(p, 8) for p in PROMPTS]
eng.run()
reqs += [eng.submit(p, 8) for p in WAVE2]
eng.run()
st = eng.kv_manager.step_state()
assert all(r.state == "finished" for r in reqs)
out.update(
    tokens=np.asarray([r.generated for r in reqs]),
    k=np.asarray(st.kv["k"], np.float32), v=np.asarray(st.kv["v"], np.float32),
    lengths=np.asarray(st.lengths), tables=np.asarray(st.block_tables),
    counters=np.asarray([eng.stats.prefix_hits, eng.stats.tokens_accepted,
                         eng.stats.warnings_fired, int(eng.pool.clock)]))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("tp_reference") / "ref.npz"
    prog = (f"CASES = {KERNEL_CASES!r}\nENGINE_KW = {ENGINE_KW!r}\n"
            f"PROMPTS = {PROMPTS!r}\nWAVE2 = {WAVE2!r}\n"
            f"APPEND_CS = {APPEND_CS!r}\n" + _REF_PROG)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")]))
    res = subprocess.run([sys.executable, "-c", prog, str(path)],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def weights():
    jc = jreduced(jget("olmo-1b"))
    tc = treduced(tget("olmo-1b"))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jinit(jc, jax.random.PRNGKey(0)))
    return tc, model_from_jax(tc, jax.tree.map(np.asarray, jp),
                              dtype=torch.float32, device="cpu")


def _slabs(a, tp, axis):
    return [t.contiguous() for t in torch.from_numpy(a).chunk(tp, dim=axis)]


@pytest.mark.parametrize("form", ["decode", "chunk"])
@pytest.mark.parametrize("case", KERNEL_CASES, ids=[c[0] for c in KERNEL_CASES])
def test_sharded_kernel_matches_reference(reference, case, form):
    name, tp = case[0], case[-1]
    r = {k[len(name) + 1:]: v for k, v in reference.items()
         if k.startswith(name + "_")}
    assert int(r[f"{form}_shards"]) == tp  # the reference really sharded
    mesh = make_serving_mesh(tp, ["cpu"] * tp)
    qs = _slabs(r[f"{form}_q"], tp, axis=-2)  # Hq, kv-head-major
    kvs = [{"k": k, "v": v} for k, v in zip(_slabs(r["k"], tp, 2),
                                            _slabs(r["v"], tp, 2))]
    outs = paged_attention(qs, kvs, torch.from_numpy(r["tables"]),
                           torch.from_numpy(r["lengths"]), mesh=mesh)
    assert len(outs) == tp and all(o.shape == q.shape for o, q in zip(outs, qs))
    got = torch.cat(outs, dim=-2).numpy()
    np.testing.assert_allclose(got, r[f"{form}_out"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("C", APPEND_CS)
def test_sharded_fused_append_matches_reference(reference, C):
    """``paged_attention(..., mesh=, append=)`` over 2 CPU shards: each
    shard writes its own slab of the new K/V, then attends; the joined
    arena equals the reference's after its step's scatter, exactly, and
    the output its interpret-mode sharded kernel's to 1e-5."""
    assert int(reference[f"append{C}_shards"]) == 2
    q, k, v, kn, vn, bt, ln, cl, ok = append_case(C, 8, 4, 16, seed=20 + C)
    mesh = make_serving_mesh(2, ["cpu", "cpu"])
    kvs = [{"k": a, "v": b} for a, b in zip(_slabs(k, 2, 2), _slabs(v, 2, 2))]
    T = torch.from_numpy
    outs = paged_attention(_slabs(q, 2, axis=-2), kvs, T(bt), T(ln),
                           mesh=mesh, chunk_lens=T(cl),
                           append=(_slabs(kn, 2, 2), _slabs(vn, 2, 2), T(ok)))
    for n in ("k", "v"):
        joined = torch.cat([x[n] for x in kvs], dim=2).numpy()
        np.testing.assert_array_equal(joined, reference[f"append{C}_{n}"])
    np.testing.assert_allclose(torch.cat(outs, dim=-2).numpy(),
                               reference[f"append{C}_out"], atol=1e-5, rtol=0)


def test_sharded_kernel_rejects_heads_the_mesh_does_not_divide():
    mesh = make_serving_mesh(2, ["cpu", "cpu"])
    q = torch.zeros(1, 1, 3, 8)
    kv = torch.zeros(4, 2, 3, 8)
    ints = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="not divisible by tp=2"):
        paged_attention_sharded_plain(
            [q, q], [kv, kv], [kv, kv], torch.zeros(1, 2, dtype=torch.int32),
            ints, ints, mesh=mesh, n_kv_heads=3)


def _serve(tc, model, **kw):
    eng = PagedServingEngine(tc, model, **ENGINE_KW, **kw)
    reqs = [eng.submit(p, 8) for p in PROMPTS]
    eng.run()
    reqs += [eng.submit(p, 8) for p in WAVE2]
    eng.run()
    assert all(r.state == "finished" for r in reqs)
    assert eng.stats.warnings_fired == int(eng.pool.clock)
    st = eng.kv_manager.step_state()
    kv = eng.kv_manager.gather_kv()
    return dict(
        eng=eng, tokens=[r.generated for r in reqs],
        k=kv["k"].float().numpy(), v=kv["v"].float().numpy(),
        lengths=st.lengths.numpy(), tables=st.block_tables.numpy(),
        counters=[eng.stats.prefix_hits, eng.stats.tokens_accepted,
                  eng.stats.warnings_fired, int(eng.pool.clock)])


def test_tp2_engine_matches_reference_tp2(reference, weights):
    tc, model = weights
    got = _serve(tc, model, tensor_parallel=2, devices=["cpu", "cpu"])
    assert got["tokens"] == reference["tokens"].tolist()
    np.testing.assert_array_equal(got["lengths"], reference["lengths"])
    np.testing.assert_array_equal(got["tables"], reference["tables"])
    assert got["counters"] == reference["counters"].tolist()
    assert got["counters"][0] >= 1 and got["counters"][1] > 0  # shared, drafted
    for n in ("k", "v"):
        np.testing.assert_allclose(got[n], reference[n], atol=2e-2, rtol=2e-2)


def test_tp2_engine_matches_tp1_and_halves_kv_bytes(weights):
    tc, model = weights
    one = _serve(tc, model, device="cpu")
    two = _serve(tc, model, tensor_parallel=2, devices=["cpu", "cpu"])
    assert two["tokens"] == one["tokens"]
    np.testing.assert_array_equal(two["lengths"], one["lengths"])
    np.testing.assert_array_equal(two["tables"], one["tables"])
    assert two["counters"] == one["counters"]
    for n in ("k", "v"):
        np.testing.assert_allclose(two[n], one[n], atol=2e-2, rtol=2e-2)
    full = one["eng"].kv
    for slab in two["eng"].kv:
        for n in ("k", "v"):
            assert slab[n].numel() * slab[n].element_size() * 2 == \
                full[n].numel() * full[n].element_size()
    assert two["eng"].pool.clock.device == torch.device("cpu")


def test_tp2_copy_on_write_matches_tp1(weights):
    """A cached tail page granted copy-on-write: every shard copies its own
    slab's page (a copy on the lead slab alone leaves the other shards'
    heads reading a blank page)."""
    tc, model = weights
    rng = np.random.default_rng(3)
    p = rng.integers(0, tc.vocab, 10).tolist()
    waves = [([p], 1), ([p, p] + [p + rng.integers(0, tc.vocab, k).tolist()
                                  for k in (1, 3, 5)], 6)]
    outs = []
    for kw in (dict(device="cpu"),
               dict(tensor_parallel=2, devices=["cpu", "cpu"])):
        eng = PagedServingEngine(tc, model, num_pages=24, page_size=4,
                                 max_batch=3, prefix_cache=True, **kw)
        reqs = []
        for prompts, max_new in waves:
            reqs += [eng.submit(q, max_new) for q in prompts]
            eng.run()
        assert eng.stats.cow_copies > 0 and eng.stats.prefix_hits > 0
        kv = eng.kv_manager.gather_kv()
        outs.append(([r.generated for r in reqs], eng.stats.cow_copies,
                     kv["k"].float(), kv["v"].float()))
    assert outs[1][:2] == outs[0][:2]
    for i in (2, 3):
        torch.testing.assert_close(outs[1][i], outs[0][i], atol=2e-2,
                                   rtol=2e-2)


VARIANTS = {
    # column-parallel bq/bk/bv/b_up split with their columns; the
    # row-parallel b_down is added once after the sum (twice would move the
    # residual and, through it, every later layer's K/V)
    "biases": dict(attn_bias=True, mlp_type="gelu"),
    # an untied lm_head splits its vocab columns; the logits are joined
    "untied_lm_head": dict(tie_embeddings=False),
    # a d_ff the shards do not divide keeps the MLP whole on the lead
    "odd_d_ff": dict(d_ff=129),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_config_variant_tp2_matches_tp1(variant):
    cfg = dataclasses.replace(treduced(tget("olmo-1b")), **VARIANTS[variant])
    params = init_decoder_lm(cfg, seed=5, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(5)
    if variant == "biases":
        q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        for blk in params["blocks"]:
            for grp, name, n in (("attn", "bq", q), ("attn", "bk", kv),
                                 ("attn", "bv", kv), ("mlp", "b_up", cfg.d_ff),
                                 ("mlp", "b_down", cfg.d_model)):
                blk[grp][name] = torch.from_numpy(
                    rng.normal(0, 0.5, n).astype(np.float32))
    outs = []
    for kw in (dict(device="cpu"),
               dict(tensor_parallel=2, devices=["cpu", "cpu"])):
        eng = PagedServingEngine(cfg, params, num_pages=32, page_size=4,
                                 max_batch=3, prefill_chunk=4, **kw)
        reqs = [eng.submit(p, 6) for p in
                ([1, 2, 3, 4, 5, 6, 7], [9, 3, 1], [4, 4, 8, 2, 6])]
        eng.run()
        kv = eng.kv_manager.gather_kv()
        outs.append(([r.generated for r in reqs], kv["k"].float(),
                     kv["v"].float(), eng.params))
    assert outs[1][0] == outs[0][0]
    for i in (1, 2):
        torch.testing.assert_close(outs[1][i], outs[0][i], atol=2e-2,
                                   rtol=2e-2)
    shard = outs[1][3][0]
    if variant == "biases":
        assert outs[0][1].abs().max() > 0.5  # the biases reached the arena
    if variant == "untied_lm_head":
        assert shard.lm_head.shape == (cfg.d_model, cfg.vocab_padded // 2)
    if variant == "odd_d_ff":
        assert shard.blocks[0].mlp["w_down"].shape[0] == cfg.d_ff


def test_constructor_errors(weights):
    tc, model = weights
    kw = dict(num_pages=8, page_size=2)
    with pytest.raises(ValueError, match="devices"):
        PagedServingEngine(tc, model, tensor_parallel=2, device="cpu", **kw)
    with pytest.raises(RuntimeError, match="needs 2 devices"):
        PagedServingEngine(tc, model, tensor_parallel=2, devices=["cpu"], **kw)
    with pytest.raises(ValueError, match="not divisible"):
        PagedServingEngine(tc, model, tensor_parallel=3,
                           devices=["cpu"] * 3, **kw)
