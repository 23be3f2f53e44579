"""The port's serving engine on the rest of the decoder zoo, against the JAX
engine, on the CPU.

Reduced olmoe-1b-7b and mixtral-8x7b (MoE: the dropless expert layer in
the fused step), paligemma-3b (VLM: its text decoder, multi-query),
granite-20b (dense, multi-query), qwen2-72b (QKV biases, untied
``lm_head``, ``rope_theta`` 1e6) and nemotron-4-15b (layernorm, squared
ReLU, untied): the reference's float32 weights through the weight bridge,
the same requests to both engines.

- TP=1, in this process: each config on two workloads — chunked prefill
  in a tight pool (preemption), and prefix sharing with speculation.
- TP=2, against ONE subprocess of the JAX engine at ``tensor_parallel=2``
  on four forced host devices (the test process must keep seeing one jax
  device), which runs every config's workloads and hands its results
  over as JSON.  The port's shards are ``devices=["cpu", "cpu"]``; the
  multi-query configs serve over the replicated KV arena.  The JAX
  engine's own TP=2 tokens need not equal its TP=1 tokens, so TP=2 is held
  to the JAX engine at TP=2.

Exact: generated tokens, every integer ``EngineStats`` counter, the block
tables, and ``warnings_fired == pool.clock``.  Both engines keep a bf16 KV
arena, so K/V differ only by float32 summation order before the same
rounding; greedy tokens are then equal wherever the top-1/top-2 logit
margin is wide, and each run checks its margins stay above ``MARGIN_TOL``
(1e-3), as ``tests/test_torch_engine.py`` does.  The margin is measured on
the reference's float32 dense forward without the image prefix or the
sliding window and with dropless MoE: the function the paged step
computes.

Also the replicated arena itself: after a TP=2 run both shards' copies
are bitwise equal and each holds the whole arena's bytes.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.models.transformer import decoder_forward, init_decoder_lm, unembed
from repro.serving import PagedServingEngine as JaxEngine
from repro_torch.configs import get_config as tget, reduced as treduced
from repro_torch.convert import model_from_jax
from repro_torch.serving import PagedServingEngine

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
MARGIN_TOL = 1e-3
#: config -> weight seed (``jax.random.PRNGKey``), one whose workloads keep
#: every margin above MARGIN_TOL at TP=1 and TP=2
ZOO = {"olmoe-1b-7b": 0, "mixtral-8x7b": 1, "paligemma-3b": 0,
       "granite-20b": 5, "qwen2-72b": 8, "nemotron-4-15b": 0}
class RepeatDrafter:
    """Drafts the context's last token k times: a draft every decoding row
    gets (the n-gram drafter finds none after a random model's first
    token), so the speculative executable verifies drafts in every run."""

    def propose(self, context, k):
        return [context[-1]] * k


WORKLOADS = {
    "chunked_tight_pool": dict(num_pages=8, page_size=4, max_batch=3,
                               prefill_chunk=8),
    "prefix_speculative": dict(num_pages=32, page_size=4, max_batch=3,
                               prefix_cache=True, speculative_k=2,
                               prefill_chunk=4, drafter=RepeatDrafter()),
}


def _waves(arch, workload, vocab):
    """Waves of (prompts, max_new_tokens), each run to completion in turn."""
    rng = np.random.default_rng(zlib.crc32(f"{arch}/{workload}".encode()))

    def prompts(n, lo, hi):
        return [rng.integers(0, vocab, int(k)).tolist()
                for k in rng.integers(lo, hi + 1, n)]
    if workload == "chunked_tight_pool":
        return [(prompts(5, 3, 14), 5)]
    # a 10-token prompt finishes first (its committed tail page is cached);
    # then the same prompt and an extension hit the cache, the tail match
    # granted copy-on-write, beside a prompt of its own
    p = prompts(1, 10, 10)[0]
    return [([p], 1), ([p, p + prompts(1, 3, 3)[0]] + prompts(1, 5, 9), 5)]


_REF_PROG = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduced
from repro.models.transformer import init_decoder_lm
from repro.serving import PagedServingEngine
from test_torch_zoo import ZOO, WORKLOADS, _waves, _record

out = {}
for arch, seed in ZOO.items():
    cfg = reduced(get_config(arch))
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          init_decoder_lm(cfg, jax.random.PRNGKey(seed)))
    for wl, kw in WORKLOADS.items():
        eng = PagedServingEngine(cfg, params, tensor_parallel=2, **kw)
        if arch in ("paligemma-3b", "granite-20b"):  # the replicated arena
            assert tuple(eng.kv_manager.step_state().kv["k"].sharding.spec) \
                in ((), (None,) * 5)
        out[f"{arch}/{wl}"] = _record(eng, _waves(arch, wl, cfg.vocab))
json.dump(out, open(sys.argv[1], "w"))
"""


def _int_stats(stats):
    return {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats)
            if f.type in ("int", int)}


def _record(eng, waves):
    """Serve ``waves`` on ``eng``; returns what the parity checks compare."""
    reqs = []
    for prompts, max_new in waves:
        reqs += [eng.submit(p, max_new) for p in prompts]
        eng.run()
    assert all(r.state == "finished" for r in reqs)
    st = eng.kv_manager.step_state()
    return dict(prompts=[r.prompt for r in reqs],
                tokens=[list(map(int, r.generated)) for r in reqs],
                stats=_int_stats(eng.stats),
                tables=np.asarray(st.block_tables).tolist(),
                clock=int(np.asarray(eng.pool.clock)))


def _min_margin(arch, jp, run):
    """Smallest top-1/top-2 logit gap of the reference's float32 forward
    (the paged step's function: no image prefix, no window, dropless MoE)
    over every position that produced a generated token; one right-padded
    batch (causal, and dropless routing is per token, so padding after a
    row's tokens changes none of its logits)."""
    jc = dataclasses.replace(jreduced(jget(arch)), prefix_tokens=0,
                             sliding_window=None)
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


@pytest.fixture(scope="module")
def weights():
    out = {}
    for arch, seed in ZOO.items():
        jc, tc = jreduced(jget(arch)), treduced(tget(arch))
        jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                          init_decoder_lm(jc, jax.random.PRNGKey(seed)))
        out[arch] = (jc, jp, tc, model_from_jax(
            tc, jax.tree.map(np.asarray, jp), dtype=torch.float32,
            device="cpu"))
    return out


@pytest.fixture(scope="module")
def reference_tp2(tmp_path_factory):
    path = tmp_path_factory.mktemp("zoo_reference") / "ref.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")]))
    res = subprocess.run([sys.executable, "-c", _REF_PROG, str(path)],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(path.read_text())


def _hold(arch, wl, mine, ref, jp):
    assert _min_margin(arch, jp, ref) > MARGIN_TOL, \
        "workload too close to a tie for a bf16-arena parity check"
    assert mine["tokens"] == ref["tokens"]
    assert mine["stats"] == ref["stats"]
    assert mine["tables"] == ref["tables"]
    assert mine["clock"] == ref["clock"] == mine["stats"]["warnings_fired"]
    if wl == "chunked_tight_pool":
        assert mine["stats"]["preemptions"] > 0  # the pool really churned
    else:
        assert mine["stats"]["prefix_hits"] > 0
        assert mine["stats"]["tokens_drafted"] > 0  # drafts were verified


@pytest.mark.parametrize("wl", list(WORKLOADS))
@pytest.mark.parametrize("arch", list(ZOO))
def test_tp1_engine_matches_reference(weights, arch, wl):
    jc, jp, tc, tm = weights[arch]
    waves = _waves(arch, wl, jc.vocab)
    ref = _record(JaxEngine(jc, jp, **WORKLOADS[wl]), waves)
    mine = _record(PagedServingEngine(tc, tm, device="cpu", **WORKLOADS[wl]),
                   waves)
    _hold(arch, wl, mine, ref, jp)


@pytest.mark.parametrize("wl", list(WORKLOADS))
@pytest.mark.parametrize("arch", list(ZOO))
def test_tp2_engine_matches_reference_tp2(weights, reference_tp2, arch, wl):
    jc, jp, tc, tm = weights[arch]
    eng = PagedServingEngine(tc, tm, tensor_parallel=2,
                             devices=["cpu", "cpu"], **WORKLOADS[wl])
    mine = _record(eng, _waves(arch, wl, jc.vocab))
    _hold(arch, wl, mine, reference_tp2[f"{arch}/{wl}"], jp)
    assert eng.kv_manager.kv_replicated == (tc.n_kv_heads % 2 != 0)


@pytest.mark.parametrize("arch", ["paligemma-3b", "granite-20b"])
def test_replicated_arena_copies_stay_bitwise_equal(weights, arch):
    """Multi-query over two shards: each shard holds the whole arena (its
    bytes are the TP=1 arena's), computes the same K/V from its replicated
    ``wk``/``wv`` and appends them to its own copy — so after a run with
    chunked prefill, preemption, prefix sharing (copy-on-write) and
    speculation the copies are bitwise equal, and equal the TP=1 arena
    within the bf16 arena's rounding."""
    jc, jp, tc, tm = weights[arch]
    assert tc.n_kv_heads == 1
    arenas = []
    for kw in (dict(device="cpu"),
               dict(tensor_parallel=2, devices=["cpu", "cpu"])):
        eng = PagedServingEngine(tc, tm, **WORKLOADS["prefix_speculative"],
                                 **kw)
        run = _record(eng, _waves(arch, "prefix_speculative", jc.vocab))
        assert run["stats"]["cow_copies"] > 0
        arenas.append((eng, run))
    (one, run1), (two, run2) = arenas
    assert run2["tokens"] == run1["tokens"]
    assert len(two.kv) == 2 and two.kv_manager.kv_replicated
    for n in ("k", "v"):
        a, b = two.kv[0][n], two.kv[1][n]
        assert a.data_ptr() != b.data_ptr()
        assert torch.equal(a, b)
        assert a.shape == one.kv[n].shape
        assert a.numel() * a.element_size() == \
            one.kv[n].numel() * one.kv[n].element_size()
        assert a.abs().sum() > 0
        torch.testing.assert_close(two.kv_manager.gather_kv()[n].float(),
                                   one.kv[n].float(), atol=2e-2, rtol=2e-2)
    # the K/V projections are whole on every shard, the query heads split
    attn = [m.blocks[0].attn for m in two.params]
    assert all(torch.equal(a["wk"], tm.blocks[0].attn["wk"]) for a in attn)
    assert attn[0]["wq"].shape[1] * 2 == tm.blocks[0].attn["wq"].shape[1]
