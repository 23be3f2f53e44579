"""Tensor-parallel serving where a shard's query slab straddles KV-head
groups, against the JAX package, on the CPU.

Reduced olmo-1b with ``n_heads=6, n_kv_heads=3`` and with ``n_heads=12,
n_kv_heads=3``, at ``tensor_parallel=2``: a shard's 3 (or 6) query heads
read two KV heads, one of them shared with its neighbour.  The reference
replicates the paged arena there and lets GSPMD compute the rest; the
port gives shard s the contiguous KV heads its slab reads (shard 0 heads
0-1, shard 1 heads 1-2) and pads its query slab with zero heads to whole
groups for its one launch (``sharding/rules.py::query_window``).

- kernel 3 (plain versions on the CPU) over the straddling slabs, with
  the fused append, against one call over the whole arena: the output to
  1e-6, and each shard's slab equal to its heads of the whole arena;
- the engine at TP=2 against ONE subprocess of the JAX engine at TP=2 on
  two forced host devices, the zoo tests' workloads
  (``tests/test_torch_zoo.py``) and margin guard: tokens, every integer
  counter, block tables and clock equal; the joined arena within 2e-2 of
  the reference's (the bf16 arena, as the TP tests state it); both
  shards' copies of the shared head bitwise equal;
- the rules: the heads each shard holds and its query window, and where
  T does not divide Hq (T=4) the whole block on every shard.
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
from repro.models.transformer import init_decoder_lm
from repro_torch.configs import get_config as tget, reduced as treduced
from repro_torch.convert import model_from_jax
from repro_torch.kernels.ops import paged_attention
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.serving import PagedServingEngine
from repro_torch.serving.paged_decode import pad_window, window_heads
from repro_torch.sharding.rules import (heads_split, kv_heads, kv_join,
                                        query_window)
from split_cases import append_case
from test_torch_moe_layouts import _min_margin_gqa
from test_torch_zoo import MARGIN_TOL, WORKLOADS, _record, _waves

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
STRADDLES = {"hq6_hkv3": dict(n_heads=6, n_kv_heads=3),
             "hq12_hkv3": dict(n_heads=12, n_kv_heads=3)}
SEED = 0  # weights: every top-1/top-2 margin of both workloads above 0.3

_REF_PROG = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduced
from repro.models.transformer import init_decoder_lm
from repro.serving import PagedServingEngine
from test_torch_straddle import STRADDLES, SEED
from test_torch_zoo import WORKLOADS, _waves, _record

runs, arenas = {}, {}
for name, heads in STRADDLES.items():
    cfg = dataclasses.replace(reduced(get_config("olmo-1b")), **heads)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          init_decoder_lm(cfg, jax.random.PRNGKey(SEED)))
    for wl, kw in WORKLOADS.items():
        eng = PagedServingEngine(cfg, params, tensor_parallel=2, **kw)
        runs[f"{name}/{wl}"] = _record(eng, _waves("olmo-1b", wl, cfg.vocab))
        kv = eng.kv_manager.step_state().kv
        for n in ("k", "v"):
            arenas[f"{name}/{wl}/{n}"] = np.asarray(kv[n].astype(jnp.float32))
json.dump(runs, open(sys.argv[1] + ".json", "w"))
np.savez(sys.argv[1] + ".npz", **arenas)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("straddle_reference") / "ref"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")]))
    res = subprocess.run([sys.executable, "-c", _REF_PROG, str(path)],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    runs = json.loads(pathlib.Path(f"{path}.json").read_text())
    with np.load(f"{path}.npz") as z:
        return runs, {k: z[k] for k in z.files}


def _configs(name):
    heads = STRADDLES[name]
    return (dataclasses.replace(jreduced(jget("olmo-1b")), **heads),
            dataclasses.replace(treduced(tget("olmo-1b")), **heads))


def test_straddling_rules():
    """Hq=6, Hkv=3 at T=2: shard 0 holds KV heads 0-1 and launches on its
    heads 0-2 padded to 4 (offset 0), shard 1 holds heads 1-2 and launches
    on its heads 3-5 at offset 1 of 4; the arena joins as shard 0's two
    heads then shard 1's second.  T=4 does not divide Hq=6: the attention
    block is not split, every shard holds all three KV heads and launches
    on all six query heads (``tests/test_torch_heads_tp4.py``)."""
    _, tc = _configs("hq6_hkv3")
    assert heads_split(tc, 2)
    assert [kv_heads(tc, 2, s) for s in range(2)] == [(0, 2), (1, 2)]
    assert [query_window(tc, 2, s) for s in range(2)] == [(0, 4), (1, 4)]
    assert kv_join(tc, 2) == ((0, 0), (1, 1))
    _, tc12 = _configs("hq12_hkv3")
    assert [kv_heads(tc12, 2, s) for s in range(2)] == [(0, 2), (1, 2)]
    assert [query_window(tc12, 2, s) for s in range(2)] == [(0, 8), (2, 8)]
    assert not heads_split(tc, 4)
    assert [kv_heads(tc, 4, s) for s in range(4)] == [(0, 3)] * 4
    assert [query_window(tc, 4, s) for s in range(4)] == [(0, 6)] * 4


@pytest.mark.parametrize("C", [1, 4])
def test_sharded_kernel_on_straddling_slabs_matches_one_call(C):
    """Kernel 3 (plain versions) over Hq=6, Hkv=3 at T=2 — each shard its 3
    query heads over a copy of the 2 KV heads they read, padded to 4 query
    heads, the fused append into each copy — against one call over the
    whole arena: the output to 1e-6 and every copy equal to its heads of
    the whole arena."""
    q, k, v, kn, vn, bt, ln, cl, ok = (torch.from_numpy(a) for a in
                                       append_case(C, 6, 3, 16, seed=40 + C))
    full = {"k": k.clone(), "v": v.clone()}
    want = paged_attention(q, full, bt, ln, chunk_lens=cl,
                           append=(kn, vn, ok))
    mesh = make_serving_mesh(2, ["cpu"] * 2)
    heads = [(0, 2), (1, 3)]
    slabs = [{"k": k[:, :, a:b].clone(), "v": v[:, :, a:b].clone()}
             for a, b in heads]
    windows = [(0, 4), (1, 4)]
    outs = paged_attention(
        [pad_window(q[:, :, 3 * s:3 * s + 3].contiguous(), w)
         for s, w in enumerate(windows)], slabs, bt,
        ln, chunk_lens=cl, mesh=mesh,
        append=([kn[:, :, a:b].contiguous() for a, b in heads],
                [vn[:, :, a:b].contiguous() for a, b in heads], ok))
    got = [window_heads(o, w, 3) for o, w in zip(outs, windows)]
    torch.testing.assert_close(torch.cat(got, dim=2), want, atol=1e-6,
                               rtol=1e-6)
    for (a, b), slab in zip(heads, slabs):
        for n in ("k", "v"):
            assert torch.equal(slab[n], full[n][:, :, a:b])


@pytest.mark.parametrize("wl", list(WORKLOADS))
@pytest.mark.parametrize("name", list(STRADDLES))
def test_straddling_slabs_match_reference_tp2(reference, name, wl):
    """The engine at ``tensor_parallel=2`` serves the straddling layout as
    the JAX engine at TP=2 does: tokens, counters, block tables and clock
    equal, the joined arena within 2e-2; each shard holds the K/V
    projections' columns of its two heads, and the head both hold is
    bitwise the same in both copies after the run."""
    jc, tc = _configs(name)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      init_decoder_lm(jc, jax.random.PRNGKey(SEED)))
    model = model_from_jax(tc, jax.tree.map(np.asarray, jp),
                           dtype=torch.float32, device="cpu")
    eng = PagedServingEngine(tc, model, tensor_parallel=2,
                             devices=["cpu"] * 2, **WORKLOADS[wl])
    mine = _record(eng, _waves("olmo-1b", wl, tc.vocab))
    runs, arenas = reference
    ref = runs[f"{name}/{wl}"]
    assert _min_margin_gqa(jc, jp, ref) > MARGIN_TOL
    assert mine["tokens"] == ref["tokens"]
    assert mine["stats"] == ref["stats"]
    assert mine["tables"] == ref["tables"]
    assert mine["clock"] == ref["clock"] == mine["stats"]["warnings_fired"]
    assert eng.kv_manager.kv_replicated
    assert eng.kv_manager.kv_join == ((0, 0), (1, 1))
    D = tc.head_dim
    for s, m in enumerate(eng.params):
        first = kv_heads(tc, 2, s)[0]
        for n in ("wk", "wv"):
            assert torch.equal(
                m.blocks[0].attn[n],
                model.blocks[0].attn[n][:, first * D:(first + 2) * D])
    for n in ("k", "v"):
        slabs = [kv[n] for kv in eng.kv]
        assert all(t.shape[3] == 2 for t in slabs)
        assert torch.equal(slabs[0][:, :, :, 1], slabs[1][:, :, :, 0])
        assert slabs[0][:, :, :, 1].abs().sum() > 0
        joined = eng.kv_manager.gather_kv()[n]
        assert joined.shape[3] == 3
        np.testing.assert_allclose(joined.float().numpy(),
                                   arenas[f"{name}/{wl}/{n}"], atol=2e-2,
                                   rtol=2e-2)
