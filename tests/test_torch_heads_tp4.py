"""Tensor-parallel serving where T does not divide the query heads, against
the JAX package, on the CPU.

Reduced olmo-1b with ``n_heads=6, n_kv_heads=3`` at ``tensor_parallel=4``.
The reference's rules leave unsplit what 'model' does not divide and
replicate the paged arena, and GSPMD computes the rest.  The port leaves
the attention block whole on every shard (``sharding/rules.py::
heads_split``): each shard holds all of ``wq``/``wk``/``wv``/``wo``, a
whole copy of the arena, and launches kernel 1 once over all six query
heads, appending to its copy; the lead's output enters the residual.
The MLP and the logits still split four ways.

- kernel 3 (plain versions on the CPU) over four whole copies, with the
  fused append: every shard's output and copy equal to one call's;
- the engine at TP=4 against ONE subprocess of the JAX engine at TP=4 on
  four forced host devices, the zoo tests' workloads
  (``tests/test_torch_zoo.py``) and margin guard: tokens, every integer
  counter, block tables and clock equal; the arena within 2e-2 of the
  reference's (the bf16 arena, as the TP tests state it); the four
  copies bitwise equal; each shard's attention weights the whole ones.
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
from repro_torch.sharding.rules import (heads_split, kv_heads, kv_join,
                                        mlp_split, query_window)
from split_cases import append_case
from test_torch_moe_layouts import _min_margin_gqa
from test_torch_zoo import MARGIN_TOL, WORKLOADS, _record, _waves

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
HEADS = dict(n_heads=6, n_kv_heads=3)
TP = 4
SEED = 0  # the weights of tests/test_torch_straddle.py's Hq=6 layout

_REF_PROG = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduced
from repro.models.transformer import init_decoder_lm
from repro.serving import PagedServingEngine
from test_torch_heads_tp4 import HEADS, SEED, TP
from test_torch_zoo import WORKLOADS, _waves, _record

runs, arenas = {}, {}
cfg = dataclasses.replace(reduced(get_config("olmo-1b")), **HEADS)
params = jax.tree.map(lambda a: a.astype(jnp.float32),
                      init_decoder_lm(cfg, jax.random.PRNGKey(SEED)))
for wl, kw in WORKLOADS.items():
    eng = PagedServingEngine(cfg, params, tensor_parallel=TP, **kw)
    runs[wl] = _record(eng, _waves("olmo-1b", wl, cfg.vocab))
    kv = eng.kv_manager.step_state().kv
    for n in ("k", "v"):
        arenas[f"{wl}/{n}"] = np.asarray(kv[n].astype(jnp.float32))
json.dump(runs, open(sys.argv[1] + ".json", "w"))
np.savez(sys.argv[1] + ".npz", **arenas)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("heads_tp4_reference") / "ref"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")]))
    res = subprocess.run([sys.executable, "-c", _REF_PROG, str(path)],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    runs = json.loads(pathlib.Path(f"{path}.json").read_text())
    with np.load(f"{path}.npz") as z:
        return runs, {k: z[k] for k in z.files}


def _configs():
    return (dataclasses.replace(jreduced(jget("olmo-1b")), **HEADS),
            dataclasses.replace(treduced(tget("olmo-1b")), **HEADS))


def test_rules_leave_the_attention_block_whole():
    """Hq=6 at T=4: not split; every shard holds the three KV heads and
    launches on the six query heads; the arena joins from the lead's
    copy; the MLP still splits."""
    _, tc = _configs()
    assert not heads_split(tc, TP) and heads_split(tc, 2)
    assert [kv_heads(tc, TP, s) for s in range(TP)] == [(0, 3)] * TP
    assert [query_window(tc, TP, s) for s in range(TP)] == [(0, 6)] * TP
    assert kv_join(tc, TP) == ((0, 0),)
    assert mlp_split(tc, TP)


@pytest.mark.parametrize("C", [1, 4])
def test_sharded_kernel_over_whole_copies_matches_one_call(C):
    """Kernel 3 (plain versions) with one launch per shard over all six
    query heads and a whole copy of the arena each, the fused append into
    each copy, against one call over the arena: every output and every
    copy equal."""
    q, k, v, kn, vn, bt, ln, cl, ok = (torch.from_numpy(a) for a in
                                       append_case(C, 6, 3, 16, seed=60 + C))
    full = {"k": k.clone(), "v": v.clone()}
    want = paged_attention(q, full, bt, ln, chunk_lens=cl,
                           append=(kn, vn, ok))
    copies = [{"k": k.clone(), "v": v.clone()} for _ in range(TP)]
    outs = paged_attention([q] * TP, copies, bt, ln, chunk_lens=cl,
                           mesh=make_serving_mesh(TP, ["cpu"] * TP),
                           append=([kn] * TP, [vn] * TP, ok))
    for out, copy in zip(outs, copies):
        torch.testing.assert_close(out, want, atol=0, rtol=0)
        for n in ("k", "v"):
            assert torch.equal(copy[n], full[n])


@pytest.mark.parametrize("wl", list(WORKLOADS))
def test_heads_tp4_match_reference(reference, wl):
    """The engine at ``tensor_parallel=4`` serves Hq=6, Hkv=3 as the JAX
    engine at TP=4 does: tokens, counters, block tables and clock equal,
    the arena within 2e-2; each shard holds the whole attention weights
    and, after the run, a bitwise equal whole copy of the arena."""
    jc, tc = _configs()
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      init_decoder_lm(jc, jax.random.PRNGKey(SEED)))
    model = model_from_jax(tc, jax.tree.map(np.asarray, jp),
                           dtype=torch.float32, device="cpu")
    eng = PagedServingEngine(tc, model, tensor_parallel=TP,
                             devices=["cpu"] * TP, **WORKLOADS[wl])
    mine = _record(eng, _waves("olmo-1b", wl, tc.vocab))
    runs, arenas = reference
    ref = runs[wl]
    assert _min_margin_gqa(jc, jp, ref) > MARGIN_TOL
    assert mine["tokens"] == ref["tokens"]
    assert mine["stats"] == ref["stats"]
    assert mine["tables"] == ref["tables"]
    assert mine["clock"] == ref["clock"] == mine["stats"]["warnings_fired"]
    assert eng.kv_manager.kv_replicated
    for m in eng.params:
        for n in ("wq", "wk", "wv", "wo"):
            assert torch.equal(m.blocks[0].attn[n], model.blocks[0].attn[n])
    for n in ("k", "v"):
        copies = [kv[n] for kv in eng.kv]
        assert all(torch.equal(c, copies[0]) for c in copies[1:])
        assert copies[0].shape[3] == 3 and copies[0].abs().sum() > 0
        np.testing.assert_allclose(eng.kv_manager.gather_kv()[n].float()
                                   .numpy(), arenas[f"{wl}/{n}"],
                                   atol=2e-2, rtol=2e-2)
