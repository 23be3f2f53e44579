"""The port's PagedServingEngine against the JAX one, end to end on the CPU.

Parity: both engines get the same float32 weights and the same requests;
generated tokens and every integer counter of ``EngineStats`` (steps,
preemptions, grants, COW copies, validation passes, ``warnings_fired`` …)
must be equal, and ``warnings_fired`` must equal the pool's clock.  Both
engines keep a bf16 KV arena (the JAX engine always does), so K/V differ
only by float32 summation order before the same rounding to bf16.  Greedy
tokens are then equal wherever the reference's top-1/top-2 logit margin
is wide; each workload checks its margins stay above ``MARGIN_TOL`` (1e-3,
orders above the ~1e-6 relative float32 noise a flipped bf16 rounding of
one K/V element can add to a logit here).

Also: one device→host read per steady step (the tensor read methods are
counted), and an AST drift check that each module the port copies equals
its JAX original apart from its import lines (and ``Request.pages``).
"""

import ast
import dataclasses
import pathlib
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


@pytest.fixture(scope="module")
def weights():
    jc = jreduced(jget("olmo-1b"))
    tc = treduced(tget("olmo-1b"))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      init_decoder_lm(jc, jax.random.PRNGKey(7)))
    tm = model_from_jax(tc, jax.tree.map(np.asarray, jp), dtype=torch.float32,
                        device="cpu")
    return jc, jp, tc, tm


def _min_margin(jc, jp, reqs):
    """Smallest top-1/top-2 logit gap of the reference's dense float32
    forward over every position that produced a generated token."""
    worst = np.inf
    for r in reqs:
        seq = r.prompt + r.generated
        x, _ = decoder_forward(jc, jp, {"tokens": jnp.asarray([seq])})
        logits = np.asarray(unembed(jc, jp, x)[0], np.float32)
        for pos in range(len(r.prompt) - 1, len(seq) - 1):
            top = np.sort(logits[pos])[-2:]
            worst = min(worst, float(top[1] - top[0]))
    return worst


def _int_stats(stats):
    return {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats)
            if f.type in ("int", int)}


def _phases(name, vocab):
    """Each workload's requests, as phases of (prompts, max_new_tokens) run
    to completion one after another on the same engine."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))

    def prompts(n, lo, hi):
        return [rng.integers(0, vocab, int(k)).tolist()
                for k in rng.integers(lo, hi + 1, n)]
    if name == "prefix_cache":
        # a 10-token prompt finishes first (its committed tail page is
        # cached), then identical and extended prompts hit the cache: the
        # tail match is granted copy-on-write
        p = prompts(1, 10, 10)[0]
        return [([p], 1), ([p, p] + [p + t for t in prompts(3, 1, 5)], 6)]
    n, lo, hi, max_new = {"decode": (5, 3, 9, 8),
                          "chunked_tight_pool": (5, 3, 14, 6),
                          "speculative": (4, 3, 9, 10)}.get(name, (5, 3, 9, 6))
    return [(prompts(n, lo, hi), max_new)]


WORKLOADS = {
    "decode": dict(num_pages=32, page_size=4, max_batch=3),
    "chunked_tight_pool": dict(num_pages=8, page_size=4, max_batch=3,
                               prefill_chunk=8),
    "prefix_cache": dict(num_pages=24, page_size=4, max_batch=3,
                         prefix_cache=True),
    "speculative": dict(num_pages=32, page_size=4, max_batch=3,
                        speculative_k=4),
    "epoch_grace": dict(num_pages=12, page_size=4, max_batch=3,
                        reclaim_policy="epoch-grace"),
    "interval": dict(num_pages=12, page_size=4, max_batch=3,
                     reclaim_policy="interval"),
}


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_engine_matches_reference(weights, name):
    jc, jp, tc, tm = weights
    kw = WORKLOADS[name]
    jeng = JaxEngine(jc, jp, **kw)
    teng = PagedServingEngine(tc, tm, device="cpu", **kw)
    jreqs, treqs = [], []
    for prompts, max_new in _phases(name, jc.vocab):
        jreqs += [jeng.submit(p, max_new) for p in prompts]
        treqs += [teng.submit(p, max_new) for p in prompts]
        jst, tst = jeng.run(), teng.run()
    assert all(r.state == "finished" for r in jreqs + treqs)
    assert _min_margin(jc, jp, jreqs) > MARGIN_TOL, \
        "workload too close to a tie for a bf16-arena parity check"
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert _int_stats(tst) == _int_stats(jst)
    assert tst.warnings_fired == int(teng.pool.clock) == int(jeng.pool.clock)
    if name == "chunked_tight_pool":
        assert tst.preemptions > 0  # the pool really churned
    if name == "prefix_cache":
        assert tst.prefix_hits > 0 and tst.cow_copies > 0
    if name == "speculative":
        assert tst.tokens_accepted > 0
    if name == "epoch_grace":
        assert tst.validation_skipped > 0
    if name == "interval":
        assert tst.validation_passes == 0


READS = ("cpu", "item", "tolist", "__bool__", "__int__", "__float__",
         "__index__", "__array__")


def _steady_reads(eng, monkeypatch, nsteps=6):
    """Reads of tensor values across ``nsteps`` steady steps of ``eng``
    (two requests admitted and three steps taken first)."""
    eng.submit([1, 2, 3, 4], 14)
    eng.submit([2, 3, 4, 5], 14)
    eng.scheduler.admit()
    for _ in range(3):
        eng.step()
    count = {"n": 0}

    def wrap(fn):
        def counted(*a, **k):
            count["n"] += 1
            return fn(*a, **k)
        return counted

    for name in READS:
        monkeypatch.setattr(torch.Tensor, name, wrap(getattr(torch.Tensor,
                                                             name)))
    for _ in range(nsteps):  # crosses a page boundary: growth included
        eng.step()
    monkeypatch.undo()
    assert all(len(r.generated) < 14 for r in eng.running)
    return count["n"]


def test_steady_step_makes_one_read(weights, monkeypatch):
    """Every tensor read method is counted across steady decode steps (no
    admission, no finish): the runner's single packed ``.cpu()`` must be the
    only one.  (``numpy()`` is not counted: it cannot read a CUDA tensor;
    nor is ``nonzero``, which only the CPU-only plain KV append calls — on
    the card the append is a kernel, and ``chip_smoke.py`` counts every
    synchronising CUDA call of a steady step there.)"""
    _, _, tc, tm = weights
    eng = PagedServingEngine(tc, tm, num_pages=32, page_size=4, max_batch=2,
                             max_pages_per_seq=8, device="cpu")
    assert _steady_reads(eng, monkeypatch, 6) == 6


def test_steady_step_makes_one_read_under_tensor_parallelism(weights,
                                                             monkeypatch):
    """The same count at ``tensor_parallel=2``: the shards' work adds no
    read — the pool, selection and results stay on the lead device."""
    _, _, tc, tm = weights
    eng = PagedServingEngine(tc, tm, num_pages=32, page_size=4, max_batch=2,
                             max_pages_per_seq=8, tensor_parallel=2,
                             devices=["cpu", "cpu"])
    assert _steady_reads(eng, monkeypatch, 6) == 6


# ---------------------------------------------------------------------------
# drift: the port's copies of host-only modules equal their originals


COPIES = ([f"configs/{p.name}" for p in
           sorted((REPO / "src/repro/configs").glob("*.py"))
           if p.name not in ("__init__.py", "base.py")]
          + ["core/allocator.py", "core/reclaim_policy.py", "serving/stats.py",
             "serving/draft.py", "serving/overload.py", "serving/scheduler.py"])


class _StripImports(ast.NodeTransformer):
    def visit_Import(self, node):
        return None

    def visit_ImportFrom(self, node):
        return None

    def visit_ClassDef(self, node):
        # the one named exception: Request.pages reads a CPU or CUDA table
        if node.name == "Request":
            node.body = [b for b in node.body
                         if not (isinstance(b, ast.FunctionDef)
                                 and b.name == "pages")]
        return self.generic_visit(node)


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_has_not_drifted(rel):
    trees = [ast.dump(_StripImports().visit(ast.parse(
        (REPO / "src" / pkg / rel).read_text())))
        for pkg in ("repro", "repro_torch")]
    assert trees[0] == trees[1], f"{rel} drifted from its JAX original"
