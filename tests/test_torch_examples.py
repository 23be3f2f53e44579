"""The README's four examples over the port (``examples/*_torch.py``), run
on the CPU (``device="cpu"``) at ``tests/test_examples.py``'s tiny sizes
and held to the JAX examples on the same seeds.

- quickstart: the host layer's counters (``warnings_fired``,
  ``reader_restarts``, ``nodes_freed``) equal the JAX demo's printed ones;
  the serving demo, handed the JAX demo's own weights
  (``build_model(cfg).init(PRNGKey(0))``, carried across by
  ``repro_torch.convert.params_from_jax``, bf16 both sides), generates the
  JAX demo's tokens with its preemptions and prefix hits; the train demo
  runs on uniform random tokens (the JAX demo's data), its loss near
  ln V.  Its losses are not compared: the two packages' ``init`` draw
  different weights from the same seed.
- serve_paged: the port's CLI (``repro_torch.launch.serve.main``) with
  ``test_serve_paged_runs_tiny``'s flags and ``--device cpu`` commits the
  reference CLI's tokens and prefix hits; the example's four workloads run
  tiny, the two closed-loop ones equal to the reference CLI on the same
  flags.
- reclaim_demo: superblocks released and reads per strategy equal the
  same loop over ``repro.core`` at the same small size, and ``KEEP`` keeps
  its frames (within 90%, as ``tests/test_allocator.py::
  test_keep_strategy_retains_frames`` allows); the device pool's mapped
  and resident superblocks and mapped pages after the burst, the shrink
  and the next burst, its remaps and steps equal the JAX engine's on the
  same weights.
- train_lm: the loss falls through the injected failure, and the run
  restarts once, from a checkpoint.

The JAX quickstart and serve_paged are imported from ``examples/`` as
``tests/test_examples.py`` imports them; its reclaim_demo runs at import
at full size, so its loop is repeated here over ``repro.core``.
"""

import dataclasses
import pathlib
import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.core import (LRMalloc as JLRMalloc, MichaelHashTable as JTable,
                        OABit as JOABit, ReleaseStrategy as JStrategy)
from repro.models import build_model as jbuild
from repro.serving import PagedServingEngine as JaxEngine
from repro_torch.convert import params_from_jax

torch.set_num_threads(1)

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
TINY = ["--requests", "3", "--num-pages", "12", "--page-size", "4",
        "--max-batch", "2", "--prompt-len", "6", "--max-new", "3"]
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _examples_on_path(monkeypatch):
    monkeypatch.syspath_prepend(str(EXAMPLES))
    for mod in ("quickstart", "serve_paged", "quickstart_torch",
                "serve_paged_torch", "train_lm_torch", "reclaim_demo_torch"):
        sys.modules.pop(mod, None)


def _jax_params(cfg):
    """The JAX demos' weights, as numpy (bf16 leaves)."""
    return jax.tree.map(np.asarray, jbuild(cfg).init(jax.random.PRNGKey(0)))


def test_quickstart_host_layer_matches_reference(capsys):
    import quickstart
    import quickstart_torch

    quickstart.host_layer_demo(n_keys=50)
    line = capsys.readouterr().out
    ref = dict(zip(("warnings_fired", "reader_restarts", "nodes_freed"),
                   map(int, re.search(r"warnings=(\d+) restarts=(\d+) "
                                      r"freed=(\d+)", line).groups())))
    got = quickstart_torch.host_layer_demo(n_keys=50)
    assert {k: got[k] for k in ref} == ref
    assert ref["nodes_freed"] > 0


def test_quickstart_serving_matches_reference(monkeypatch):
    """The JAX demo's engines are recorded (a subclass patched in) to read
    their requests; the port's demo gets the same weights."""
    import quickstart
    import quickstart_torch

    made = []

    class Recording(JaxEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.reqs = []
            made.append(self)

        def submit(self, *a, **k):
            req = super().submit(*a, **k)
            self.reqs.append(req)
            return req

    monkeypatch.setattr(quickstart, "PagedServingEngine", Recording)
    quickstart.serving_demo(n_requests=2, max_new=2)
    jc = jreduced(jget("olmo-1b"))
    params = params_from_jax(jc, _jax_params(jc), device="cpu")
    mine = quickstart_torch.serving_demo(n_requests=2, max_new=2,
                                         params=params, device="cpu")
    for eng, reqs in zip(made, mine):
        assert [list(r.generated) for r in reqs] == \
            [list(r.generated) for r in eng.reqs]
    eng, eng2 = made
    assert mine[0][0]._engine.stats.preemptions == eng.stats.preemptions
    assert mine[1][0]._engine.stats.prefix_hits == eng2.stats.prefix_hits


def test_quickstart_train_runs():
    """The demo trains on the JAX demo's data source, uniform random
    tokens, which no model can learn: its loss stays within 0.1 of ln V
    (that a loss falls is held on train_lm's learnable ramp data).  Losses
    are not compared with the JAX demo's: the two ``init``s draw different
    weights from one seed (module docstring)."""
    import quickstart_torch

    out = quickstart_torch.train_demo(steps=12, device="cpu")
    assert [h["step"] for h in out["history"]] == [0, 10, 11]
    losses = np.array([h["loss"] for h in out["history"]])
    assert np.all(np.abs(losses - np.log(512)) < 0.1), losses


def test_serve_paged_cli_matches_reference():
    """``test_serve_paged_runs_tiny``'s two runs on both CLIs."""
    from repro.launch.serve import main as jmain
    from repro_torch.launch.serve import main

    for argv in (TINY, TINY + ["--prefix-cache", "--shared-prefix", "4"]):
        ref, got = jmain(argv), main(argv + CPU)
        assert got.tokens_committed == ref.tokens_committed > 0
        assert got.prefix_hits == ref.prefix_hits
    assert ref.prefix_hits > 0


def test_serve_paged_example_runs_tiny():
    """The example's four workloads at a tiny scale; the two closed-loop
    ones against the reference CLI on the same flags."""
    import serve_paged
    import serve_paged_torch
    from repro.launch.serve import main as jmain

    assert serve_paged_torch.BASE == serve_paged.BASE
    out = serve_paged_torch.demo(base=TINY, shared_pages=12,
                                 stream_requests=2, trace_s=0.5,
                                 device="cpu")
    for name, extra in (("no sharing", []),
                        ("prefix sharing", ["--prefix-cache",
                                            "--shared-prefix", "8",
                                            "--num-pages", "12"])):
        ref = jmain(TINY + extra)
        assert out[name].tokens_committed == ref.tokens_committed
        assert out[name].prefix_hits == ref.prefix_hits
    assert sum(cs.finished for cs in out["streaming"].class_stats.values()) \
        == 2
    assert out["trace replay"].tokens_committed > 0


def _reference_rows(n_keys, num_superblocks):
    """``examples/reclaim_demo.py``'s strategy loop over ``repro.core``."""
    rows = []
    for strategy in JStrategy:
        alloc = JLRMalloc(num_superblocks=num_superblocks,
                          superblock_size=64 * 1024, strategy=strategy)
        rec = JOABit(alloc, limbo_threshold=64)
        ht = JTable(rec, 256)
        ctx = rec.thread_ctx()
        for k in range(1, n_keys):
            ht.insert(k, ctx)
        for k in range(1, n_keys):
            ht.delete(k, ctx)
        rec.flush(ctx)
        alloc.flush_all_caches()
        probe = [alloc.read_u64(off) for off in range(16, 64 * 1024, 4096)]
        rows.append((strategy.value, alloc.stats.persistent_released,
                     len(probe)))
        alloc.close()
    return rows


def test_reclaim_demo_strategies_match_reference():
    import reclaim_demo_torch

    rows = reclaim_demo_torch.strategy_rows(n_keys=2000, num_superblocks=64)
    assert [(r[0], r[3], r[4]) for r in rows] == _reference_rows(2000, 64)
    keep = next(r for r in rows if r[0] == "keep")
    assert keep[2] >= keep[1] * 0.9
    assert all(r[3] > 0 for r in rows)


def _reference_pool(cfg, params):
    """``examples/reclaim_demo.py``'s device-pool story on the JAX engine:
    (mapped superblocks, resident superblocks, mapped pages) after the
    burst, the shrink and the next burst, the remaps and the steps."""
    eng = JaxEngine(cfg, params, num_pages=32, page_size=2, max_batch=4,
                    max_pages_per_seq=8, pages_per_superblock=4,
                    release_strategy=JStrategy.MADVISE,
                    min_mapped_superblocks=1)
    out = {}

    def state(name):
        s = eng.stats
        out[name] = (s.superblocks_mapped, s.superblocks_resident,
                     s.mapped_pages)
        return s
    for prompt in ([1, 2, 3], [4, 5], [6, 7, 8], [9, 10]):
        eng.submit(prompt, 8)
    eng.run()
    state("after burst")
    eng.shrink()
    state("after shrink")
    eng.submit([11, 12, 13], 8)
    eng.run()
    s = state("next burst")
    out["remapped"], out["steps"] = s.superblocks_remapped, s.steps
    return out


def test_reclaim_demo_device_pool_matches_reference():
    import reclaim_demo_torch

    jc = dataclasses.replace(jreduced(jget("olmo-1b")), n_layers=1)
    jp = _jax_params(jc)
    got = reclaim_demo_torch.device_pool_demo(
        params=params_from_jax(jc, jp, device="cpu"), device="cpu")
    assert got == _reference_pool(jc, jax.tree.map(jax.numpy.asarray, jp))
    assert got["after shrink"][0] < got["after burst"][0]
    assert got["remapped"] > 0


def test_train_lm_loss_falls_through_restart(tmp_path):
    import train_lm_torch

    out = train_lm_torch.run(steps=8, ckpt_dir=str(tmp_path), device="cpu",
                             batch=2, seq=32, ckpt_every=2, log_every=1)
    steps = [h["step"] for h in out["history"]]
    assert out["restarts"] == 1
    # the restart resumed from the checkpoint saved after step 2, not step 0
    assert steps.count(3) == 2 and steps.count(0) == 1
    assert out["final_loss"] < out["history"][0]["loss"]
