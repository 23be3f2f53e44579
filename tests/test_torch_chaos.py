"""The port's chaos layer against the JAX package's, on the CPU.

- ``ChaosAllocator``: one seeded op sequence (alloc, free, share,
  snapshot, release, map, flush) through both packages' chaos-wrapped
  pools gives the same results, the same fault counts and the same pool
  state after every op, exactly (versions and the clock compared as
  ``np.uint32``); a perturbed snapshot of a page at version ``0xFFFFFFFF``
  wraps to 0 in both.
- The chaos engine: the port's ``PagedServingEngine(chaos=...)`` against
  the JAX engine under ``tests/test_chaos.py``'s single-engine schedules
  (grant denials; spurious invalidations; delayed frees with
  unmap-under-reader): tokens, fault counts, every integer counter and the
  clock exactly equal, and tokens equal to a fault-free run.  Weights are
  float32 on both sides; the workloads' top-1/top-2 logit margins must
  stay above ``MARGIN_TOL`` (``tests/test_torch_engine.py`` says why).
- One device→host read per steady step under an aggressive chaos
  schedule, counted as ``tests/test_torch_engine.py`` counts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.core import ChaosAllocator as JChaos, ChaosConfig as JConfig
from repro.core.pagepool import DevicePagePool as JPool
from repro.models.transformer import init_decoder_lm
from repro.serving import PagedServingEngine as JaxEngine
from repro_torch.configs import get_config as tget, reduced as treduced
from repro_torch.convert import model_from_jax
from repro_torch.core import Allocator, ChaosAllocator, ChaosConfig
from repro_torch.core.pagepool import DevicePagePool
from repro_torch.serving import PagedServingEngine
from test_torch_engine import MARGIN_TOL, READS, _int_stats, _min_margin
from test_torch_pagepool import assert_same

torch.set_num_threads(1)

ENGINE_KW = dict(num_pages=32, page_size=4, max_batch=2, max_pages_per_seq=8)
PROMPTS = [[5, 9, 13], [7, 11], [3, 4, 5, 6], [2, 8]]
# tests/test_chaos.py's single-engine schedules
SCHEDULES = {
    "grant_denials": (dict(seed=3, grant_denial_p=0.3), {}),
    "spurious_invalid": (dict(seed=5, spurious_invalid_p=0.4),
                         dict(reclaim_policy="oa-validate")),
    "delayed_free_unmap": (dict(seed=11, delayed_free_p=0.6, delay_ops=2,
                                unmap_under_reader_p=0.5), {}),
}
FAULTS = {"grant_denials": "grant_denial",
          "spurious_invalid": "spurious_invalid",
          "delayed_free_unmap": "delayed_free"}


@pytest.fixture(scope="module")
def weights():
    jc = dataclasses.replace(jreduced(jget("olmo-1b")), n_layers=1)
    tc = dataclasses.replace(treduced(tget("olmo-1b")), n_layers=1)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      init_decoder_lm(jc, jax.random.PRNGKey(0)))
    tm = model_from_jax(tc, jax.tree.map(np.asarray, jp), dtype=torch.float32,
                        device="cpu")
    return jc, jp, tc, tm


# ---------------------------------------------------------------------------
# the chaos allocator itself


def _u32(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x
                      ).astype(np.uint32)


@pytest.mark.parametrize("seed", range(3))
def test_fault_schedule_matches_reference(seed):
    """One op sequence, both packages: every result, the fault counts, the
    host mirrors and the whole pool state equal after every op."""
    kw = dict(seed=seed, grant_denial_p=0.25, spurious_invalid_p=0.3,
              delayed_free_p=0.3, delay_ops=2, unmap_under_reader_p=0.4)
    j = JChaos(JPool(24, 4), JConfig(**kw))
    t = ChaosAllocator(DevicePagePool(24, 4, device="cpu"), ChaosConfig(**kw))
    assert isinstance(t, Allocator)
    rng = np.random.default_rng(100 + seed)
    held: list[int] = []  # one entry per reference the caller owns
    for _ in range(100):
        op = rng.choice(["alloc", "free", "share", "snapshot", "release",
                         "map"], p=[.3, .25, .1, .2, .05, .1])
        if op == "alloc":
            n = int(rng.integers(1, 5))
            got = (j.alloc(n), t.alloc(n))
            assert got[1] == (list(map(int, got[0][0])), bool(got[0][1]))
            held += got[1][0]
        elif op == "free" and held:
            k = min(len(held), int(rng.integers(1, 3)))
            pick = sorted(rng.choice(len(held), k, replace=False).tolist(),
                          reverse=True)
            units = [held.pop(i) for i in pick]
            j.free(units)
            t.free(units)
        elif op == "share" and held:
            units = [held[int(rng.integers(len(held)))]]
            assert j.share(units) == t.share(units) is True
            held += units
        elif op == "snapshot":
            units = [held[int(i)] if held and i < len(held) else -1
                     for i in rng.integers(0, len(held) + 2, 5)]
            np.testing.assert_array_equal(_u32(t.snapshot(units)),
                                          _u32(j.snapshot(units)))
        elif op == "release":
            assert tuple(t.release(0)) == tuple(map(int, j.release(0)))
        elif op == "map":
            n = int(rng.integers(1, 3))
            assert tuple(t.map(n)) == tuple(map(int, j.map(n)))
        assert t.faults == j.faults
        assert dataclasses.astuple(t.view()) == dataclasses.astuple(j.view())
        assert_same(j.state, t.state)
    j.flush()
    t.flush()
    assert_same(j.state, t.state)
    assert all(v > 0 for v in t.faults.values()), t.faults


def test_perturbed_snapshot_wraps_at_u32_max():
    """A spurious invalidation of a page at version 0xFFFFFFFF wraps it to
    0, as the reference's uint32 add does; −1 entries stay 0."""
    j = JChaos(JPool(8, 4), JConfig(seed=0, spurious_invalid_p=1.0))
    t = ChaosAllocator(DevicePagePool(8, 4, device="cpu"),
                       ChaosConfig(seed=0, spurious_invalid_p=1.0))
    j.inner.state = j.inner.state._replace(
        page_version=j.inner.state.page_version.at[0].set(0xFFFFFFFF))
    t.inner.state = t.inner.state._replace(
        page_version=t.inner.state.page_version.index_fill(0, torch.tensor(
            [0]), 0xFFFFFFFF))
    units = [0, -1, 3]
    got, want = t.snapshot(units), j.snapshot(units)
    np.testing.assert_array_equal(_u32(got), _u32(want))
    np.testing.assert_array_equal(_u32(got), [0, 0, 1])
    assert t.faults["spurious_invalid"] == j.faults["spurious_invalid"] == 1


def test_zero_probability_is_transparent():
    """At p = 0 the wrapper forwards: attributes, the state pass-through
    and a no-op flush."""
    t = ChaosAllocator(DevicePagePool(16, 4, device="cpu"),
                       ChaosConfig(seed=1))
    assert t.num_pages == 16 and t.pages_per_superblock == 4
    ids, ok = t.alloc(3)
    assert ok and len(ids) == 3
    t.free(ids)
    t.flush()
    assert t.state is t.inner.state
    assert not any(t.faults.values())


# ---------------------------------------------------------------------------
# the engine under injected faults


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_chaos_engine_matches_reference(weights, name):
    jc, jp, tc, tm = weights
    chaos, extra = SCHEDULES[name]
    jeng = JaxEngine(jc, jp, chaos=JConfig(**chaos), **ENGINE_KW, **extra)
    teng = PagedServingEngine(tc, tm, chaos=ChaosConfig(**chaos),
                              device="cpu", **ENGINE_KW, **extra)
    base = PagedServingEngine(tc, tm, device="cpu", **ENGINE_KW, **extra)
    jreqs = [jeng.submit(p, 5) for p in PROMPTS]
    treqs = [teng.submit(p, 5) for p in PROMPTS]
    breqs = [base.submit(p, 5) for p in PROMPTS]
    jst, tst = jeng.run(), teng.run()
    base.run()
    assert all(r.state == "finished" for r in jreqs + treqs + breqs)
    assert _min_margin(jc, jp, jreqs) > MARGIN_TOL
    tokens = [r.generated for r in treqs]
    assert tokens == [r.generated for r in jreqs]
    assert tokens == [r.generated for r in breqs]  # faults change no token
    faults = teng.kv_manager.allocator.faults
    assert faults == jeng.kv_manager.allocator.faults
    assert faults[FAULTS[name]] > 0
    assert _int_stats(tst) == _int_stats(jst)
    assert int(teng.pool.clock) == int(jeng.pool.clock)
    # frees still deferred at drain end land on flush (the default policy's
    # flush does not reach the chaos layer, in both packages); then the
    # host mirror meets the pool's clock
    for eng in (teng, jeng):
        eng.kv_manager.allocator.flush()
    assert tst.warnings_fired == int(teng.pool.clock) == int(jeng.pool.clock)
    if name == "grant_denials":
        assert tst.grant_denials > 0 and tst.grant_retries > 0
    if name == "spurious_invalid":
        assert tst.reader_restarts > 0


def test_spontaneous_releases_tick_the_clock_behind_the_mirror(weights):
    """Every free followed by a release of the EMPTY superblocks: the
    releases tick the pool's clock outside the engine's mirror, in both
    packages alike; ``unmap_clock_ticks`` counts them, so the mirror plus
    those ticks is the clock.  Tokens stay the fault-free ones."""
    jc, jp, tc, tm = weights
    chaos = dict(seed=4, unmap_under_reader_p=1.0)
    kw = dict(ENGINE_KW, pages_per_superblock=4)
    jeng = JaxEngine(jc, jp, chaos=JConfig(**chaos), **kw)
    teng = PagedServingEngine(tc, tm, chaos=ChaosConfig(**chaos),
                              device="cpu", **kw)
    jreqs = [jeng.submit(p, 5) for p in PROMPTS]
    treqs = [teng.submit(p, 5) for p in PROMPTS]
    jst, tst = jeng.run(), teng.run()
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert _int_stats(tst) == _int_stats(jst)
    ticks = teng.kv_manager.allocator.unmap_clock_ticks
    assert ticks > 0
    assert tst.warnings_fired + ticks == int(teng.pool.clock) == \
        int(jeng.pool.clock)


def test_fleet_chaos_seeds_offset_per_replica(weights):
    """A fleet's shared chaos config reaches replica i with seed + i, as in
    the reference (independent, reproducible schedules)."""
    from repro_torch.serving import DataParallelEngine

    _, _, tc, tm = weights
    fleet = DataParallelEngine(tc, tm, replicas=3, devices=["cpu"] * 3,
                               chaos=ChaosConfig(seed=7, grant_denial_p=0.1),
                               **ENGINE_KW)
    seeds = [e.kv_manager.allocator.config.seed for e in fleet.replicas]
    assert seeds == [7, 8, 9]


def test_steady_steps_stay_sync_free_under_chaos(weights, monkeypatch):
    """Faults land only at the allowed sync points: a window of steady
    steps under an aggressive schedule makes one read per step."""
    _, _, tc, tm = weights
    eng = PagedServingEngine(
        tc, tm, device="cpu", num_pages=64, page_size=4, max_batch=2,
        max_pages_per_seq=16, chaos=ChaosConfig(
            seed=2, grant_denial_p=0.3, spurious_invalid_p=0.3,
            delayed_free_p=0.3))
    for i in range(3):
        eng.submit([1 + i, 2 + i, 3 + i], 30)
    for _ in range(4):  # admit and settle (restarts may re-admit)
        eng.scheduler.admit()
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
    nsteps = 6
    for _ in range(nsteps):
        eng.step()  # no admissions inside the window: steady steps only
    monkeypatch.undo()
    assert eng.running
    assert count["n"] == nsteps, f"{count['n']} reads in {nsteps} steps"
