"""The port's data-parallel fleet against the JAX package's, on the CPU.

The port's replicas are ``devices=["cpu"] * n`` (the reference's replicas
share its one CPU device); weights are float32 on both sides, and the
workloads' top-1/top-2 logit margins stay above ``MARGIN_TOL``
(``tests/test_torch_engine.py`` says why).

- ``step()`` mode: routing (prefix affinity, then pressure), tokens, each
  replica's integer counters and clock, and the aggregated counters equal
  the JAX fleet's exactly; one read per replica per step.
- threaded ``run()``: the same, replica by replica.
- failover (``tests/test_chaos.py``'s cases): a killed replica's requests
  migrate and the stitched outputs equal the JAX single engine's; a stall
  trips the heartbeat; ``auto_revive`` rebuilds the slot; without a
  watchdog the error propagates; with no survivor it is raised.
- the 2D replica × tensor fleet (``replicas=2, tensor_parallel=2`` over
  ``["cpu"] * 4``) against the reference's on four forced host devices,
  run in a subprocess and handed over as an ``.npz``.
- page conservation per pool after seeded random interleavings of submit,
  step and preempt over 2–4 replicas, and the same tokens and clocks as
  the JAX fleet on the same ops (the reference's own property test never
  runs here: hypothesis refuses its defaulted parameters).
- the kernel modules' thread safety: one build per cold library, no lost
  launch count, one ticket buffer per stream.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.models.transformer import init_decoder_lm
from repro.serving import (DataParallelEngine as JFleet,
                           PagedServingEngine as JaxEngine)
from repro_torch.configs import get_config as tget, reduced as treduced
from repro_torch.convert import model_from_jax
from repro_torch.core.vm import superblock_floor
from repro_torch.serving import (DataParallelEngine, ReplicaStalled,
                                 WatchdogConfig)
from test_torch_engine import MARGIN_TOL, READS, _int_stats, _min_margin

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
KW = dict(num_pages=32, page_size=4, max_batch=2, max_pages_per_seq=8)
SYS = list(range(40, 48))
PROMPTS = [[5, 9, 13], [7, 11], [3, 4, 5, 6], [2, 8], [17, 23, 29], [6, 10]]


@pytest.fixture(scope="module")
def weights():
    jc = dataclasses.replace(jreduced(jget("olmo-1b")), n_layers=1)
    tc = dataclasses.replace(treduced(tget("olmo-1b")), n_layers=1)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      init_decoder_lm(jc, jax.random.PRNGKey(0)))
    tm = model_from_jax(tc, jax.tree.map(np.asarray, jp), dtype=torch.float32,
                        device="cpu")
    return jc, jp, tc, tm


def _fleets(weights, n, **kw):
    jc, jp, tc, tm = weights
    kw = {**KW, **kw}
    return (JFleet(jc, jp, replicas=n, **kw),
            DataParallelEngine(tc, tm, replicas=n, devices=["cpu"] * n, **kw))


def _state(fleet, reqs):
    """What must agree across packages: per request its replica and
    tokens; per replica its integer counters and clock; the aggregate's
    integer counters."""
    return dict(
        routes=[fleet.replicas.index(r._engine) for r in reqs],
        tokens=[r.output_tokens for r in reqs],
        replicas=[(_int_stats(e.stats), int(e.pool.clock))
                  for e in fleet.replicas],
        total=_int_stats(fleet.stats))


def _drain(fleet, limit=500):
    for _ in range(limit):
        if fleet.drained():
            return
        fleet.step()
    raise AssertionError("fleet did not drain")


def _conservation(fleet):
    """Per pool: free pages + distinct live pages == mapped pages; no page
    twice in a pool; every block-table page live in its own pool."""
    for e in fleet.replicas:
        free = int(e.pool.free_top)
        distinct = e.scheduler.distinct_pages_in_use()
        assert free == e.kv_manager.mapped_pages - distinct, \
            f"conservation broke: free={free} " \
            f"mapped={e.kv_manager.mapped_pages} live={distinct}"
        live = [p for r in e.running for p in r.pages]
        assert len(live) == len(set(live)), "page double-mapped in a pool"
        rc = e.pool.page_refcount.numpy()
        for r in e.running:
            assert r._engine is e, "request migrated across pools"
            for p in r.pages:
                assert 0 <= p < e.num_pages and rc[p] > 0


# ---------------------------------------------------------------------------
# routing and the two drive modes against the reference


def test_fleet_steps_match_reference(weights):
    """Two waves through ``step()``: the second hits replica 0's cached
    system prompt (affinity beats pressure), the rest spread by load."""
    jf, tf = _fleets(weights, 2, prefix_cache=True)
    waves = [([SYS + [101, 201], [300, 301, 302], [5, 9, 13], [7, 11]], 4),
             ([SYS + [102, 202], [300, 301, 302, 303], [3, 4, 5, 6],
               SYS + [103]], 5)]
    jreqs, treqs = [], []
    for prompts, max_new in waves:
        jreqs += [jf.submit(p, max_new) for p in prompts]
        treqs += [tf.submit(p, max_new) for p in prompts]
        _drain(jf)
        _drain(tf)
        _conservation(tf)
    assert all(r.state == "finished" for r in jreqs + treqs)
    assert _min_margin(weights[0], weights[1], jreqs) > MARGIN_TOL
    got, want = _state(tf, treqs), _state(jf, jreqs)
    assert got == want
    assert got["routes"][4] == 0 and treqs[4].prefix_reused >= len(SYS)
    assert set(got["routes"]) == {0, 1}
    for e in tf.replicas:
        assert e.stats.warnings_fired == int(e.pool.clock)


def test_threaded_run_matches_reference(weights):
    jf, tf = _fleets(weights, 2)
    jreqs = [jf.submit(p, 6) for p in PROMPTS]
    treqs = [tf.submit(p, 6) for p in PROMPTS]
    jf.run()
    stats = tf.run()
    assert all(r.state == "finished" for r in jreqs + treqs)
    assert _min_margin(weights[0], weights[1], jreqs) > MARGIN_TOL
    assert _state(tf, treqs) == _state(jf, jreqs)
    assert stats.tokens_committed == sum(e.stats.tokens_committed
                                         for e in tf.replicas)
    assert stats.wall_seconds > 0
    for e in tf.replicas:
        assert e.stats.warnings_fired == int(e.pool.clock)
    _conservation(tf)


def test_fleet_steps_make_one_read_per_replica(weights, monkeypatch):
    _, tf = _fleets(weights, 2, num_pages=64, max_pages_per_seq=10)
    for i in range(4):
        tf.submit([1 + i, 2 + i, 3 + i], 20)
    for _ in range(4):
        tf.step()
    count = {"n": 0}

    def wrap(fn):
        def counted(*a, **k):
            count["n"] += 1
            return fn(*a, **k)
        return counted

    for name in READS:
        monkeypatch.setattr(torch.Tensor, name, wrap(getattr(torch.Tensor,
                                                             name)))
    # steady steps only: admission is empty, so step() admits nothing
    for _ in range(4):
        tf.step()
    monkeypatch.undo()
    assert all(len(e.running) == 2 for e in tf.replicas)
    assert count["n"] == 4 * 2


def test_per_replica_release_floor_matches_single_pool(weights):
    _, tf = _fleets(weights, 2, pages_per_superblock=4)
    for i in range(4):
        tf.submit([5 + i, 9, 13], 4)
    tf.run()
    tf.shrink()
    for e in tf.replicas:
        floor = superblock_floor(e.scheduler.distinct_pages_in_use(),
                                 e.pages_per_superblock, 1)
        assert e.kv_manager.allocator.superblocks_mapped == floor
        assert e.stats.superblocks_mapped == floor


def test_devices_default_to_cuda_and_never_fall_back(weights, monkeypatch):
    _, _, tc, tm = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataParallelEngine(tc, tm, replicas=2, **KW)
    with pytest.raises(RuntimeError, match="devices"):
        DataParallelEngine(tc, tm, replicas=2, tensor_parallel=2,
                           devices=["cpu"] * 3, **KW)


# ---------------------------------------------------------------------------
# failover, watchdog, revival (tests/test_chaos.py's cases)


class _Kill(RuntimeError):
    pass


def _kill_after(n):
    """A step hook that raises on its ``n``-th invocation, once."""
    state = {"calls": 0}

    def hook(_eng):
        state["calls"] += 1
        if state["calls"] == n:
            raise _Kill(f"injected kill at driver iteration {n}")
    return hook


@pytest.fixture(scope="module")
def oracle(weights):
    """The JAX engine's fault-free outputs, one fresh engine per prompt."""
    jc, jp = weights[:2]
    out = []
    for p in PROMPTS:
        e = JaxEngine(jc, jp, **KW)
        r = e.submit(p, 8)
        e.run()
        out.append(r.generated)
    return out


def test_replica_kill_fails_over_token_exact(weights, oracle):
    _, tf = _fleets(weights, 2, watchdog=WatchdogConfig(stall_timeout=30.0))
    rs = [tf.submit(p, 8) for p in PROMPTS]
    victims = [r for r in rs if r._engine is tf.replicas[0]]
    assert victims
    tf.step_hooks[0] = _kill_after(3)
    tf.run()
    assert all(r.state == "finished" for r in rs)
    assert [r.output_tokens for r in rs] == oracle
    assert not tf.alive[0]
    assert tf.stats.replica_failures == 1
    assert tf.stats.requests_migrated >= len(victims)
    assert any(r.migrations == 1 for r in victims)


def test_stalled_replica_is_detected_by_heartbeat(weights):
    _, tf = _fleets(weights, 2, watchdog=WatchdogConfig(
        stall_timeout=2.0, poll_interval=0.02))
    warm = [tf.submit(p, 2) for p in PROMPTS[:2]]
    tf.run()  # warm first: a cold first step is no stall
    assert all(r.state == "finished" for r in warm)
    rs = [tf.submit(p, 6) for p in PROMPTS[:4]]
    wedge = threading.Event()  # never set: the hook hangs forever

    def hook(_eng):
        wedge.wait()
    tf.step_hooks[0] = hook
    tf.run()
    assert all(r.state == "finished" for r in rs)
    assert not tf.alive[0]
    assert tf.stats.replica_failures == 1


def test_revived_replica_rejoins_the_fleet(weights, oracle):
    _, tf = _fleets(weights, 2, watchdog=WatchdogConfig(
        stall_timeout=30.0, auto_revive=True))
    old = tf.replicas[0]
    rs = [tf.submit(p, 8) for p in PROMPTS]
    tf.step_hooks[0] = _kill_after(2)
    tf.run()
    assert all(r.state == "finished" for r in rs)
    assert [r.output_tokens for r in rs] == oracle
    assert tf.alive[0] and tf.replicas[0] is not old
    assert tf.replicas[0].params is old.params  # weights shared, not copied
    assert tf.replicas[0].pool is not old.pool
    assert tf.stats.replica_failures == 1 and tf.stats.replica_revivals == 1
    r = tf.submit([41, 42, 43], 3)
    tf.run()
    assert r.state == "finished"


def test_worker_exception_propagates_without_watchdog(weights):
    _, tf = _fleets(weights, 2)
    for p in PROMPTS[:4]:
        tf.submit(p, 6)
    tf.step_hooks[0] = _kill_after(2)
    with pytest.raises(_Kill):
        tf.run()


def test_single_replica_failure_with_no_survivor_raises(weights):
    _, tf = _fleets(weights, 1, watchdog=WatchdogConfig())
    tf.submit([5, 9, 13], 4)
    tf.step_hooks[0] = _kill_after(1)
    with pytest.raises(_Kill):
        tf.run()
    assert ReplicaStalled.__mro__[1] is RuntimeError


# ---------------------------------------------------------------------------
# the 2D replica x tensor fleet against the reference's


_FLEET_PROG = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduced
from repro.models.transformer import init_decoder_lm
from repro.serving import DataParallelEngine

CFG = reduced(get_config("olmo-1b"))
params = jax.tree.map(lambda a: a.astype(jnp.float32),
                      init_decoder_lm(CFG, jax.random.PRNGKey(0)))
fleet = DataParallelEngine(CFG, params, replicas=2, tensor_parallel=2,
                           **FLEET_KW)
rng = np.random.default_rng(1)
reqs = [fleet.submit(list(map(int, rng.integers(1, 500, 5))), 6)
        for _ in range(8)]
fleet.run()
assert all(r.state == "finished" for r in reqs)
meshes = [e.mesh for e in fleet.replicas]
assert not (set(d.id for d in meshes[0].devices.flat)
            & set(d.id for d in meshes[1].devices.flat))
np.savez(sys.argv[1],
         tokens=np.asarray([r.generated for r in reqs]),
         routes=np.asarray([fleet.replicas.index(r._engine) for r in reqs]),
         counters=np.asarray([[e.stats.steps, e.stats.tokens_committed,
                               e.stats.prefix_hits, e.stats.warnings_fired,
                               int(e.pool.clock)] for e in fleet.replicas]))
"""
FLEET_KW = dict(num_pages=32, page_size=2, max_batch=4, prefix_cache=True)


@pytest.fixture(scope="module")
def fleet_reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("fleet_reference") / "ref.npz"
    prog = f"FLEET_KW = {FLEET_KW!r}\n" + _FLEET_PROG
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", prog, str(path)],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(path))


def test_2d_fleet_matches_reference(fleet_reference):
    jc = jreduced(jget("olmo-1b"))
    tc = treduced(tget("olmo-1b"))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      init_decoder_lm(jc, jax.random.PRNGKey(0)))
    tm = model_from_jax(tc, jax.tree.map(np.asarray, jp), dtype=torch.float32,
                        device="cpu")
    devices = ["cpu"] * 4
    fleet = DataParallelEngine(tc, tm, replicas=2, tensor_parallel=2,
                               devices=devices, **FLEET_KW)
    assert [fleet._placement_for(i) for i in range(2)] == [
        {"tensor_parallel": 2, "devices": devices[:2]},
        {"tensor_parallel": 2, "devices": devices[2:]}]
    assert all(e.mesh.tp == 2 and len(e.kv) == 2 for e in fleet.replicas)
    rng = np.random.default_rng(1)
    reqs = [fleet.submit(list(map(int, rng.integers(1, 500, 5))), 6)
            for _ in range(8)]
    fleet.run()
    assert all(r.state == "finished" for r in reqs)
    assert [r.generated for r in reqs] == fleet_reference["tokens"].tolist()
    assert [fleet.replicas.index(r._engine) for r in reqs] == \
        fleet_reference["routes"].tolist()
    assert [[e.stats.steps, e.stats.tokens_committed, e.stats.prefix_hits,
             e.stats.warnings_fired, int(e.pool.clock)]
            for e in fleet.replicas] == fleet_reference["counters"].tolist()


# ---------------------------------------------------------------------------
# page conservation under random interleavings


@pytest.mark.parametrize("seed", range(6))
def test_random_interleavings_conserve_pages_per_pool(weights, seed):
    """Seeded submit/step/preempt interleavings over 2–4 replicas (the
    reference's property, with its op alphabet): after every step and
    preemption each pool balances; drained, every request finished, each
    pool releases to the single-pool floor, and tokens, routes and clocks
    equal the JAX fleet's on the same ops."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 5))
    kw = dict(num_pages=16, pages_per_superblock=4, max_batch=2)
    fleets = _fleets(weights, n, **kw)
    ops = []
    for _ in range(int(rng.integers(4, 11))):
        op = str(rng.choice(["submit", "step", "preempt"], p=[.5, .3, .2]))
        ops.append((op, int(rng.integers(0, 4)), int(rng.integers(1, 6))))
    handles = [[], []]
    for f, (fleet, hs) in enumerate(zip(fleets, handles)):
        for op, a, b in ops:
            if op == "submit":
                hs.append(fleet.submit([10 + a, 11 + a, 12 + a][: 1 + a % 3],
                                       b))
            elif op == "step":
                fleet.step()
            else:
                running = [r for e in fleet.replicas for r in e.running]
                if running:
                    victim = running[a % len(running)]
                    victim._engine.scheduler.preempt(victim)
            if f == 1 and op != "submit":
                _conservation(fleet)
        _drain(fleet, 200)
        assert all(r.state == "finished" for r in hs)
    jf, tf = fleets
    _conservation(tf)
    assert _state(tf, handles[1]) == _state(jf, handles[0])
    tf.shrink()
    for e in tf.replicas:
        floor = superblock_floor(e.scheduler.distinct_pages_in_use(),
                                 e.pages_per_superblock, 1)
        assert e.kv_manager.allocator.superblocks_mapped == floor


# ---------------------------------------------------------------------------
# thread safety of what the kernel modules share


def _run_threads(target, n):
    threads = [threading.Thread(target=target) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)


def test_cold_library_load_runs_one_build(monkeypatch):
    """Threads that meet a cold library wait for one build: ``_start`` (the
    ``nvcc`` launch) runs once and every thread gets the same library."""
    from repro_torch.kernels import build

    calls, libs = [], []

    def slow_start(name):
        calls.append(name)
        time.sleep(0.2)  # a build in progress while the others arrive
        return None, None, pathlib.Path(f"lib{name}.so")

    monkeypatch.setattr(build, "_start", slow_start)
    monkeypatch.setattr(build, "ctypes", types.SimpleNamespace(
        CDLL=lambda path: object()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    build.load.cache_clear()
    try:
        _run_threads(lambda: libs.append(build.load("paged_attention")), 8)
    finally:
        build.load.cache_clear()
    assert calls == ["paged_attention"]
    assert len(libs) == 8 and len({id(x) for x in libs}) == 1


def test_launch_counts_are_not_lost_across_threads():
    from repro_torch.kernels.build import count_launch

    def kernel():
        pass
    kernel.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _run_threads(lambda: [count_launch(kernel) for _ in range(2000)], 16)
    finally:
        sys.setswitchinterval(old)
    assert kernel.launches == 16 * 2000


def test_ticket_buffer_grows_to_every_request():
    """Concurrent get-or-grow keeps one buffer per (device, stream) at
    least as large as any thread asked for (an unlocked grow can replace a
    larger buffer with a smaller one)."""
    from repro_torch.kernels import paged_attention as pa

    key = (torch.device("cpu"), -12345)
    sizes = iter(range(2048, 2048 + 64 * 512, 512))
    lock = threading.Lock()
    asked = []

    def grow():
        for _ in range(4):
            with lock:
                n = next(sizes)
                asked.append(n)
            assert pa._ticket_buffer(*key, n).numel() >= n

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _run_threads(grow, 16)
        assert pa._tickets[key].numel() >= max(asked)
    finally:
        sys.setswitchinterval(old)
        pa._tickets.pop(key, None)
