"""The runner's captured-step plumbing on the CPU, against the JAX engine.

A CUDA graph cannot be captured without a card.  Here the runner takes its
graph path (``runner.graphs = True``) with capture and replay swapped, in
the test only, for an eager call of the recorded body on the static
buffers: ``_record`` returns the body, ``_replay`` calls it.  Every other
part of the path runs as it does on the card — the key, the dry step of
each capture, the static pool and its copy-in before a replay, the
resident budget and temperature, the static draft buffers, the packed
static output and the state identity checks — so a plumbing fault shows
as a token, counter or pool that differs from the JAX
``PagedServingEngine``'s on the workloads of
``tests/test_torch_engine.py::WORKLOADS`` (preemption churn in a tight
pool under either victim policy, the prefix cache and its eviction,
chunked prefill, speculation, both skipping reclamation policies,
overload and the adaptive release).  Tolerance: exact, as in that file
(the same weights, workloads and margin guard).

Also: a pool the host replaced between steps (a preemption's free, a
share, a release, the chaos wrapper, the engine's ``pool`` setter) is the
static pool's content when the next step runs; a prompt longer than the
prompt buffer opens a new key; ``install_slot``/``clear_slot`` write the
per-slot arrays in place, and a replaced one is refused; a fleet captures
every graph of a round before its driver threads start.  The card's own
checks (capture, replay, bitwise against the eager step) are in
``tests/test_torch_cuda.py``.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.models.transformer import init_decoder_lm
from repro.serving import PagedServingEngine as JaxEngine
from repro_torch.configs import get_config as tget, reduced as treduced
from repro_torch.convert import model_from_jax
from repro_torch.core.chaos import ChaosConfig
from repro_torch.core.pagepool import PagePool
from repro_torch.launch.mesh import ServingMesh
from repro_torch.serving import DataParallelEngine, PagedServingEngine
from repro_torch.serving.runner import ModelRunner, uses_graphs
from test_torch_engine import WORKLOADS, _engine_kw, _int_stats, _serve

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    jc = jreduced(jget("olmo-1b"))
    tc = treduced(tget("olmo-1b"))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      init_decoder_lm(jc, jax.random.PRNGKey(7)))
    tm = model_from_jax(tc, jax.tree.map(np.asarray, jp), dtype=torch.float32,
                        device="cpu")
    return jc, jp, tc, tm


@pytest.fixture(scope="module")
def reference(weights):
    """The JAX engine's run of each workload, computed once for the module:
    name -> (final states, generated tokens, integer counters, final pool
    as numpy)."""
    jc, jp, _, _ = weights
    cache = {}

    def get(name):
        if name not in cache:
            eng = JaxEngine(jc, jp, **_engine_kw(name))
            reqs, st = _serve(eng, name, jc.vocab)
            cache[name] = ([r.state for r in reqs],
                           [r.generated for r in reqs], _int_stats(st),
                           [np.asarray(a) for a in eng.pool])
        return cache[name]
    return get


@pytest.fixture
def plumbing(monkeypatch):
    """Switch an engine's runner to its graph path with capture and replay
    done eagerly on the static buffers; returns the switch."""
    monkeypatch.setattr(ModelRunner, "_record", lambda self, body: (body, {}))
    monkeypatch.setattr(ModelRunner, "_replay",
                        staticmethod(lambda graph: graph()))

    def on(eng):
        runners = ([e.runner for e in eng.replicas]
                   if isinstance(eng, DataParallelEngine) else [eng.runner])
        for r in runners:
            r.graphs = True
        return eng
    return on


def _replays(eng) -> int:
    return sum(g.replays for g in eng.runner.step_graphs.values())


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_graph_plumbing_matches_reference(weights, reference, plumbing,
                                          name):
    _, _, tc, tm = weights
    eng = plumbing(PagedServingEngine(tc, tm, device="cpu",
                                      **_engine_kw(name)))
    reqs, st = _serve(eng, name, tc.vocab)
    states, tokens, stats, pool = reference(name)
    assert [r.state for r in reqs] == states
    assert [r.generated for r in reqs] == tokens
    assert _int_stats(st) == stats
    assert st.warnings_fired == int(eng.pool.clock)
    for got, want in zip(eng.pool, pool):
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64)
                                      if want.dtype == np.uint32 else want)
    # every step was a replay of a captured key
    assert _replays(eng) == st.steps > 0
    keys = set(eng.runner.step_graphs)
    assert all(k[3] == eng.kv_manager._prompt_cap for k in keys)
    if name == "speculative":
        assert any(k[1] for k in keys)
    if name in ("epoch_grace", "interval"):
        assert any(not k[2] for k in keys)  # the graph without validation


def _small_engine(weights, **kw):
    _, _, tc, tm = weights
    args = dict(num_pages=32, page_size=4, max_batch=3, prefill_chunk=4)
    return PagedServingEngine(tc, tm, device="cpu", **{**args, **kw})


def _prompts(vocab, n=3, lo=5, hi=12, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(k)).tolist()
            for k in rng.integers(lo, hi + 1, n)]


def _drive(eng, steps):
    for _ in range(steps):
        eng.scheduler.admit()
        eng.step()
        eng.scheduler.maintain()


@pytest.mark.parametrize("op", ["free", "share", "release", "chaos",
                                "setter"])
def test_replaced_pool_reaches_the_static_pool(weights, plumbing,
                                               monkeypatch, op):
    """The host replaces the manager's pool between two steps; the next
    step runs over a static pool equal to it, and the static pool is the
    manager's pool again after the step.  The run then finishes with the
    eager engine's tokens and the clock mirror holding."""
    _, _, tc, _ = weights
    kw = dict(chaos=ChaosConfig(seed=3, grant_denial_p=0.2)) \
        if op == "chaos" else {}
    prompts = _prompts(tc.vocab, n=4)
    base = _small_engine(weights, **kw)
    eng = plumbing(_small_engine(weights, **kw))
    reqs = {e: [e.submit(p, 6) for p in prompts] for e in (base, eng)}
    for e in (base, eng):
        _drive(e, 3)
    kvm, runner = eng.kv_manager, eng.runner
    assert kvm.allocator.state is runner._pool
    for e in (base, eng):  # the same host operation on both engines
        if op in ("free", "chaos"):
            e._preempt(e.running[-1])
        elif op == "share":
            e.kv_manager.share([e.kv_manager.row_pages(0)[0]])
        elif op == "release":
            e.run()  # drain, then park the empty superblocks
            assert e.shrink(0) > 0
            reqs[e] += [e.submit(p, 4) for p in prompts[:2]]
            e.scheduler.admit()
        else:
            e.pool = PagePool(*(t.clone() for t in e.pool))
    assert kvm.allocator.state is not runner._pool
    want = [t.clone() for t in kvm.allocator.state]
    seen = []
    replay = ModelRunner._replay

    def watch(graph):
        seen.append([t.clone() for t in runner._pool])
        replay(graph)
    monkeypatch.setattr(ModelRunner, "_replay", staticmethod(watch))
    eng.step()
    assert all(torch.equal(a, b) for a, b in zip(seen[0], want))
    assert kvm.allocator.state is runner._pool
    monkeypatch.setattr(ModelRunner, "_replay", staticmethod(replay))
    if op == "share":
        for e in (base, eng):
            e.kv_manager.unshare_batch([e.kv_manager.row_pages(0)[0]], 0)
    for e in (base, eng):
        e.scheduler.maintain()
        st = e.run()
        assert all(r.state == "finished" for r in reqs[e])
        if op != "chaos":  # chaos's own releases tick behind the manager
            assert st.warnings_fired == int(e.pool.clock)
    assert [r.generated for r in reqs[eng]] == [r.generated
                                                 for r in reqs[base]]
    assert _int_stats(eng.stats) == _int_stats(base.stats)


def test_longer_prompt_opens_a_new_key(weights, plumbing):
    """A prompt longer than the prompt buffer widens it (a new tensor):
    the next step captures a key of the new width, and the narrower keys
    are dropped.  Tokens stay the eager engine's."""
    _, _, tc, _ = weights
    short, long_ = _prompts(tc.vocab, n=2, lo=5, hi=8), _prompts(
        tc.vocab, n=1, lo=24, hi=24, seed=5)
    base, eng = _small_engine(weights), plumbing(_small_engine(weights))
    out = []
    for e in (base, eng):
        reqs = [e.submit(p, 5) for p in short]
        e.run()
        width0 = e.kv_manager._prompt_cap
        reqs += [e.submit(p, 5) for p in long_]
        e.run()
        out.append([r.generated for r in reqs])
    assert out[0] == out[1]
    width = eng.kv_manager._prompt_cap
    assert width0 == 16 and width == 32
    assert eng.runner.step_graphs and all(
        k[3] == width for k in eng.runner.step_graphs)


def test_slot_writes_stay_in_place(weights, plumbing):
    """``install_slot`` and ``clear_slot`` write the per-slot arrays in
    place (the addresses a graph reads); a replaced array is refused at
    the next replay."""
    _, _, tc, _ = weights
    eng = plumbing(_small_engine(weights))
    kvm = eng.kv_manager
    names = ("_bt", "_snap", "_len", "_last", "_active", "_pbuf", "_plen")
    before = {n: (getattr(kvm, n), getattr(kvm, n).data_ptr())
              for n in names}
    reqs = [eng.submit(p, 4) for p in _prompts(tc.vocab)]
    _drive(eng, 2)
    kvm.release_slot(reqs[0].slot)  # clear_slot through the release
    kvm.install_slot(reqs[0].slot, [kvm.row_pages(1)[0]], 0, [1, 2, 3])
    kvm.clear_slot(reqs[0].slot)
    for n, (t, ptr) in before.items():
        assert getattr(kvm, n) is t and t.data_ptr() == ptr, n
    kvm._bt = kvm._bt.clone()
    with pytest.raises(RuntimeError, match="replaced behind it"):
        eng.step()


def test_graph_rule():
    """Graphs where every tensor of the step lies on one card."""
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert uses_graphs(c0)
    assert not uses_graphs(torch.device("cpu"))
    assert uses_graphs(c0, ServingMesh((c0, c0), 2))
    assert not uses_graphs(c0, ServingMesh((c0, c1), 2))
    assert not uses_graphs(torch.device("cpu"),
                           ServingMesh((torch.device("cpu"),) * 2, 2))


def test_fleet_captures_before_its_threads(weights, plumbing, monkeypatch):
    """A fleet's round captures every key its replicas can plan in the
    calling thread, before the driver threads start; a key missing while
    they run raises.  Tokens stay the eager fleet's."""
    _, _, tc, tm = weights
    kw = dict(num_pages=32, page_size=4, max_batch=3, prefill_chunk=4)
    prompts = _prompts(tc.vocab, n=5)
    threads = []
    record = ModelRunner._record

    def watch(self, body):
        threads.append(threading.current_thread())
        return record(self, body)
    monkeypatch.setattr(ModelRunner, "_record", watch)
    out = []
    for graphs in (False, True):
        fleet = DataParallelEngine(tc, tm, replicas=2, devices=["cpu", "cpu"],
                                   **kw)
        if graphs:
            plumbing(fleet)
        reqs = [fleet.submit(p, 5) for p in prompts]
        st = fleet.run()
        out.append(([r.generated for r in reqs], st.steps))
    assert out[0] == out[1]
    # (1 and 4 wide) x (validate or not) per replica, all in this thread
    assert threads == [threading.main_thread()] * 8
    runner = fleet.replicas[0].runner
    assert not runner.frozen
    runner.frozen = True
    with pytest.raises(RuntimeError, match="not captured before"):
        runner.capture(fleet.replicas[0].kv_manager, (2, False, True, 16))


def test_sampled_plumbing_matches_eager(weights, plumbing):
    """Sampling through the graph path (the resident temperature, the
    runner's generator, a throwaway one for each dry step) draws the eager
    engine's tokens from one seed."""
    _, _, tc, _ = weights
    out = []
    for graphs in (False, True):
        eng = _small_engine(weights, greedy=False, temperature=0.7, seed=5)
        if graphs:
            plumbing(eng)
        reqs = [eng.submit(p, 8) for p in _prompts(tc.vocab, n=4)]
        eng.run()
        out.append([r.generated for r in reqs])
    assert out[0] == out[1]
