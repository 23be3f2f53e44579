"""The serving path's spans and counters (``repro_torch/spans.py``)
on the CPU: the tracer's records, nesting and ring; the engine's spans
against what the engine did; the same tokens and counters with the
recorder off; a fleet's tracers; the ranges a profiler sees."""

import dataclasses
import time
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch import device, spans
from repro_torch.configs import get_config, reduced
from repro_torch.core import pagepool
from repro_torch.models.transformer import init_decoder_lm
from repro_torch.serving import (DataParallelEngine, PagedServingEngine,
                                 kv_manager, stats)
from repro_torch.serving import prefix_index

torch.set_num_threads(1)

KW = dict(num_pages=32, page_size=4, max_batch=3, prefill_chunk=4)
STEP_CHILDREN = ["scheduler.plan_chunk", "scheduler.plan_validate",
                 "runner.launch", "runner.read", "scheduler.absorb"]


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config("olmo-1b"))
    return cfg, init_decoder_lm(cfg, seed=3, dtype=torch.float32,
                                device="cpu")


def _prompts(cfg, n=6, shared=0, seed=1):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, cfg.vocab, shared).tolist()
    return [head + rng.integers(0, cfg.vocab, int(k)).tolist()
            for k in rng.integers(3, 12, n)]


def _drive(eng, prompts, new=5, max_steps=400):
    """The engine's own round, step by step; returns the requests."""
    reqs = [eng.submit(p, new) for p in prompts]
    for _ in range(max_steps):
        eng.scheduler.admit()
        if not eng.scheduler.running and not eng.scheduler.queue:
            break
        eng.step()
        eng.scheduler.maintain()
    assert all(r.state == "finished" for r in reqs)
    return reqs


def _plain(v):
    """Counters as plain values: a reservoir or class tally by its
    contents (they compare by identity)."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, stats.LatencyReservoir):
        return (v.cap, v.seen, list(v.samples))
    return v


def _by_name(eng):
    out = {}
    for r in eng.tracer.records:
        out.setdefault(r.name, []).append(r)
    return out


# -- the tracer --------------------------------------------------------------

def test_spans_nest_with_parents_and_self_time():
    tr = spans.Tracer()
    with tr.span("a") as a:
        time.sleep(0.002)
        with tr.span("b") as b:
            time.sleep(0.003)
            with tr.span("c") as c:
                c.set(n=2)
        with tr.span("b") as b2:
            pass
    tr.add("w", 1.0, 2.0, rid=7)
    assert [r.name for r in tr.records] == ["c", "b", "b", "a", "w"]
    assert a.parent is None and b.parent == a.id and c.parent == b.id
    assert b2.parent == a.id and len({a.id, b.id, c.id, b2.id}) == 4
    assert c.get("n") == 2 and a.get("n") == 0
    assert a.t0 <= b.t0 <= c.t0 <= c.t1 <= b.t1 <= b2.t0 <= b2.t1 <= a.t1
    w = tr.records[-1]
    assert (w.t0, w.t1, w.rid, w.parent) == (1.0, 2.0, 7, None)
    own = spans.self_times(list(tr.records))
    dur = {id(s): s.t1 - s.t0 for s in (a, b, b2, c)}
    assert own["a"] == pytest.approx(dur[id(a)] - dur[id(b)] - dur[id(b2)])
    assert own["b"] == pytest.approx(dur[id(b)] + dur[id(b2)] - dur[id(c)])
    assert own["a"] >= 0.0015 and own["b"] >= 0.0025
    assert own["c"] == pytest.approx(dur[id(c)])
    assert not tr._stack


def test_a_span_left_open_closes_with_its_parent():
    tr = spans.Tracer()
    outer = tr.begin("outer")
    tr.begin("lost")
    tr.end(outer)
    with tr.span("next") as n:
        pass
    assert n.parent is None and not tr._stack
    assert not spans._thread.open


def test_a_read_is_charged_to_the_span_open_on_its_thread():
    a, b = spans.Tracer(), spans.Tracer()
    t = torch.zeros(3)
    device.host_list(t)  # no span open: recorded nowhere
    with a.span("outer") as outer:
        device.host_list(t)
        with b.span("inner"):
            device.host_list(t)
        device.host_list(t)
    device.host_list(t)
    assert [r.name for r in a.records] == ["device.read", "device.read",
                                           "outer"]
    assert all(r.parent == outer.id for r in list(a.records)[:2])
    assert [r.name for r in b.records] == ["device.read", "inner"]
    assert not spans._thread.open


def test_interleaved_steps_of_two_tracers_on_one_thread():
    a, b = spans.Tracer(), spans.Tracer()
    t = torch.zeros(3)
    sa = a.begin("engine.step")
    sb = b.begin("engine.step")
    with a.span("scheduler.absorb"):
        device.host_list(t)
    a.end(sa)
    device.host_list(t)  # inside b's step, which is still open
    b.end(sb)
    device.host_list(t)
    assert [r.name for r in a.records] == ["device.read", "scheduler.absorb",
                                           "engine.step"]
    assert [(r.name, r.parent) for r in b.records] == [
        ("device.read", sb.id), ("engine.step", None)]
    assert not a._stack and not b._stack and not spans._thread.open


def test_the_ring_drops_the_oldest_and_counts_them():
    tr = spans.Tracer(capacity=4)
    made = []
    for i in range(6):
        with tr.span(f"s{i}") as s:
            made.append(s)
    assert [r.name for r in tr.records] == ["s2", "s3", "s4", "s5"]
    assert tr.dropped == 2 and tr.dropped_until == made[1].t1


def test_a_tracer_switched_off_records_nothing():
    tr = spans.new_tracer()
    tr.enabled = False
    with tr.span("x") as s:
        s.set(n=1)
    tr.add("w", 0.0, 1.0)
    assert not tr.records and tr in spans.tracers()


# -- the engine's spans ------------------------------------------------------

def test_one_step_span_a_step_with_its_children_in_order(model):
    cfg, params = model
    eng = PagedServingEngine(cfg, params, device="cpu", **KW)
    reqs = _drive(eng, _prompts(cfg))
    by = _by_name(eng)
    steps = by["engine.step"]
    assert len(steps) == eng.stats.steps > 0
    ids = {s.id for s in steps}
    kids = {}
    for r in eng.tracer.records:
        if r.parent in ids:
            kids.setdefault(r.parent, []).append(r)
    for s in steps:
        names = [k.name for k in sorted(kids[s.id], key=lambda k: k.t0)
                 if k.name != "device.read"]
        assert names == STEP_CHILDREN
        assert all(s.t0 <= k.t0 <= k.t1 <= s.t1 for k in kids[s.id])
    assert sum(s.get("tokens") for s in steps) == eng.stats.tokens_committed
    assert sum(map(len, (r.generated for r in reqs))) <= sum(
        s.get("tokens") for s in steps)
    for name in ("scheduler.admit", "scheduler.maintain"):
        assert all(r.parent is None for r in by[name])
    assert not eng.tracer._stack and eng.tracer.dropped == 0


@pytest.mark.parametrize("cache", [False, True], ids=["cache-off",
                                                     "cache-on"])
def test_tokens_and_counters_do_not_depend_on_the_recorder(model, cache):
    cfg, params = model

    def served(enabled):
        ticks = iter(range(10**6))
        eng = PagedServingEngine(
            cfg, params, device="cpu", prefix_cache=cache,
            prefix_cache_pages=6, clock=lambda: 0.01 * next(ticks),
            **{**KW, "num_pages": 20})
        eng.tracer.enabled = enabled
        reqs = _drive(eng, _prompts(cfg, n=8, shared=8 if cache else 0))
        return ([r.generated for r in reqs],
                _plain(eng.stats),
                len(eng.tracer.records))

    on, off = served(True), served(False)
    assert on[0] == off[0]
    assert on[1] == off[1]
    assert on[2] > 0 and off[2] == 0
    if cache:
        assert on[1]["prefix_evictions"] > 0 and on[1]["prefix_hits"] > 0


def test_a_queued_span_per_first_admission(model, monkeypatch):
    cfg, params = model
    eng = PagedServingEngine(cfg, params, device="cpu", **KW)
    installed = []
    install = eng.kv_manager.install_slot

    def timed(*a, **k):
        install(*a, **k)
        installed.append(time.perf_counter())
    monkeypatch.setattr(eng.kv_manager, "install_slot", timed)
    submitted = []
    prompts = _prompts(cfg, n=7)
    reqs = []
    for p in prompts:
        t = time.perf_counter()
        reqs.append(eng.submit(p, 5))
        submitted.append((t, time.perf_counter()))
    _drive(eng, [])
    waits = _by_name(eng)["request.queued"]
    assert [w.rid for w in waits] == [r.rid for r in reqs]
    assert len(installed) == len(reqs)  # no preemption here
    for w, (s0, s1), t in zip(waits, submitted, installed):
        assert s0 <= w.t0 <= s1
        assert t <= w.t1 <= t + 0.005
        assert w.parent is None


def test_no_queued_span_for_a_readmission(model):
    cfg, params = model
    eng = PagedServingEngine(cfg, params, device="cpu",
                             **{**KW, "num_pages": 8, "prefill_chunk": 4})
    reqs = _drive(eng, _prompts(cfg, n=6, seed=5), new=10)
    assert eng.stats.preemptions > 0
    waits = _by_name(eng)["request.queued"]
    assert sorted(w.rid for w in waits) == sorted(r.rid for r in reqs)
    assert not eng.scheduler._waiting


def test_an_evict_span_per_sweep_with_its_counters(model, monkeypatch):
    """``keys_scanned``: the candidates a sweep pops from the index's
    queue of leaves, at least one for each entry it evicts."""
    cfg, params = model
    sweeps, popped = [], [0]
    evict = prefix_index.PrefixIndex.evict
    heappop = prefix_index.heappop

    def counted(self, *a, **k):
        n = popped[0]
        out = evict(self, *a, **k)
        sweeps.append(popped[0] - n)
        return out

    def pop(heap):
        popped[0] += 1
        return heappop(heap)
    monkeypatch.setattr(prefix_index.PrefixIndex, "evict", counted)
    monkeypatch.setattr(prefix_index, "heappop", pop)
    eng = PagedServingEngine(cfg, params, device="cpu", prefix_cache=True,
                             prefix_cache_pages=5, **KW)
    before = eng.stats.prefix_evictions
    _drive(eng, _prompts(cfg, n=10, shared=8, seed=2))
    ev = _by_name(eng)["prefix.evict"]
    assert len(ev) == len(sweeps) > 0
    assert [e.get("keys_scanned") for e in ev] == sweeps
    assert all(e.get("keys_scanned") >= e.get("entries_evicted") for e in ev)
    assert (sum(e.get("entries_evicted") for e in ev)
            == eng.stats.prefix_evictions - before > 0)


def test_positions_are_rows_times_chunk(model, monkeypatch):
    cfg, params = model
    eng = PagedServingEngine(cfg, params, device="cpu", **KW)
    chunks = []
    plan = eng.scheduler.plan_chunk

    def recorded():
        out = plan()
        chunks.append(out[0])
        return out
    monkeypatch.setattr(eng.scheduler, "plan_chunk", recorded)
    _drive(eng, _prompts(cfg))
    launches = _by_name(eng)["runner.launch"]
    assert len(launches) == eng.stats.steps == len(chunks)
    assert {1, KW["prefill_chunk"]} <= set(chunks)
    assert ([r.get("positions") for r in launches]
            == [KW["max_batch"] * c for c in chunks])


def test_a_device_read_span_per_host_read(model, monkeypatch):
    cfg, params = model
    calls = Counter()
    for mod in (kv_manager, pagepool):
        real = mod.host_list

        def counted(t, real=real, mod=mod):
            calls[mod.__name__] += 1
            return real(t)
        monkeypatch.setattr(mod, "host_list", counted)
    eng = PagedServingEngine(cfg, params, device="cpu", prefix_cache=True,
                             prefix_cache_pages=5, **KW)
    reqs = _drive(eng, _prompts(cfg, n=8, shared=8, seed=3))
    assert reqs[0].pages == []  # a finished request reads nothing
    reads = _by_name(eng)["device.read"]
    assert len(reads) == sum(calls.values())
    assert calls["repro_torch.serving.kv_manager"] > 0
    assert calls["repro_torch.core.pagepool"] > 0
    names = {r.id: r.name for r in eng.tracer.records}
    assert {names[r.parent] for r in reads} <= {
        "scheduler.admit", "scheduler.absorb", "scheduler.maintain",
        "prefix.evict"}


def test_fleet_replicas_keep_separate_tracers(model):
    cfg, params = model
    fleet = DataParallelEngine(cfg, params, replicas=2,
                               devices=["cpu", "cpu"], **KW)
    for p in _prompts(cfg, n=8, seed=4):
        fleet.submit(p, 5)
    fleet.run()
    a, b = (e.tracer for e in fleet.replicas)
    assert a is not b and a in spans.tracers() and b in spans.tracers()
    for e in fleet.replicas:
        recs = list(e.tracer.records)
        ids = {r.id for r in recs}
        assert sum(r.name == "engine.step" for r in recs) == e.stats.steps > 0
        assert all(r.parent is None or r.parent in ids for r in recs)
    assert not {r.id for r in a.records} & {r.id for r in b.records}


def test_a_profiler_sees_the_spans_as_nested_ranges(model):
    from torch.profiler import ProfilerActivity, profile

    cfg, params = model
    eng = PagedServingEngine(cfg, params, device="cpu", **KW)
    for p in _prompts(cfg, n=3):
        eng.submit(p, 3)
    eng.scheduler.admit()
    eng.step()  # the first step outside the profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            eng.scheduler.admit()
            eng.step()
            eng.scheduler.maintain()
    ev = [e for e in prof.events() if e.name in (
        ["engine.step", "scheduler.admit", "scheduler.maintain"]
        + STEP_CHILDREN)]
    got = Counter(e.name for e in ev)
    assert got["engine.step"] == 2 and got["scheduler.admit"] == 2
    assert all(got[n] == 2 for n in STEP_CHILDREN)
    steps = [(e.time_range.start, e.time_range.end) for e in ev
             if e.name == "engine.step"]
    for e in ev:
        if e.name == "engine.step":
            continue
        inside = any(a <= e.time_range.start and e.time_range.end <= b
                     for a, b in steps)
        assert inside == (e.name in STEP_CHILDREN), e.name
    # the tracer recorded the same spans
    assert sum(r.name == "engine.step" for r in eng.tracer.records) == 3
