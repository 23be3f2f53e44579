"""The readers of the program's spans and counters: on hand-built records
(a ring that no longer holds the window's start reads nothing), on a tiny
traced cell, and the scheduler's spans against the benchmark's own
wrappers on the same run."""

import contextlib
import time
from types import SimpleNamespace

import pytest
import torch

from bench.cells import load_cell, load_reader
from bench.drive import Loop
from bench.generate import Traffic
from bench.harness import build_engine, run_cell
from bench.tests.tiny import make_root
from bench.trace import time_scheduler

torch.set_num_threads(1)

READERS = ("evict_ms_per_step", "evict_scan_per_entry",
           "read_wait_ms_per_step", "host_read_ms_per_step",
           "queue_wait_ms", "queue_wait_ms.gen", "step_fill_pct",
           "sched_self_ms_per_step")
SCHED = ("scheduler.admit", "scheduler.plan_chunk", "scheduler.plan_validate",
         "scheduler.absorb", "scheduler.maintain")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def _read(root, name, w0, w1):
    return load_reader(root, name)(SimpleNamespace(w0=w0, w1=w1))


def _steps(tr, t, n, read=0.002, evict=None, tokens=3, positions=8):
    """``n`` hand-built steps of 10 ms from ``t``: each a launch, a read,
    and an absorb of 2 ms of its own that holds, where given, an eviction
    sweep of ``evict`` (seconds, keys, entries)."""
    for i in range(n):
        a = t + 0.01 * i
        with tr.span("engine.step") as s:
            with tr.span("runner.launch") as c:
                c.set(positions=positions)
            c.t0, c.t1 = a, a + 0.001
            with tr.span("runner.read") as c:
                pass
            c.t0, c.t1 = a + 0.001, a + 0.001 + read
            b = a + 0.001 + read
            with tr.span("scheduler.absorb") as ab:
                if evict is not None:
                    with tr.span("prefix.evict") as c:
                        c.set(keys_scanned=evict[1], entries_evicted=evict[2])
                    c.t0, c.t1 = b, b + evict[0]
            ab.t0, ab.t1 = b, b + 0.002 + (evict[0] if evict else 0.0)
            s.set(tokens=tokens)
        s.t0, s.t1 = a, a + 0.0099


def test_readers_on_hand_built_records(root):
    from repro_torch.spans import new_tracer

    t = 1e7  # far from every real tracer's clock
    tr = new_tracer()
    _steps(tr, t, 10, evict=(0.004, 300, 3))
    with tr.span("device.read") as r:
        pass
    r.t0, r.t1 = t + 0.0005, t + 0.0015
    tr.add("request.queued", t - 1.0, t + 0.05, rid=1)
    tr.add("request.queued", t + 0.02, t + 0.07, rid=2)
    tr.add("request.queued", t + 0.03, t + 0.2, rid=3)  # after the window
    w0, w1 = t, t + 0.1
    got = {n: _read(root, n, w0, w1) for n in READERS}
    assert got["evict_ms_per_step"] == pytest.approx(4.0, rel=1e-5)
    assert got["evict_scan_per_entry"] == pytest.approx(100.0, rel=1e-5)
    assert got["read_wait_ms_per_step"] == pytest.approx(2.0, rel=1e-5)
    assert got["host_read_ms_per_step"] == pytest.approx(0.1, rel=1e-5)
    assert got["queue_wait_ms"] == pytest.approx(1e3 * (1.05 + 0.05) / 2,
                                                 rel=1e-5)
    assert got["queue_wait_ms.gen"] == got["queue_wait_ms"]
    assert got["step_fill_pct"] == pytest.approx(100.0 * 3 / 8, rel=1e-5)
    assert got["sched_self_ms_per_step"] == pytest.approx(2.0, rel=1e-5)
    # a window with steps but no sweep and no request
    t2 = t + 10.0
    _steps(tr, t2, 3)
    got = {n: _read(root, n, t2, t2 + 0.05) for n in READERS}
    assert got["evict_ms_per_step"] == 0.0
    assert got["evict_scan_per_entry"] is None
    assert got["queue_wait_ms"] is None and got["queue_wait_ms.gen"] is None
    assert got["sched_self_ms_per_step"] == pytest.approx(2.0, rel=1e-5)
    # nothing recorded in the window
    assert all(_read(root, n, t + 5.0, t + 6.0) is None for n in READERS)


def test_a_ring_without_the_window_start_reads_nothing(root):
    from repro_torch.spans import new_tracer

    t = 2e7
    tr = new_tracer(capacity=16)
    _steps(tr, t, 4)  # 16 records: the ring is full
    assert tr.dropped == 0
    assert _read(root, "read_wait_ms_per_step", t - 1, t + 1) is not None
    _steps(tr, t + 0.04, 1)  # drops the first step's records
    assert tr.dropped == 4
    assert all(_read(root, n, t - 1, t + 1) is None for n in READERS)
    # a window after what was dropped still reads
    assert _read(root, "read_wait_ms_per_step", t + 0.00995,
                 t + 1) == pytest.approx(2.0, rel=1e-5)


def test_a_traced_tiny_cell_reports_the_span_metrics(root):
    out = run_cell(load_cell(root, "tiny-dense.open"), 2**31 + 11, 1.0, True,
                   "cpu", time.perf_counter(), log=lambda m: None)
    assert out["correct"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(READERS) <= set(m)
    assert 0 < m["step_fill_pct"] <= 100
    assert m["evict_scan_per_entry"] >= 1
    assert m["queue_wait_ms"] > 0 and m["read_wait_ms_per_step"] > 0
    assert 0 <= m["evict_ms_per_step"] < m["sched_ms_per_step"]
    assert 0 < m["sched_self_ms_per_step"] < m["sched_ms_per_step"]
    assert out["metrics"]["evict_scan_per_entry"]["unit"] == "keys"


def test_scheduler_spans_agree_with_the_benchmark_wrappers(root,
                                                           monkeypatch):
    from repro_torch.spans import records_between

    # the wrappers' profiler ranges cost more than a tiny cell's scheduler
    # calls on the CPU: they are left out, the two clocks compared
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: contextlib.nullcontext())
    cell = load_cell(root, "tiny-dense.open")
    eng = build_engine(cell, 7, torch.device("cpu"))
    loop = Loop(eng, Traffic(cell.mix, 7, cell.spec.vocab))
    tally = time_scheduler(eng, loop)
    loop.run(1.0)
    recs = records_between(loop.w0, loop.w1)
    ours = sum(r.t1 - r.t0 for r in recs if r.name in SCHED)
    steps = sum(r.name == "engine.step" for r in recs)
    assert steps == len(
        [s for s in loop.steps if loop.w0 < s.t_end <= loop.w1])
    assert ours == pytest.approx(tally["sched_s"], rel=0.1)
    # the scheduler's own time, its sweeps and its reads make up its spans
    run = SimpleNamespace(w0=loop.w0, w1=loop.w1)
    parts = sum(load_reader(root, n)(run) for n in (
        "sched_self_ms_per_step", "evict_ms_per_step"))
    ids = {r.id for r in recs if r.name in SCHED}
    reads = sum(r.t1 - r.t0 for r in recs
                if r.name == "device.read" and r.parent in ids)
    assert parts + 1e3 * reads / steps == pytest.approx(1e3 * ours / steps,
                                                        rel=1e-6)
