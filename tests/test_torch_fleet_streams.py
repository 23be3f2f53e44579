"""A CUDA stream of its own for each fleet replica (``serving/parallel.py``).

On the CPU (every test without the ``cuda`` marker): a replica has no
stream and the fleet's CPU path is what it was — ``step()`` and ``run()``
generate one engine's tokens; the reads a card makes through pinned
memory give the lists they gave; and while a failed replica's stream may
still run, a round captures nothing and runs each missing graph's step
eagerly, counted, while a failed capture still raises.  On the card (marker ``cuda``; they skip
elsewhere): each replica's stream is its own and not the default stream,
and a revived replica gets a new one, never a stream the fleet holds; a
failed capture leaves the current stream as it was; each replica's graphs
replay on its stream; ``run()`` and ``step()`` generate one engine's tokens; a replica
stalled in a device call (a ``torch.cuda._sleep`` on its stream) is failed
over, and the survivors finish every request, token-exact against a
fault-free fleet, while its stream still sleeps; an engine outside a fleet
steps on the current stream.  Run them on the card with
``python -m pytest tests/test_torch_fleet_streams.py -m cuda``.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models.transformer import init_decoder_lm
from repro_torch.serving import (DataParallelEngine, PagedServingEngine,
                                 WatchdogConfig)
from repro_torch.serving.runner import ModelRunner

torch.set_num_threads(1)

KW = dict(num_pages=32, page_size=4, max_batch=3, prefill_chunk=8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a replica's stream is a CUDA "
                    "stream")
    return torch.device("cuda", 0)


def _setup(device, n=8, seed=4):
    cfg = reduced(get_config("olmo-1b"))
    params = init_decoder_lm(cfg, seed=seed, dtype=torch.float32,
                             device=device)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, int(k)).tolist()
               for k in rng.integers(3, 14, n)]
    return cfg, params, prompts


def _one_engine(cfg, params, prompts, device, new=6):
    eng = PagedServingEngine(cfg, params, device=device, **KW)
    reqs = [eng.submit(p, new) for p in prompts]
    eng.run()
    return [list(r.generated) for r in reqs]


def _fleet_tokens(fleet, prompts, mode, new=6):
    reqs = [fleet.submit(p, new) for p in prompts]
    if mode == "run":
        fleet.run()
    else:
        while not fleet.drained():
            fleet.step()
    assert all(r.state == "finished" for r in reqs)
    for e in fleet.replicas:
        assert e.stats.warnings_fired == int(e.pool.clock.cpu())
    return [list(r.generated) for r in reqs]


@pytest.mark.parametrize("mode", ["run", "step"])
def test_cpu_fleet_has_no_streams(mode):
    """On the CPU a replica has no stream, before and after a revival, and
    the fleet generates one engine's tokens in both drive modes."""
    cfg, params, prompts = _setup("cpu")
    fleet = DataParallelEngine(cfg, params, replicas=2,
                               devices=["cpu", "cpu"], **KW)
    assert fleet.streams == [None, None]
    assert _fleet_tokens(fleet, prompts, mode) == _one_engine(
        cfg, params, prompts, "cpu")
    fleet.alive[0] = False
    fleet.revive(0)
    assert fleet.streams == [None, None]


def test_cpu_reads_give_the_lists_they_gave():
    """On the CPU the reads that go through pinned memory on a card
    (``device.host_list``: ``KVCacheManager.row_pages``, ``Request.pages``,
    the pool's sync points) give what ``.tolist()`` gave."""
    from repro_torch.device import host_list

    cfg, params, prompts = _setup("cpu")
    eng = PagedServingEngine(cfg, params, device="cpu", **KW)
    reqs = [eng.submit(p, 6) for p in prompts[:3]]
    eng.scheduler.admit()
    for _ in range(3):
        eng.step()
    kvm = eng.kv_manager
    t = torch.arange(-2, 5, dtype=torch.int32)
    assert host_list(t) == t.tolist() and host_list(t[:0]) == []
    for r in reqs:
        row = kvm._bt[r.slot].tolist()
        assert kvm.row_pages(r.slot) == row
        assert r.pages == [p for p in row if p >= 0] and r.pages
    got, ok = kvm.allocator.alloc(2)
    assert ok and len(got) == 2 and kvm.allocator.share(got)


class _Event:
    """A stand-in for the event a fleet records on a failed replica's
    stream: ``query()`` is True once that stream's work has ended."""

    def __init__(self, done):
        self.done = done

    def query(self):
        return self.done


def _held_fleet(monkeypatch, done):
    """A CPU fleet whose runners take the graph path (``graphs = True``)
    with every capture raising, and one abandoned stream's event, ended
    or not."""
    cfg, params, prompts = _setup("cpu")

    def capture(self, kvm, key):
        raise RuntimeError(f"capture of {key}")
    monkeypatch.setattr(ModelRunner, "capture", capture)
    fleet = DataParallelEngine(cfg, params, replicas=2,
                               devices=["cpu", "cpu"], **KW)
    for e in fleet.replicas:
        e.runner.graphs = True
    fleet._abandoned = [_Event(done)]
    return cfg, params, prompts, fleet


def test_cpu_fleet_holds_captures_while_an_abandoned_stream_runs(
        monkeypatch):
    """While the event of a failed replica's stream has not completed, a
    round captures nothing: every step whose graph is missing runs the
    eager step, counted, and the fleet generates one engine's tokens."""
    cfg, params, prompts, fleet = _held_fleet(monkeypatch, done=False)
    reqs = [fleet.submit(p, 6) for p in prompts]
    fleet.run()
    assert all(r.state == "finished" for r in reqs)
    assert fleet.eager_steps_held == fleet.stats.steps > 0
    assert all(not e.runner.hold_captures for e in fleet.replicas)
    assert [list(r.generated) for r in reqs] == _one_engine(
        cfg, params, prompts, "cpu")


def test_cpu_fleet_captures_once_the_abandoned_stream_ended(monkeypatch):
    """Once that event has completed the round captures its graphs first,
    and a capture that fails raises: nothing turns it into an eager
    step."""
    _, _, prompts, fleet = _held_fleet(monkeypatch, done=True)
    for p in prompts:
        fleet.submit(p, 6)
    with pytest.raises(RuntimeError, match="capture of"):
        fleet.run()
    assert fleet._abandoned == [] and fleet.eager_steps_held == 0


@pytest.mark.cuda
def test_cuda_replica_streams_are_their_own(cuda):
    """Each replica's stream lies on its card, is neither the default
    stream nor another replica's, and a revived replica gets a new one."""
    cfg, params, _ = _setup(cuda)
    fleet = DataParallelEngine(cfg, params, replicas=2,
                               devices=[cuda, cuda], **KW)
    default = torch.cuda.default_stream(cuda)
    handles = [s.cuda_stream for s in fleet.streams]
    assert all(s.device == cuda for s in fleet.streams)
    assert len(set(handles)) == 2 and default.cuda_stream not in handles
    old = fleet.streams[0]
    fleet.alive[0] = False
    fleet.revive(0)
    assert fleet.streams[0] is not old
    assert fleet.streams[0].cuda_stream not in (default.cuda_stream,
                                                fleet.streams[1].cuda_stream)


@pytest.mark.cuda
def test_cuda_replica_stream_is_none_in_use(cuda):
    """PyTorch hands its streams out in turn from a pool: a replica's new
    stream skips every handle the fleet holds, and raises where the pool
    has none left."""
    from repro_torch.serving.parallel import _stream_for

    pool = {torch.cuda.Stream(cuda).cuda_stream for _ in range(80)}
    free = min(pool)
    assert _stream_for(cuda, pool - {free}).cuda_stream == free
    with pytest.raises(RuntimeError, match="free"):
        _stream_for(cuda, pool)


@pytest.mark.cuda
def test_cuda_failed_capture_keeps_the_current_stream(cuda):
    """A capture whose body fails raises and leaves the caller's current
    stream as it was (``torch.cuda.graph`` leaves its capture stream
    current)."""
    from repro_torch.capture import record_graph

    def body():
        raise ValueError("body fails")
    before = torch.cuda.current_stream(cuda)
    with pytest.raises((ValueError, RuntimeError)):
        record_graph(body, torch.cuda.Stream(cuda),
                     torch.cuda.graph_pool_handle())
    assert torch.cuda.current_stream(cuda) == before


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["run", "step"])
def test_cuda_replica_graphs_replay_on_its_stream(cuda, monkeypatch, mode):
    """Every graph replay of a fleet lands on the stream of the replica
    whose runner replays it, and an event recorded on that stream just
    after the replay completes only once the graph has run."""
    cfg, params, prompts = _setup(cuda)
    fleet = DataParallelEngine(cfg, params, replicas=2,
                               devices=[cuda, cuda], **KW)
    seen = []
    replay = ModelRunner._replay

    def watch(graph):
        replay(graph)
        stream = torch.cuda.current_stream(cuda)
        done = stream.record_event()
        seen.append((stream.cuda_stream, done))
    monkeypatch.setattr(ModelRunner, "_replay", staticmethod(watch))
    _fleet_tokens(fleet, prompts, mode)
    owned = {s.cuda_stream for s in fleet.streams}
    assert seen and {h for h, _ in seen} == owned
    for s in fleet.streams:
        s.synchronize()
    assert all(done.query() for _, done in seen)


@pytest.mark.cuda
def test_cuda_fleet_tokens_equal_one_engine(cuda):
    """Float32 weights: ``run()`` and ``step()`` of two replicas on one
    card, each on its own stream, generate one engine's tokens for every
    request (each replica's requests among them)."""
    cfg, params, prompts = _setup(cuda)
    base = _one_engine(cfg, params, prompts, cuda)
    for mode in ("run", "step"):
        fleet = DataParallelEngine(cfg, params, replicas=2,
                                   devices=[cuda, cuda], **KW)
        assert _fleet_tokens(fleet, prompts, mode) == base, mode


def _cycles_per_second(cuda):
    """The card's ``torch.cuda._sleep`` cycles a second, timed by events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)  # warm
    start.record()
    torch.cuda._sleep(100_000_000)
    end.record()
    end.synchronize()
    return 1e8 / (start.elapsed_time(end) / 1e3)


@pytest.mark.cuda
def test_cuda_stalled_replica_fails_over_while_its_stream_sleeps(cuda):
    """Replica 0 sleeps on its stream for ``SLEEP_S`` seconds at its fourth
    driver iteration; its thread blocks in the step's read, the watchdog
    declares it stalled, migrates its requests and revives it on a new
    stream — and the fleet finishes every request, token-exact against a
    fault-free fleet, while the old stream is still asleep."""
    sleep_s = 20.0
    cfg, params, prompts = _setup(cuda, n=12)
    clean = DataParallelEngine(cfg, params, replicas=2, devices=[cuda, cuda],
                               **KW)
    base = _fleet_tokens(clean, prompts, "run", new=16)
    fleet = DataParallelEngine(
        cfg, params, replicas=2, devices=[cuda, cuda],
        watchdog=WatchdogConfig(stall_timeout=1.0, auto_revive=True), **KW)
    warm = [fleet.submit(p[:4], 2) for p in prompts[:2]]
    fleet.run()
    assert all(r.state == "finished" for r in warm)
    cycles = int(sleep_s * _cycles_per_second(cuda))
    stalled = {}
    calls = [0]

    def stall(_eng):
        calls[0] += 1
        if calls[0] == 4:
            stream = torch.cuda.current_stream(cuda)
            torch.cuda._sleep(cycles)
            stalled.update(stream=stream, done=stream.record_event(),
                           thread=threading.current_thread())
    fleet.step_hooks[0] = stall
    old = fleet.streams[0]
    reqs = [fleet.submit(p, 16) for p in prompts]
    victims = [r for r in reqs if r._engine is fleet.replicas[0]]
    t0 = time.perf_counter()
    fleet.run()
    wall = time.perf_counter() - t0
    asleep = not stalled["done"].query()
    try:
        # current_stream() wraps the handle in a new object: compare by ==
        assert stalled["stream"] == old and fleet.streams[0] is not old
        assert asleep, f"the stalled stream woke before the fleet finished " \
                       f"({wall:.1f} s of a {sleep_s} s sleep)"
        assert all(r.state == "finished" for r in reqs)
        st = fleet.stats
        assert st.replica_failures == 1 and st.replica_revivals == 1
        assert st.requests_migrated >= len(victims) > 0
        assert [r.output_tokens for r in reqs] == base
    finally:
        stalled["done"].synchronize()
        stalled["thread"].join(timeout=60)
    assert not stalled["thread"].is_alive()


@pytest.mark.cuda
def test_cuda_engine_outside_a_fleet_steps_on_the_current_stream(
        cuda, monkeypatch):
    """A ``PagedServingEngine`` of its own replays its graphs on whatever
    stream is current: the default one, or one the caller enters."""
    cfg, params, prompts = _setup(cuda)
    seen = []
    replay = ModelRunner._replay

    def watch(graph):
        replay(graph)
        seen.append(torch.cuda.current_stream(cuda).cuda_stream)
    monkeypatch.setattr(ModelRunner, "_replay", staticmethod(watch))
    base = _one_engine(cfg, params, prompts, cuda)
    assert set(seen) == {torch.cuda.default_stream(cuda).cuda_stream}
    seen.clear()
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        assert _one_engine(cfg, params, prompts, cuda) == base
    assert set(seen) == {side.cuda_stream}
