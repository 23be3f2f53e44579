"""The port's prefix index (``repro_torch/serving/prefix_index.py``),
which keeps its eviction order as entries change, against the
reference's, ``repro.serving.scheduler.PrefixIndex``, which re-derives it
on every sweep, both driven through the port's manager: seeded random
donations, cap and pressure sweeps and pinned pages driven into both,
every call's evicted pages, ``freed``, contents and counters held equal;
the work a sweep does, by its counter; the engine's one index; and the
engine serving the same tokens with either index."""

import numpy as np
import pytest
import torch

from repro.serving.scheduler import PrefixIndex as ReferenceIndex
from repro_torch import spans
from repro_torch.configs import get_config, reduced
from repro_torch.models.transformer import init_decoder_lm
from repro_torch.serving import PagedServingEngine, PrefixIndex
from repro_torch.serving.kv_manager import KVCacheManager
from repro_torch.serving.stats import EngineStats

torch.set_num_threads(1)


class _Allocator:
    """Records each unshare batch, in the order its pages were given."""

    def __init__(self):
        self.batches: list[list[int]] = []

    def unshare(self, pages):
        self.batches.append(list(pages))


class _Manager(KVCacheManager):
    """The manager's host mirrors (sharers, the bound index pages, the
    clock mirror) over a recording allocator."""

    def __init__(self, stats: EngineStats):
        self.allocator = _Allocator()
        self.stats = stats
        self.sharers: dict[int, int] = {}


class _Pair:
    """The reference's index and the port's, driven alike."""

    def __init__(self, page_size: int, cap: int):
        self.sides = []
        for new in (False, True):
            stats = EngineStats()
            kvm = _Manager(stats)
            idx = (PrefixIndex(page_size, cap, kvm, stats, spans.Tracer())
                   if new else ReferenceIndex(page_size, cap, kvm, stats))
            self.sides.append((idx, kvm, stats))
        self.ref, self.new = (s[0] for s in self.sides)

    def both(self, fn):
        """``fn(index, kvm)`` on both sides; their results, held equal."""
        out = [fn(idx, kvm) for idx, kvm, _ in self.sides]
        assert out[0] == out[1]
        self.check()
        return out[0]

    def check(self):
        (a, ka, sa), (b, kb, sb) = self.sides
        assert list(a.index.items()) == list(b.index.items())
        assert list(a.tail.items()) == list(b.tail.items())
        assert list(a.pages.items()) == list(b.pages.items())
        assert list(kb.index_pages) == list(b.pages)  # the bound dict
        assert ka.allocator.batches == kb.allocator.batches
        assert ka.sharers == kb.sharers
        assert (sa.prefix_evictions, sa.prefix_cache_pages,
                sa.warnings_fired, sa.pages_reclaimed) == (
                    sb.prefix_evictions, sb.prefix_cache_pages,
                    sb.warnings_fired, sb.pages_reclaimed)


def _finish(pair, seq, committed, pages, reuse, growth):
    """One request's finish: its row maps the index's match (shared) when
    ``reuse``, fresh pages otherwise, ``growth`` ungranted-position pages
    past what it committed; the row is then donated on both sides."""
    ps = pair.ref.page_size
    chain = []
    if reuse:
        m, chain, tail_page = pair.ref.match(seq[:committed] + [0])
        assert pair.new.match(seq[:committed] + [0]) == (m, chain, tail_page)
    covered = -(-committed // ps)
    row = list(chain[:covered])
    while len(row) < covered + growth:
        row.append(next(pages))
    shared = set(row[: len(chain)])

    def donate(idx, kvm):
        for p in shared:
            kvm.inc_sharer(p)
        idx.donate(row, seq, committed, shared)
    pair.both(donate)


def _random_run(seed: int, steps: int = 300):
    """A seeded run of finishes, sweeps and running rows' shares on both
    sides; returns what it exercised."""
    rng = np.random.default_rng(seed)
    ps = int(rng.choice([1, 2, 4]))
    pair = _Pair(ps, cap=int(rng.integers(3, 16)))
    pages = iter(range(10**9))
    heads = [rng.integers(0, 3, int(rng.integers(0, 4 * ps))).tolist()
             for _ in range(3)]
    held: list[int] = []  # pages a running row shares
    gone: set = set()  # keys evicted so far
    done = dict(cap_sweeps=0, pressure=0, pinned=0, reused=0, tails=0,
                empty_tail=0, again=0)
    for _ in range(steps):
        keys = set(pair.ref.index) | {("tail",) + k for k in pair.ref.tail}
        op = rng.random()
        if op < 0.6:
            seq = (heads[rng.integers(len(heads))]
                   + rng.integers(0, 3, int(rng.integers(0, 5 * ps))).tolist())
            seq = seq or [0]
            committed = int(rng.integers(1, len(seq) + 1))
            reuse = bool(rng.random() < 0.7)
            done["reused"] += reuse
            before = pair.ref.stats.prefix_evictions
            _finish(pair, seq, committed, pages, reuse,
                    int(rng.integers(0, 3)))
            done["cap_sweeps"] += pair.ref.stats.prefix_evictions > before
        elif op < 0.8:
            need = int(rng.integers(0, 6))
            freeable = bool(rng.random() < 0.7)
            done["pressure"] += 1
            done["pinned"] += freeable and any(
                p in pair.ref.pages for p in held)
            pair.both(lambda idx, kvm: idx.evict(need, freeable))
        elif op < 0.93 and pair.ref.pages:
            p = int(rng.choice(list(pair.ref.pages)))
            held.append(p)
            pair.both(lambda idx, kvm: kvm.inc_sharer(p))
        elif held:
            p = held.pop(int(rng.integers(len(held))))
            pair.both(lambda idx, kvm: kvm.dec_sharer(p))
        if rng.random() < 0.05:  # a sweep of everything it may take
            freeable = bool(rng.random() < 0.5)
            pair.both(lambda idx, kvm: idx.evict(len(idx.pages), freeable))
        now = set(pair.ref.index) | {("tail",) + k for k in pair.ref.tail}
        done["again"] += len((now - keys) & gone)
        gone |= keys - now
        done["tails"] += len(pair.ref.tail) > 0
        done["empty_tail"] += () in pair.ref.tail
    return done


@pytest.mark.parametrize("seed", range(12))
def test_the_ordered_index_evicts_as_the_reference(seed):
    done = _random_run(seed)
    assert done["cap_sweeps"] and done["pressure"] and done["reused"]
    assert done["pinned"] and done["again"]


def test_the_random_runs_reach_tails_and_the_empty_key():
    done = [_random_run(seed, steps=60) for seed in range(12)]
    assert sum(d["tails"] for d in done) and sum(d["empty_tail"] for d in done)


def test_a_stale_entry_never_wins_after_a_key_comes_back():
    """A key that is evicted and donated again ranks as a dictionary
    re-insertion: after its equals of the same length, though it first
    came before them.  Its first entry left the heap with it."""
    pair = _Pair(page_size=1, cap=100)
    pages = iter(range(1000))
    for seq in ([1, 2], [3, 4], [5, 6]):
        _finish(pair, seq, 2, pages, False, 0)
    p12 = pair.new.index[(1, 2)]
    pinned = [pair.new.index[k] for k in ((3, 4), (5, 6))]
    for p in pinned:
        pair.both(lambda idx, kvm, p=p: kvm.inc_sharer(p))
    # (3, 4) and (5, 6) are pinned: (1, 2) goes alone
    assert pair.both(lambda idx, kvm: idx.evict(1, True)) == 1
    assert (1, 2) not in pair.new.index and pair.new.examined == 1
    pair.both(lambda idx, kvm: kvm.dec_sharer(pinned[1]))
    _finish(pair, [1, 2], 2, pages, False, 0)  # back, on a new page
    assert pair.new.index[(1, 2)] != p12
    # (3, 4) is pinned: (5, 6) goes, then (1, 2)
    assert pair.both(lambda idx, kvm: idx.evict(2, True)) == 2
    assert list(pair.new.index) == [(1,), (3,), (3, 4), (5,)]
    assert pair.new.examined == 3  # (3, 4), (5, 6), (1, 2)


def _big_pair(chains=600, depth=9, ps=4):
    """An index of chains × depth keys, a tail each, under no cap."""
    pair = _Pair(page_size=ps, cap=10**9)
    pages = iter(range(10**9))
    rng = np.random.default_rng(0)
    for c in range(chains):
        seq = [c + 10] + rng.integers(0, 50, depth * ps + 1).tolist()
        _finish(pair, seq, len(seq), pages, False, 0)
    return pair


@pytest.mark.parametrize("pinned", [0, 7])
def test_a_sweep_examines_what_it_evicts(pinned):
    pair = _big_pair()
    assert len(pair.new.index) + len(pair.new.tail) >= 5000
    tails = list(pair.new.tail.values())
    for page, _ in tails[-pinned:] if pinned else []:
        pair.both(lambda idx, kvm, p=page: kvm.inc_sharer(p))
    for k in (1, 5, 40, 300):
        before = pair.new.stats.prefix_evictions
        freed = pair.both(lambda idx, kvm: idx.evict(k, True))
        evicted = pair.new.stats.prefix_evictions - before
        assert freed == evicted == k
        assert evicted <= pair.new.examined <= evicted + pinned + 2
    # the cap path: down to the cap, one finish's worth
    pair.both(lambda idx, kvm: setattr(idx, "cap", len(idx.pages) - 25))
    before = pair.new.stats.prefix_evictions
    pair.both(lambda idx, kvm: idx.enforce_cap())
    evicted = pair.new.stats.prefix_evictions - before
    assert evicted == 25 and pair.new.examined <= evicted + 2


def test_an_overwrite_keeps_the_keys_place():
    """A finish that offers keys already present — on the index's own
    pages, shared at admission, or on copies of them — leaves each key
    its place in the order and its parent's count."""
    pair = _Pair(page_size=1, cap=100)
    pages = iter(range(100))
    for seq in ([1, 2], [3, 4]):
        _finish(pair, seq, 2, pages, False, 0)
    _finish(pair, [1, 2], 2, pages, True, 0)  # the index's own pages
    _finish(pair, [1, 2], 2, pages, False, 0)  # copies: dropped
    assert list(pair.new.index) == [(1,), (1, 2), (3,), (3, 4)]
    assert pair.both(lambda idx, kvm: idx.evict(4, True)) == 4
    assert pair.new.examined == 4 and not pair.new.index


# -- the engine --------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config("olmo-1b"))
    return cfg, init_decoder_lm(cfg, seed=3, dtype=torch.float32,
                                device="cpu")


def test_the_engine_builds_one_index_and_binds_it_once(model, monkeypatch):
    """The engine's scheduler builds the port's index once: it is exactly
    a :class:`repro_torch.serving.PrefixIndex`, and the manager is bound
    once, to its pages."""
    cfg, params = model
    bound = []
    bind = KVCacheManager.bind_index

    def counted(self, pages):
        bound.append(pages)
        bind(self, pages)
    monkeypatch.setattr(KVCacheManager, "bind_index", counted)
    eng = PagedServingEngine(cfg, params, device="cpu", num_pages=14,
                             page_size=4, max_batch=3, prefix_cache=True)
    idx = eng.scheduler.index
    assert type(idx) is PrefixIndex
    assert len(bound) == 1 and bound[0] is idx.pages
    assert eng.kv_manager.index_pages == idx.pages.keys()
    assert idx.tracer is eng.tracer is eng.scheduler.tracer


def test_the_engine_serves_alike_with_the_reference_index(model):
    """Every engine holds the port's index; swapping the reference's in
    changes no token, counter or cache entry (cap and pressure sweeps)."""
    cfg, params = model
    rng = np.random.default_rng(4)
    heads = [rng.integers(0, cfg.vocab, 9).tolist() for _ in range(2)]
    prompts = [heads[i % 2] + rng.integers(0, cfg.vocab, int(k)).tolist()
               for i, k in enumerate(rng.integers(2, 11, 12))]
    runs = []
    for reference in (False, True):
        eng = PagedServingEngine(cfg, params, device="cpu", num_pages=14,
                                 page_size=4, max_batch=3, prefill_chunk=4,
                                 prefix_cache=True, prefix_cache_pages=5)
        assert type(eng.scheduler.index) is PrefixIndex
        if reference:
            old = eng.scheduler.index
            eng.scheduler.index = ReferenceIndex(old.page_size, old.cap,
                                                 eng.kv_manager, eng.stats)
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.run()
        idx = eng.scheduler.index
        runs.append(([r.generated for r in reqs], eng.stats.prefix_evictions,
                     eng.stats.prefix_hits, eng.stats.preemptions,
                     eng.stats.warnings_fired, int(eng.pool.clock),
                     list(idx.index.items()), list(idx.tail.items()),
                     list(idx.pages.items())))
    assert runs[0] == runs[1]
    assert runs[0][1] > 0 and runs[0][2] > 0

