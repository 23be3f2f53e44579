"""The port's open-loop traffic against the JAX package's, on the CPU.

``repro_torch/serving/traffic.py`` is a copy of the host-only original
(drift-checked in ``tests/test_torch_engine.py``).  Here: the same seed
dumps byte-identical JSONL from both packages, each reads the other's
file, and a bursty two-class trace replayed open-loop on a virtual clock
through the port's engine gives the JAX engine's tokens, per-class counts
and latency percentiles, and integer counters, exactly.  Weights are
float32 on both sides (``tests/test_torch_engine.py`` says why).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.models.transformer import init_decoder_lm
from repro.serving import PagedServingEngine as JaxEngine
from repro.serving import traffic as jtraffic
from repro_torch.configs import get_config as tget, reduced as treduced
from repro_torch.convert import model_from_jax
from repro_torch.serving import (PagedServingEngine, dump_trace, load_trace,
                                 replay_arrivals, synthesize_trace)
from test_torch_engine import _int_stats

torch.set_num_threads(1)

TRACES = {
    "poisson": dict(duration_s=20.0, rate_rps=3.0),
    "bursty_three_class": dict(
        duration_s=10.0, rate_rps=4.0, process="bursty",
        class_mix={"interactive": 0.6, "batch": 0.3, "background": 0.1}),
    "heavy_tail": dict(duration_s=5.0, rate_rps=8.0, tail_frac=0.5,
                       prompt_mean=64, max_new_mean=48),
}


@pytest.mark.parametrize("name", list(TRACES))
def test_same_seed_dumps_the_same_bytes(tmp_path, name):
    kw = TRACES[name]
    ours = synthesize_trace(11, **kw)
    theirs = jtraffic.synthesize_trace(11, **kw)
    assert [dataclasses.astuple(e) for e in ours] == \
        [dataclasses.astuple(e) for e in theirs]
    a, b = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    dump_trace(ours, str(a))
    jtraffic.dump_trace(theirs, str(b))
    assert a.read_bytes() == b.read_bytes()
    assert load_trace(str(b)) == ours  # each package reads the other's
    assert [dataclasses.astuple(e) for e in jtraffic.load_trace(str(a))] == \
        [dataclasses.astuple(e) for e in ours]
    assert [e.prompt(512) for e in ours] == [e.prompt(512) for e in theirs]


class VirtualClock:
    """Seconds that advance only when the driver says so."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _replay(eng, clock, events, vocab, dt=0.05):
    """Open-loop replay on the virtual clock: arrivals due by ``clock.t``
    are submitted whatever the engine's state, then one step; the clock
    moves ``dt`` a loop.  Returns the submitted requests."""
    reqs, cursor = [], 0
    for _ in range(10_000):
        due, cursor = replay_arrivals(events, clock.t, cursor)
        reqs += [eng.submit(ev.prompt(vocab), ev.max_new, cls=ev.cls)
                 for ev in due]
        eng.scheduler.admit()
        if eng.scheduler.running:
            eng.step()
            eng.scheduler.maintain()
        elif cursor == len(events) and not eng.scheduler.queue:
            return reqs
        clock.t += dt
    raise AssertionError("replay did not drain")


@pytest.fixture(scope="module")
def weights():
    jc = dataclasses.replace(jreduced(jget("olmo-1b")), n_layers=1)
    tc = dataclasses.replace(treduced(tget("olmo-1b")), n_layers=1)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      init_decoder_lm(jc, jax.random.PRNGKey(0)))
    tm = model_from_jax(tc, jax.tree.map(np.asarray, jp), dtype=torch.float32,
                        device="cpu")
    return jc, jp, tc, tm


def test_virtual_clock_replay_matches_reference(weights):
    jc, jp, tc, tm = weights
    events = synthesize_trace(5, duration_s=3.0, rate_rps=6.0,
                              process="bursty",
                              class_mix={"interactive": 0.7, "batch": 0.3},
                              prompt_mean=6, max_new_mean=4, prompt_cap=12,
                              max_new_cap=8)
    assert len({e.cls for e in events}) == 2
    kw = dict(num_pages=24, page_size=4, max_batch=3, max_pages_per_seq=6,
              prefill_chunk=4)
    out = []
    for make in (lambda c: JaxEngine(jc, jp, clock=c, **kw),
                 lambda c: PagedServingEngine(tc, tm, clock=c, device="cpu",
                                              **kw)):
        clock = VirtualClock()
        eng = make(clock)
        reqs = _replay(eng, clock, events, tc.vocab)
        assert not any(r.state not in ("finished", "shed", "rejected")
                       for r in reqs)  # nothing lost
        classes = {n: (cs.submitted, cs.finished, cs.shed, cs.rejected,
                       cs.percentiles())
                   for n, cs in sorted(eng.stats.class_stats.items())}
        out.append(([r.generated for r in reqs], classes,
                    _int_stats(eng.stats), eng.stats.warnings_fired,
                    int(eng.pool.clock)))
    assert out[1] == out[0]
    assert sum(c[1] for c in out[1][1].values()) > 0
