"""Open-loop traffic: arrival processes, heavy-tail length mixtures and a
replayable JSONL trace format.

Closed-loop drivers (submit N, drain, repeat) hide overload by
construction: the offered load collapses to whatever the engine can
absorb, so tail latency under pressure is never exercised.  The harness
here is OPEN-LOOP — arrival times come from a seeded stochastic process
that does not care how busy the engine is:

- ``poisson``: memoryless arrivals at a fixed rate (the M/G/k baseline).
- ``bursty``: a two-state Markov-modulated Poisson process — exponential
  ON/OFF dwell times, ON bursts at ``burst_factor``× the base rate, OFF
  idles at a trickle.  This is the reference overload shape: sustained
  bursts that outrun capacity, gaps that let the degradation ladder and
  the adaptive release policy recover.

Request shapes are heavy-tailed (a lognormal body with a lognormal far
tail mixed in) and multi-tenant: each event carries a service class drawn
from a configured mix.  Everything is derived from one ``numpy``
Generator seed, and ``dump_trace``/``load_trace`` round-trip the schedule
through JSONL **byte-identically** — re-synthesizing with the same seed
and re-dumping produces the same file, so a benchmark run names its
workload by ``(seed, params)`` and anyone can replay it exactly.

Host-only module: numpy for the RNG, no jax, no serving imports — both
``launch/serve.py`` and ``benchmarks/traffic.py`` drive engines with it.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

#: JSONL schema version; bumped only on incompatible field changes.
TRACE_VERSION = 1

_FIELDS = ("t", "cls", "prompt_len", "max_new", "prompt_seed")


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One request arrival: ``t`` seconds from trace start (monotone
    non-decreasing within a trace), its service class, its prompt/output
    lengths, and the seed its synthetic prompt tokens derive from (the
    replay is fully determined by the event — no ambient RNG)."""

    t: float
    cls: str
    prompt_len: int
    max_new: int
    prompt_seed: int

    def prompt(self, vocab_size: int) -> list[int]:
        """The event's deterministic synthetic prompt: ``prompt_len``
        tokens from its own seeded Generator (ids start at 2 — 0/1 stay
        free for pad/BOS conventions)."""
        rng = np.random.default_rng(self.prompt_seed)
        hi = max(3, vocab_size - 1)
        return [int(x) for x in rng.integers(2, hi, size=self.prompt_len)]


def synthesize_trace(seed: int, *, duration_s: float, rate_rps: float,
                     process: str = "poisson",
                     class_mix: dict[str, float] | None = None,
                     burst_factor: float = 4.0, on_mean_s: float = 2.0,
                     off_mean_s: float = 2.0, idle_factor: float = 0.1,
                     prompt_mean: int = 32, max_new_mean: int = 16,
                     tail_frac: float = 0.1, tail_scale: float = 4.0,
                     prompt_cap: int = 512,
                     max_new_cap: int = 256) -> list[TraceEvent]:
    """Generate one open-loop schedule (module docstring).

    ``rate_rps`` is the long-run offered rate; ``bursty`` redistributes it
    into ON periods of ``burst_factor``× intensity and OFF periods at
    ``idle_factor``×, with exponential dwell times (``on_mean_s`` /
    ``off_mean_s``).  The two phase rates are normalized by the expected
    phase occupancy so the long-run mean still EQUALS ``rate_rps`` — a
    benchmark dialing in "0.6x capacity" must get 0.6x, not 0.6x times
    the burst factor's whim.  Lengths are lognormal around the means with a
    ``tail_frac`` admixture stretched by ``tail_scale`` (heavy tail),
    clipped to the caps.  Deterministic in ``seed`` and the parameters."""
    if process not in ("poisson", "bursty"):
        raise ValueError(f"unknown arrival process {process!r}; "
                         f"choose 'poisson' or 'bursty'")
    if rate_rps <= 0 or duration_s <= 0:
        raise ValueError("rate_rps and duration_s must be positive")
    mix = dict(class_mix or {"interactive": 1.0})
    if any(w < 0 for w in mix.values()) or sum(mix.values()) <= 0:
        raise ValueError(f"class mix weights must be non-negative and "
                         f"sum > 0, got {mix}")
    names = sorted(mix)
    weights = np.array([mix[n] for n in names], dtype=np.float64)
    weights = weights / weights.sum()
    rng = np.random.default_rng(seed)

    # normalize the bursty phase intensities so the LONG-RUN rate is
    # rate_rps: E[rate] = p_on*burst + p_off*idle must equal 1x
    p_on = on_mean_s / max(on_mean_s + off_mean_s, 1e-9)
    norm = 1.0 / max(p_on * burst_factor + (1.0 - p_on) * idle_factor, 1e-9)

    events: list[TraceEvent] = []
    t = 0.0
    # bursty state: start ON so short traces still contain a burst
    on = True
    phase_end = (float(rng.exponential(on_mean_s))
                 if process == "bursty" else float("inf"))
    while True:
        rate = rate_rps
        if process == "bursty":
            rate = rate_rps * norm * (burst_factor if on else idle_factor)
        t += float(rng.exponential(1.0 / max(rate, 1e-9)))
        while process == "bursty" and t >= phase_end:
            # phase flip: re-draw the arrival from the new phase's rate
            # (approximation: carry the overshoot into the new phase)
            on = not on
            phase_end += float(rng.exponential(
                on_mean_s if on else off_mean_s))
        if t >= duration_s:
            break

        def length(mean: int, cap: int) -> int:
            # lognormal body (sigma 0.6 ≈ a 2× spread) with a stretched
            # far tail mixed in at tail_frac
            mu = np.log(max(mean, 1))
            scale = tail_scale if rng.random() < tail_frac else 1.0
            x = scale * float(rng.lognormal(mu, 0.6))
            return int(max(1, min(cap, round(x))))

        events.append(TraceEvent(
            t=round(t, 6),
            cls=names[int(rng.choice(len(names), p=weights))],
            prompt_len=length(prompt_mean, prompt_cap),
            max_new=length(max_new_mean, max_new_cap),
            prompt_seed=int(rng.integers(0, 2**31 - 1))))
    return events


def dump_trace(events: list[TraceEvent], path: str) -> None:
    """Write a JSONL trace: a header line, then one event per line in
    arrival order.  Canonical field order + repr, so identical schedules
    serialize to identical bytes (the replay-exactness contract)."""
    with open(path, "w") as f:
        f.write(json.dumps({"trace_version": TRACE_VERSION}) + "\n")
        for ev in events:
            f.write(json.dumps({k: getattr(ev, k) for k in _FIELDS}) + "\n")


def load_trace(path: str) -> list[TraceEvent]:
    """Read a JSONL trace back into events (arrival order enforced)."""
    events: list[TraceEvent] = []
    with open(path) as f:
        header = json.loads(f.readline())
        if header.get("trace_version") != TRACE_VERSION:
            raise ValueError(
                f"unsupported trace version {header.get('trace_version')!r} "
                f"(this build reads version {TRACE_VERSION})")
        for line in f:
            if line.strip():
                events.append(TraceEvent(**json.loads(line)))
    last = 0.0
    for ev in events:
        if ev.t < last:
            raise ValueError(f"trace not in arrival order at t={ev.t}")
        last = ev.t
    return events


def replay_arrivals(events: list[TraceEvent], now_s: float,
                    cursor: int) -> tuple[list[TraceEvent], int]:
    """Open-loop replay helper: the events due at or before ``now_s``
    starting from ``cursor``, plus the advanced cursor.  The driver owns
    the clock — wall time for a live server, virtual time for a
    deterministic benchmark — and calls this once per loop iteration;
    arrivals are never delayed by a busy engine (that is the point)."""
    due: list[TraceEvent] = []
    while cursor < len(events) and events[cursor].t <= now_s:
        due.append(events[cursor])
        cursor += 1
    return due, cursor
