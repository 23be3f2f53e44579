"""The one traffic generator: a mix file (``bench/traffic/<mix>.json``) and
a seed in, the requests of a run out.

Sizes and arrival gaps come from the mix's own ``shape_seed`` through
:func:`synthesize_trace`, a frozen copy of the program's
``repro_torch/serving/traffic.py::synthesize_trace`` (lognormal lengths
around a median with a stretched tail, Poisson or bursty arrivals).  The
run's seed only permutes them (which gap, which sizes and which shared
prefix come when; in the open loop inside each of the warm-up, the window
and what follows) and draws the token ids.  So every seed serves the same
set of sizes and arrivals in another order, and two seeds differ in the
order of the work, not in its amount.

Mix keys:

- ``loop``: ``open`` (arrivals on a schedule, whatever the engine does) or
  ``closed`` (``clients`` callers, each sending its next request when the
  last one finished, with no think time);
- ``process``, ``rate_rps``, ``warmup_s``, ``tail_s``: the open loop's
  arrival process, its long-run rate (a cell sets it), the seconds of
  arrivals served before the window opens and drawn after it closes;
- ``clients``, ``warmup_completions``: the closed loop's callers, and the
  completions served before the window opens (the first request of each
  caller has its output cut to a uniform share of its length, so the
  callers start out of step, as they run in a steady state);
- ``prompt_median``/``prompt_cap``, ``output_median``/``output_cap``,
  ``tail_frac``/``tail_scale``: lengths in tokens;
- ``shared_prefix``: ``count`` system prompts of ``tokens`` tokens, one of
  them ahead of every prompt, chosen by Zipf popularity ``zipf_s``;
- ``fill_cache``: before the warm-up, the engine's prefix cache is filled
  to its cap by the mix's own earlier requests (``bench/drive.py``), so
  the window opens with the cache as full as a deployment's runs it:
  :meth:`Traffic.fill_specs` gives their sizes, :meth:`Traffic.fill_prompt`
  each one's prompt and output as one prompt.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One arrival of the copied generator: ``t`` seconds from the start,
    its service class, prompt and output lengths and a prompt seed."""

    t: float
    cls: str
    prompt_len: int
    max_new: int
    prompt_seed: int


def synthesize_trace(seed: int, *, duration_s: float, rate_rps: float,
                     process: str = "poisson",
                     class_mix: dict[str, float] | None = None,
                     burst_factor: float = 4.0, on_mean_s: float = 2.0,
                     off_mean_s: float = 2.0, idle_factor: float = 0.1,
                     prompt_mean: int = 32, max_new_mean: int = 16,
                     tail_frac: float = 0.1, tail_scale: float = 4.0,
                     prompt_cap: int = 512,
                     max_new_cap: int = 256) -> list[TraceEvent]:
    """Frozen copy of ``repro_torch.serving.traffic.synthesize_trace``: an
    open-loop schedule, lognormal lengths (sigma 0.6) with a ``tail_frac``
    admixture stretched by ``tail_scale``, clipped to the caps; bursty
    arrivals normalised so the long-run rate is ``rate_rps``."""
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
    p_on = on_mean_s / max(on_mean_s + off_mean_s, 1e-9)
    norm = 1.0 / max(p_on * burst_factor + (1.0 - p_on) * idle_factor, 1e-9)
    events: list[TraceEvent] = []
    t = 0.0
    on = True
    phase_end = (float(rng.exponential(on_mean_s))
                 if process == "bursty" else float("inf"))
    while True:
        rate = rate_rps
        if process == "bursty":
            rate = rate_rps * norm * (burst_factor if on else idle_factor)
        t += float(rng.exponential(1.0 / max(rate, 1e-9)))
        while process == "bursty" and t >= phase_end:
            on = not on
            phase_end += float(rng.exponential(
                on_mean_s if on else off_mean_s))
        if t >= duration_s:
            break

        def length(mean: int, cap: int) -> int:
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


@dataclasses.dataclass
class Spec:
    """One request to send: its user-turn length, output length, the shared
    system prompt ahead of it (``prefix``, −1: none) and the key its token
    ids are drawn from (:meth:`Traffic.prompt`)."""

    user_len: int
    max_new: int
    prefix: int
    key: int


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, *stream])


class Traffic:
    """A mix under one seed (module docstring).  ``arrivals(horizon_s)``
    gives the open loop's (due seconds, spec) pairs; ``client_specs(n)``
    the closed loop's first ``n`` requests of each caller, in order;
    ``prompt(spec)`` a spec's token ids."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix = mix
        self.seed = int(seed)
        self.vocab = vocab
        self.loop = mix["loop"]
        if self.loop not in ("open", "closed"):
            raise ValueError(f"unknown loop {self.loop!r}")
        sp = mix.get("shared_prefix")
        self.prefixes = []
        self._zipf = None
        if sp:
            rng = _rng(seed, 1)
            self.prefixes = [self._tokens(rng, sp["tokens"])
                             for _ in range(sp["count"])]
            ranks = np.arange(1, sp["count"] + 1, dtype=np.float64)
            w = ranks ** -float(sp.get("zipf_s", 1.0))
            self._zipf = w / w.sum()
            # which prompt is the most popular: the seed's choice
            self._rank_to_prefix = rng.permutation(sp["count"])

    def _tokens(self, rng, n: int) -> list:
        return rng.integers(2, max(3, self.vocab - 1), size=n).tolist()

    def prompt(self, spec: Spec) -> list:
        """The spec's prompt: its system prompt, then its user turn."""
        user = self._tokens(_rng(self.seed, 2, spec.key), spec.user_len)
        return (self.prefixes[spec.prefix] + user if spec.prefix >= 0
                else user)

    def _events(self, duration_s: float, rate_rps: float):
        m = self.mix
        return synthesize_trace(
            int(m["shape_seed"]), duration_s=duration_s, rate_rps=rate_rps,
            process=m.get("process", "poisson"),
            prompt_mean=int(m["prompt_median"]),
            max_new_mean=int(m["output_median"]),
            tail_frac=float(m.get("tail_frac", 0.1)),
            tail_scale=float(m.get("tail_scale", 4.0)),
            prompt_cap=int(m["prompt_cap"]),
            max_new_cap=int(m["output_cap"]))

    def _specs(self, events, stream: int) -> list[Spec]:
        """The events' sizes (and, where prompts share prefixes, a Zipf
        draw of the mix's own each) in the seed's order."""
        shape = np.random.default_rng([int(self.mix["shape_seed"]), 1,
                                       stream])
        ranks = (shape.choice(len(self._zipf), size=len(events), p=self._zipf)
                 if self._zipf is not None else None)
        order = _rng(self.seed, stream).permutation(len(events))
        return [Spec(events[i].prompt_len, events[i].max_new,
                     -1 if ranks is None
                     else int(self._rank_to_prefix[ranks[i]]),
                     stream * 2**32 + k)
                for k, i in enumerate(order)]

    def arrivals(self, bounds) -> list[tuple[float, Spec]]:
        """Open loop: (due seconds from the start, spec), in due order, for
        arrivals in ``[bounds[0], bounds[-1])``.  The seed permutes the
        gaps and the sizes inside each span between two bounds (the
        warm-up, the window, what follows it), so every span holds the
        same arrivals whatever the seed."""
        rate = float(self.mix["rate_rps"])
        events = self._events(float(bounds[-1]), rate)
        out = []
        for k, (a, b) in enumerate(zip(bounds, bounds[1:])):
            span = [ev for ev in events if a <= ev.t < b]
            gaps = np.diff([a] + [ev.t for ev in span])
            gaps = gaps[_rng(self.seed, 3, k).permutation(len(gaps))]
            specs = self._specs(span, 4 + k)
            out += zip((a + np.cumsum(gaps)).tolist(), specs)
        return out

    def fill_specs(self, n: int) -> list[Spec]:
        """The mix's ``n`` earlier requests, sizes in the seed's order."""
        events = self._events(1.25 * n + 50, 1.0)[:n]
        return self._specs(events, 7)

    def fill_prompt(self, spec: Spec) -> list:
        """An earlier request as the cache keeps it once it finished: its
        prompt, then all but the last of ``max_new`` output tokens (drawn
        from the seed), to be served with one token generated."""
        out = self._tokens(_rng(self.seed, 8, spec.key), spec.max_new - 1)
        return self.prompt(spec) + out

    def client_specs(self, per_client: int) -> list[list[Spec]]:
        """Closed loop: each caller's first ``per_client`` requests, the
        first with its output cut to a uniform share (module docstring)."""
        n = int(self.mix["clients"])
        total = n * per_client
        # at 1 request a second, 1.25·total + 50 seconds hold `total`
        # arrivals but for a draw about 6 standard deviations short
        events = self._events(1.25 * total + 50, 1.0)[:total]
        if len(events) < total:
            raise ValueError(f"drew {len(events)} requests, need {total}")
        specs = self._specs(events, 5)
        cut = np.random.default_rng([int(self.mix["shape_seed"]), 2]).random(n)
        cut = cut[_rng(self.seed, 6).permutation(n)]
        lanes = [specs[c::n] for c in range(n)]
        for c, lane in enumerate(lanes):
            lane[0] = dataclasses.replace(
                lane[0], max_new=max(1, math.ceil(cut[c] * lane[0].max_new)))
        return lanes
