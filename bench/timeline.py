"""What a run measured, and the arithmetic the metric readers share.

A :class:`Run` holds the window ``(w0, w1]`` (host seconds), every
request's :class:`bench.drive.Rec`, the steps, the cell's family module
and spec (``bench/cells.py``), the engine's counters at both ends of the
window and, in a traced run, the scheduler's host time and the profiled
slice.  Percentiles interpolate linearly between the two nearest ranks
(numpy's default rule).
"""

from __future__ import annotations

import dataclasses
import math
import types


def percentile(values, q: float) -> float | None:
    """The ``q``-th percentile (0..100) by linear interpolation; None for
    no values."""
    s = sorted(values)
    if not s:
        return None
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def percentile_ms(values, q: float) -> float | None:
    """:func:`percentile` of values in seconds, in milliseconds."""
    p = percentile(values, q)
    return None if p is None else 1e3 * p


@dataclasses.dataclass
class Run:
    w0: float
    w1: float
    recs: list
    steps: list
    family: types.ModuleType
    spec: object
    stats_w0: dict
    stats_w1: dict
    setup_s: float = 0.0
    sched_s: float | None = None  # scheduler host time inside the window
    profile: object = None  # bench.trace.Slice of a traced run

    @property
    def window_s(self) -> float:
        return self.w1 - self.w0

    def _in(self, t: float) -> bool:
        return self.w0 < t <= self.w1

    def due(self) -> list:
        """Requests due (sent) inside the window."""
        return [r for r in self.recs if self.w0 <= r.t_due < self.w1]

    def ttfts_s(self) -> list[float]:
        """Due time to first token of every request due in the window; one
        without a first token by ``w1`` counts at its wait so far, a
        refused one as infinitely late."""
        out = []
        for r in self.due():
            if r.failed:
                out.append(math.inf)
            elif r.token_times and r.token_times[0] <= self.w1:
                out.append(r.token_times[0] - r.t_due)
            else:
                out.append(self.w1 - r.t_due)
        return out

    def itl_gaps_s(self) -> list[float]:
        """Gaps between consecutive tokens of one request whose later token
        reached the host inside the window."""
        out = []
        for r in self.recs:
            tt = r.token_times
            out.extend(tt[i] - tt[i - 1] for i in range(1, len(tt))
                       if self._in(tt[i]))
        return out

    def generated(self) -> int:
        """Generated tokens that reached the host inside the window."""
        return sum(1 for r in self.recs for t in r.token_times
                   if self._in(t))

    def window_steps(self) -> list:
        return [s for s in self.steps if self._in(s.t_end)]

    def counter(self, name: str) -> int:
        """A counter's growth over the window."""
        return self.stats_w1[name] - self.stats_w0[name]

    def admitted_prompt_tokens(self) -> int:
        """Prompt tokens of the requests first admitted inside the
        window."""
        lo, hi = self.stats_w0["steps"], self.stats_w1["steps"]
        return sum(len(r.prompt) for r in self.recs
                   if r.admitted_step is not None
                   and lo <= r.admitted_step < hi)

    def spans(self) -> list[tuple[int, int]]:
        """(c0, c1) per request whose forward ran inside the window over
        its positions c0 .. c1 - 1: its committed tokens at the window's
        ends (a request first admitted inside it starts from the prefix it
        reused)."""
        out = []
        for r in self.recs:
            if r.t_done is not None and r.t_done <= self.w0:
                continue
            if r.t_due >= self.w1:
                continue
            c0 = r.committed_w0 or 0
            if c0 == 0:
                c0 = r.prefix_reused
            c1 = (r.committed_w1 if r.committed_w1 is not None
                  else r.committed_done)
            if c1 is None or c1 <= c0:
                continue
            out.append((c0, c1))
        return out

    def model_flops(self) -> float:
        """Model FLOPs of the window's useful work, by the family's
        arithmetic over :meth:`spans` and :meth:`generated`."""
        return self.family.model_flops(self.spec, self.spans(),
                                       self.generated())
