"""A traced run's instruments, installed from outside the program.

- :func:`time_scheduler`: wrappers on the engine's scheduler object (its
  ``admit``, ``plan_chunk``, ``plan_validate``, ``absorb`` and
  ``maintain``) and on its runner's ``launch`` and ``collect``: each adds
  its host time to a tally while the window is open, and names a
  profiler range, so an idle gap on the device can be laid to what the
  host was doing then.
- :func:`profile_slice`: ``torch.profiler`` over a short slice of steady
  steps after the window (the same traffic, continued).  The first step
  of the slice is dropped; the device's busy time is the union of the
  device operations' intervals inside the slice.  Where the trace holds
  fewer fused-attention launches than the family's launches a step
  (``attention_launches``) × steps (a trace has been seen to miss
  launches on this card), the slice is taken again, three times at most,
  and the last one is kept with its count.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from collections import defaultdict

SCHED_METHODS = ("admit", "plan_chunk", "plan_validate", "absorb", "maintain")
RUNNER_METHODS = ("launch", "collect")
ATTN_KERNEL = "paged_attention_kernel"
STEP_RANGE = "bench.step"


def time_scheduler(eng, loop) -> dict:
    """Install the wrappers; returns the tally ``{"sched_s": seconds}``
    of scheduler host time inside the window."""
    from torch.profiler import record_function

    tally = {"sched_s": 0.0}

    def wrap(obj, name, counted):
        fn = getattr(obj, name)

        @functools.wraps(fn)
        def timed(*a, **k):
            t = time.perf_counter()
            try:
                with record_function(name):
                    return fn(*a, **k)
            finally:
                if counted and loop.w0 is not None and loop.w1 is None:
                    tally["sched_s"] += time.perf_counter() - t
        setattr(obj, name, timed)

    for name in SCHED_METHODS:
        wrap(eng.scheduler, name, True)
    for name in RUNNER_METHODS:
        wrap(eng.runner, name, False)
    step = eng.step

    def traced_step(*a, **k):
        with record_function(STEP_RANGE):
            return step(*a, **k)
    eng.step = traced_step
    return tally


@dataclasses.dataclass
class Slice:
    """A profiled slice: its seconds, the device operations inside it as
    (name, start s, end s), the host ranges as (name, start s, end s), the
    steps kept (with rows) and the fused-attention launches seen against
    those expected."""

    t0: float
    t1: float
    ops: list
    ranges: list
    steps: list
    launches: int
    expected: int

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> list:
        """The union of the device operations' intervals, merged."""
        out = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def op_seconds(self, match: str) -> float:
        """Device seconds of the operations whose name holds ``match``."""
        return sum(b - a for n, a, b in self.ops if match in n)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the innermost host range open at each gap's middle."""
        by_op = defaultdict(float)
        for n, a, b in self.ops:
            by_op[n[:120]] += b - a
        gaps = defaultdict(float)
        edges = [self.t0] + [x for iv in self.busy() for x in iv] + [self.t1]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            inner = [r for r in self.ranges if r[1] <= mid <= r[2]]
            label = (min(inner, key=lambda r: r[2] - r[1])[0] if inner
                     else "outside the engine's step")
            gaps[label] += b - a
        return {k: sorted(v.items(), key=lambda kv: -kv[1])[:top]
                for k, v in (("device_ops", by_op), ("idle_gaps", gaps))}


def _take(loop, steps: int, per_step: int) -> Slice:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    loop.record_rows = True
    first = len(loop.steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        while len(loop.steps) < first + steps + 1:
            loop.more()
        torch.cuda.synchronize()
    loop.record_rows = False
    ops, ranges, step_ranges = [], [], []
    ours = set(SCHED_METHODS + RUNNER_METHODS + (STEP_RANGE,))
    for ev in prof.events():
        a, b = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.device_type == DeviceType.CUDA:
            # a host range also shows on the device's timeline, as an
            # annotation over the operations it launched: not an operation
            if ev.name not in ours and not getattr(
                    ev, "is_user_annotation", False):
                ops.append((ev.name, a, b))
        elif ev.name == STEP_RANGE:
            step_ranges.append((a, b))
        elif ev.name in SCHED_METHODS + RUNNER_METHODS:
            ranges.append((ev.name, a, b))
    step_ranges.sort()
    kept = loop.steps[first + 1:first + steps + 1]
    t0 = step_ranges[1][0]
    t1 = step_ranges[-1][1]
    # a step's device work may run past its host range's end: the slice
    # ends with the last operation of the last step
    t1 = max([t1] + [b for _, a, b in ops if a >= t0])
    ops = [(n, max(a, t0), min(b, t1)) for n, a, b in ops
           if b > t0 and a < t1]
    ranges += [(STEP_RANGE, a, b) for a, b in step_ranges]
    launches = sum(1 for n, _, _ in ops if ATTN_KERNEL in n)
    return Slice(t0, t1, ops, ranges, kept, launches, per_step * len(kept))


def profile_slice(loop, steps: int, per_step: int,
                  attempts: int = 3) -> Slice:
    """Profile ``steps`` steady steps (plus one dropped), which launch
    ``paged_attention_kernel`` ``per_step`` times each; module
    docstring."""
    for _ in range(attempts):
        sl = _take(loop, steps, per_step)
        if sl.launches == sl.expected:
            break
    return sl
