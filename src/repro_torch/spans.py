"""Spans and counters of the serving path, recorded inside the program.

This module depends on nothing of the port, so that every layer, down to
``device.py``, can open a span.  Each engine owns a :class:`Tracer`; every
fleet replica is an engine, so no two of a fleet's threads write one
tracer.  A span records its name, its start and end on
``time.perf_counter``, its parent (the span of the same tracer open around
it), the request it is about where there is one, and counters of the work
done inside it (``attrs``).  Records live in memory,
in a ring that drops the oldest and counts what it dropped
(:attr:`Tracer.dropped`); a finished span is appended when it ends, so the
ring is in order of end times.

The process keeps the tracers it made (:func:`tracers`), so the records
outlive their engine; :func:`records_between` gathers every tracer's
records that end inside a window of the same clock, or None where a ring
no longer holds all of the window.

While ``torch.profiler`` records, each span also opens a
``record_function`` range of its own name, so a device trace carries the
spans on its own clock; otherwise a span pays one flag check for it.

Recording is on from an engine's construction; ``tracer.enabled = False``
turns it off (a span is then a shared object that records nothing).

The spans, where they are opened, and the counters they carry:

- ``engine.step`` (``PagedServingEngine.step``; ``launch_step`` to
  ``collect_step``): ``tokens``, the tokens the step committed; ``rows``,
  the rows it advanced (granted and computed), from its one read; over the
  rows live after it, ``pages_in_use`` (Σ ⌈len / page⌉) and
  ``window_dead_pages`` (Σ ⌊max(0, len − W) / page⌋ for the config's
  sliding window W; 0 without one), from the host's lengths;
- ``scheduler.admit``, ``scheduler.plan_chunk``,
  ``scheduler.plan_validate``, ``scheduler.absorb``,
  ``scheduler.maintain`` (``serving/scheduler.py``);
- ``prefix.evict`` (every sweep of the prefix index,
  ``serving/prefix_index.py``): ``keys_scanned`` (the candidates the
  sweep examined: popped from the index's heap of leaves, pinned ones and
  keys no longer leaves included), ``entries_evicted``;
- ``runner.launch`` (``ModelRunner.launch``): ``positions``, the rows
  times the chunk the launched step computes;
- ``runner.read`` (``ModelRunner.collect``): the step's one read, the
  host's wait on the device;
- ``device.read`` (``device.host_list``): every other read of the serving
  path, recorded in the tracer of the innermost span open on the thread,
  and not at all where the thread has none open;
- ``request.queued``: a request's submission to its first admission, with
  its id (a readmission after a preemption is not one).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch

#: records a tracer holds before it drops the oldest: over four times what
#: 60 s of 50 steps a second leaves at about ten records a step, so a
#: window's records outlast its warm-up and the prefix cache's fill
CAPACITY = 1 << 17

#: tracers the process keeps, newest last
TRACERS_KEPT = 64

_clock = time.perf_counter
_profiler = torch.autograd.profiler  # its flag: is a profiler recording
_ids = itertools.count(1)  # span ids, unique in the process


class _Thread(threading.local):
    def __init__(self):
        #: the spans open on this thread, of every tracer, innermost last
        self.open: list = []


_thread = _Thread()


class Span:
    """One span; its own record once it has ended."""

    __slots__ = ("name", "t0", "t1", "id", "parent", "rid", "attrs",
                 "_tracer", "_range", "_open")

    def __init__(self, tracer, name: str, rid=None):
        self._tracer = tracer
        self.name = name
        self.rid = rid
        self.attrs = None
        self._range = None

    def __enter__(self):
        stack = self._tracer._stack
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        stack.append(self)
        self._open = _thread.open
        self._open.append(self)
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        self.t1 = _clock()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        tr = self._tracer
        stack = tr._stack
        # a tracer's spans close innermost first; one left open by an error
        # closes with its parent
        if self in stack:
            while True:
                s = stack.pop()
                s._open.remove(s)
                if s is self:
                    break
        tr._append(self)
        return False

    def set(self, **counters) -> None:
        """Counters of the work done inside this span."""
        if self.attrs is None:
            self.attrs = counters
        else:
            self.attrs.update(counters)

    def get(self, counter: str, default=0):
        return default if self.attrs is None else self.attrs.get(counter,
                                                                 default)

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"{1e3 * (self.t1 - self.t0):.3f} ms, rid={self.rid}, "
                f"{self.attrs})")


class _Off:
    """The span of a tracer that is not recording."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **counters) -> None:
        pass


_OFF = _Off()


class Tracer:
    """The spans of one engine (module docstring)."""

    def __init__(self, capacity: int = CAPACITY):
        #: record spans (False: every span is a no-op)
        self.enabled = True
        self.capacity = int(capacity)
        self.records: collections.deque = collections.deque(
            maxlen=self.capacity)
        #: records the ring has dropped, and the end of the last dropped
        self.dropped = 0
        self.dropped_until = float("-inf")
        self._stack: list[Span] = []

    def span(self, name: str, rid=None):
        """A span to use as a context manager, nested in the one open."""
        return Span(self, name, rid) if self.enabled else _OFF

    def begin(self, name: str, rid=None):
        """Open a span that another call closes (:meth:`end`)."""
        return self.span(name, rid).__enter__()

    @staticmethod
    def end(span) -> None:
        span.__exit__(None, None, None)

    def add(self, name: str, t0: float, t1: float, rid=None,
            **counters) -> None:
        """Record a span whose times were taken apart from the stack (a
        request's wait), with no parent."""
        if not self.enabled:
            return
        s = Span(self, name, rid)
        s.id, s.parent, s.t0, s.t1 = next(_ids), None, t0, t1
        if counters:
            s.attrs = counters
        self._append(s)

    def _append(self, span: Span) -> None:
        if len(self.records) == self.capacity:
            self.dropped += 1
            self.dropped_until = self.records[0].t1
        self.records.append(span)


_TRACERS: collections.deque = collections.deque(maxlen=TRACERS_KEPT)


def new_tracer(capacity: int = CAPACITY) -> Tracer:
    """A tracer the process keeps (:func:`tracers`)."""
    tr = Tracer(capacity)
    _TRACERS.append(tr)
    return tr


def tracers() -> list[Tracer]:
    """The tracers the process keeps, oldest first."""
    return list(_TRACERS)


def current_span(name: str):
    """A span of the tracer of the innermost span open on this thread, or a
    no-op where the thread has none open."""
    opened = _thread.open
    return opened[-1]._tracer.span(name) if opened else _OFF


def records_between(w0: float, w1: float):
    """Every kept tracer's records that end in ``(w0, w1]``
    (``time.perf_counter`` seconds), in each tracer's order; None where a
    tracer with records there has dropped one that ended after ``w0``."""
    out = []
    for tr in tracers():
        inside = [r for r in list(tr.records) if w0 < r.t1 <= w1]
        if inside and tr.dropped_until > w0:
            return None
        out.extend(inside)
    return out


def self_times(records) -> dict:
    """Seconds by span name, less the time of each span's children among
    ``records``."""
    out: dict = collections.defaultdict(float)
    name_of = {r.id: r.name for r in records}
    for r in records:
        out[r.name] += r.t1 - r.t0
        if r.parent in name_of:
            out[name_of[r.parent]] -= r.t1 - r.t0
    return dict(out)
