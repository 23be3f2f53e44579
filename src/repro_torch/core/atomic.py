"""Atomic primitives preserving lock-free algorithm *structure* on CPython.

The paper's algorithms are expressed in terms of CAS / FAA / atomic loads and
stores with memory barriers.  CPython cannot express true lock-freedom (the
GIL serializes bytecode), so these shims emulate the primitives with a
per-word lock while keeping the *call structure* of the algorithms identical
to the paper's pseudocode.  All progress-relevant events (CAS failures,
barriers issued, warnings fired) are counted so benchmarks can report the
quantities the paper reasons about independently of interpreter concurrency.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field


class AtomicRef:
    """A single atomically-updatable cell (word-sized in the real system)."""

    __slots__ = ("_value", "_lock")

    def __init__(self, value=0):
        self._value = value
        self._lock = threading.Lock()

    def load(self):
        """Atomic load (an aligned load on x86-64/TSO; GIL-atomic here)."""
        return self._value

    def store(self, value) -> None:
        """Atomic store."""
        with self._lock:
            self._value = value

    def cas(self, expected, new) -> bool:
        """Compare-and-swap.  Returns True iff the swap happened."""
        with self._lock:
            if self._value == expected:
                self._value = new
                return True
            return False

    def swap(self, new):
        """Atomic exchange: store ``new``, return the previous value."""
        with self._lock:
            old = self._value
            self._value = new
            return old

    def fetch_add(self, delta=1):
        """Atomic fetch-and-add: returns the value BEFORE the addition."""
        with self._lock:
            old = self._value
            self._value = old + delta
            return old


class AtomicCounter(AtomicRef):
    """Monotonic counter used for statistics (not part of the algorithms)."""

    def increment(self, delta: int = 1) -> None:
        """Add ``delta`` (statistics only; not an algorithmic CAS site)."""
        self.fetch_add(delta)

    @property
    def value(self) -> int:
        """Current count (racy read is fine for statistics)."""
        return self._value


def memory_barrier() -> None:
    """Full fence.  On CPython the GIL gives sequential consistency; the call
    is kept so the emitted-barrier *count* matches the paper's algorithms
    (OA-BIT/OA-VER issue exactly one per reclamation batch, hazard pointers
    one per protected node)."""
    # no-op under the GIL; counted by callers that care.
    return None


@dataclass
class ReclaimStats:
    """Counters validating the paper's claims without true parallelism."""

    warnings_fired: AtomicCounter = field(default_factory=AtomicCounter)
    warnings_piggybacked: AtomicCounter = field(default_factory=AtomicCounter)
    reader_restarts: AtomicCounter = field(default_factory=AtomicCounter)
    recycling_phases: AtomicCounter = field(default_factory=AtomicCounter)
    nodes_freed: AtomicCounter = field(default_factory=AtomicCounter)
    nodes_retired: AtomicCounter = field(default_factory=AtomicCounter)
    memory_barriers: AtomicCounter = field(default_factory=AtomicCounter)
    hazard_writes: AtomicCounter = field(default_factory=AtomicCounter)

    def snapshot(self) -> dict:
        """Plain-int copy of every counter (for printing/asserting)."""
        return {
            k: getattr(self, k).value
            for k in (
                "warnings_fired",
                "warnings_piggybacked",
                "reader_restarts",
                "recycling_phases",
                "nodes_freed",
                "nodes_retired",
                "memory_barriers",
                "hazard_writes",
            )
        }
