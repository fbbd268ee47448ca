"""Runtime lock-order checker — the dynamic half of the lock-order pass
(the torch form of ``predictionio_tpu/tools/analyze/runtime.py``).

The static pass (passes/lock_order.py) sees only syntactic nesting
inside one function; a lock held while CALLING into another module is
invisible to it. This monitor closes that gap at runtime: a caller wraps
the locks it cares about (``chip_smoke.py``'s tooling phase wraps a live
quantized deploy's batcher condition and telemetry locks), drives
concurrent traffic, and asserts :meth:`LockOrderMonitor.inversions`
stays empty.

Design: :meth:`wrap` returns a proxy that forwards ``acquire`` /
``release`` / context-manager use to the real lock while maintaining a
thread-local stack of held lock NAMES. On each acquire, an edge
``held -> acquiring`` is recorded for every lock currently held by the
thread. An inversion is any pair seen in both orders — the same
two-phase shape a deadlock needs, caught even when the run never
actually interleaved into the deadlock.

Re-entrant acquires of the SAME name (RLock, or a Condition's internal
re-acquire around ``wait``) are not edges. The monitor is intentionally
tiny and dependency-free so a caller can wrap a live subsystem's locks
without perturbing timing.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Set, Tuple


class _OrderedLock:
    """Proxy forwarding to the real lock, recording acquisition order."""

    def __init__(self, monitor: "LockOrderMonitor", name: str, lock):
        self._monitor = monitor
        self._name = name
        self._lock = lock

    def acquire(self, *args, **kwargs):
        got = self._lock.acquire(*args, **kwargs)
        if got:
            self._monitor._note_acquire(self._name)
        return got

    def release(self):
        self._monitor._note_release(self._name)
        return self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # Condition-style proxying: wait/notify hand through to the real
    # object so a wrapped Condition keeps working. A Condition.wait
    # releases and re-acquires the underlying lock internally — the
    # held-stack entry stays put, which is correct: the ORDER the
    # thread originally acquired in is what deadlock analysis needs.
    def __getattr__(self, item):
        return getattr(self._lock, item)


class LockOrderMonitor:
    """Process-wide edge recorder for wrapped locks."""

    def __init__(self):
        self._tls = threading.local()
        self._graph_lock = threading.Lock()
        #: (outer, inner) -> times seen
        self._edges: Dict[Tuple[str, str], int] = {}

    def wrap(self, lock, name: str) -> _OrderedLock:
        """Proxy ``lock`` under ``name`` (install the result wherever
        the real lock lived)."""
        return _OrderedLock(self, name, lock)

    # ------------------------------------------------------------ recording
    def _held(self) -> List[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _note_acquire(self, name: str) -> None:
        held = self._held()
        new_edges = [(h, name) for h in held if h != name]
        held.append(name)
        if new_edges:
            with self._graph_lock:
                for e in new_edges:
                    self._edges[e] = self._edges.get(e, 0) + 1

    def _note_release(self, name: str) -> None:
        held = self._held()
        # release the most recent matching hold (re-entrant safe)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                break

    # ------------------------------------------------------------- verdicts
    def edges(self) -> Dict[Tuple[str, str], int]:
        with self._graph_lock:
            return dict(self._edges)

    def inversions(self) -> List[Tuple[str, str]]:
        """Lock pairs observed in both orders (deadlock shapes)."""
        with self._graph_lock:
            seen: Set[Tuple[str, str]] = set(self._edges)
        return sorted((a, b) for a, b in seen
                      if a < b and (b, a) in seen)

    def reset(self) -> None:
        with self._graph_lock:
            self._edges.clear()
