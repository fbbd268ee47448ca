"""Request-scoped degradation flag (port of the degraded scope of
``predictionio_tpu/common/resilience.py``).

A serve-time side-channel lookup that fails (an e-commerce engine's
seen-items, unavailable-items or recent-views read from the event store)
answers from a fallback and calls :func:`note_degraded`; the query
server opens a scope per request (or per flush) with
:func:`reset_degraded` and reads it back with :func:`pop_degraded` to
flag the answer ``"degraded": true``. The reference's journal emit,
retries, circuit breaker and ``PIO_FAULT_SPEC`` are not ported yet.
"""

from __future__ import annotations

import logging
import threading
from typing import Tuple

logger = logging.getLogger("predictionio_tpu_torch.resilience")

_tls = threading.local()
_degraded_total = 0
_degraded_lock = threading.Lock()


def reset_degraded() -> None:
    """Start a fresh request scope on this thread."""
    _tls.reasons = []


def note_degraded(reason: str) -> None:
    """Record a soft failure. Safe to call anywhere: outside a request
    scope it only bumps the process counter."""
    global _degraded_total
    reasons = getattr(_tls, "reasons", None)
    if reasons is not None:
        reasons.append(reason)
    with _degraded_lock:
        _degraded_total += 1
    logger.warning("degraded: %s", reason)


def pop_degraded() -> Tuple[str, ...]:
    """Reasons recorded on this thread since :func:`reset_degraded`,
    closing the scope."""
    reasons = tuple(getattr(_tls, "reasons", ()) or ())
    _tls.reasons = None
    return reasons


def degraded_total() -> int:
    """Soft failures noted in this process."""
    with _degraded_lock:
        return _degraded_total
