"""The program's own spans, for the readers that lay them over the traced
window: the ``als.gram`` spans that ``predictionio_tpu_torch.common.
tracing`` records (name, thread, start and end on the profiler's clock,
attrs) while a ``torch.profiler`` session runs."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

GRAM = "als.gram"
#: what each ``als.gram`` span carries: the side, the Gram's chunks, the
#: entries it looped over (padding included) and of those the padding
GRAM_ATTRS = ("side", "chunks", "entries", "padding")


def gram_spans() -> Optional[list]:
    """The ``als.gram`` spans the program recorded, by start. None where
    the program keeps no profiler ring, where it recorded no such span
    or one without its attrs, and where the ring dropped any span: a
    window with spans missing would read wrong, not low."""
    try:
        from predictionio_tpu_torch.common.tracing import profiler_spans
    except ImportError:
        return None
    recorded, dropped = profiler_spans()
    grams = sorted((s for s in recorded if s.name == GRAM),
                   key=lambda s: s.start_ns)
    if dropped or not grams or any(k not in s.attrs for s in grams
                                   for k in GRAM_ATTRS):
        return None
    return grams


def overlap_ns(a: Sequence[Tuple[int, int]],
               b: Sequence[Tuple[int, int]]) -> int:
    """The length of the intersection of two unions of intervals, each
    given merged and in order (``trace.busy_intervals``)."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
