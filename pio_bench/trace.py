"""The traced window: ``torch.profiler`` over the card, summarised in memory.

Only the device's activity is recorded (kernels, copies, fills, and the
CUDA runtime calls that go with them); no Chrome trace is written. The
summary keeps each device operation's name and interval, from which the
readers under ``layer_metrics/`` take their numbers, and names each idle
gap of the device by what the host was doing: between two timed calls
of the window, or inside one call before a given operation.

A session that records no device operation is a failure (the caller
raises), never a zero.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 96


@dataclass
class Op:
    name: str
    kind: str        # "kernel", "gpu_memcpy" or "gpu_memset"
    start_ns: int
    end_ns: int


def _activities():
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CUDA]


def discard_first_session(device: torch.device) -> None:
    """One short session thrown away: a fresh process's first session has
    been seen to drop the device's events."""
    from torch.profiler import profile

    x = torch.empty(1 << 16, device=device)
    with profile(activities=_activities()):
        x.fill_(1.0).mul_(2.0)
        torch.cuda.synchronize(device)


class Session:
    """Start before the window, stop after it; then :meth:`ops`."""

    def __init__(self):
        from torch.profiler import profile
        self._prof = profile(activities=_activities())
        self.start_ns = 0
        self.end_ns = 0

    def start(self) -> None:
        self._prof.__enter__()
        self.start_ns = time.time_ns()

    def stop(self) -> None:
        self.end_ns = time.time_ns()
        self._prof.__exit__(None, None, None)

    def ops(self) -> List[Op]:
        """The device operations the session recorded, by start time."""
        out = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            kind = _kind(e)
            if kind not in DEVICE_KINDS:
                continue
            start = int(e.start_ns())
            out.append(Op(e.name(), kind, start,
                          start + int(e.duration_ns())))
        out.sort(key=lambda op: op.start_ns)
        return out


def _kind(event) -> str:
    """The event's activity kind; from its name on a torch whose events
    do not carry one."""
    get = getattr(event, "activity_type", None)
    if get is not None:
        return get()
    name = event.name()
    return ("gpu_memcpy" if name.startswith("Memcpy") else
            "gpu_memset" if name.startswith("Memset") else "kernel")


def busy_intervals(ops: List[Op]) -> List[Tuple[int, int]]:
    """The union of the operations' intervals, merged, in order."""
    merged: List[Tuple[int, int]] = []
    for op in ops:
        if merged and op.start_ns <= merged[-1][1]:
            if op.end_ns > merged[-1][1]:
                merged[-1] = (merged[-1][0], op.end_ns)
        else:
            merged.append((op.start_ns, op.end_ns))
    return merged


def short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def top(totals: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(totals.items(),
                                      key=lambda kv: -kv[1])[:n]]


def device_op_totals(ops: List[Op]) -> Dict[str, float]:
    """Seconds of device time by operation name."""
    totals: Dict[str, float] = {}
    for op in ops:
        key = short(op.name)
        totals[key] = totals.get(key, 0.0) + (op.end_ns - op.start_ns) / 1e9
    return totals


def idle_gap_totals(ops: List[Op], start_ns: int, end_ns: int,
                    calls: List[Tuple[int, int]]) -> Dict[str, float]:
    """Seconds of device idle time in [start_ns, end_ns), by what the host
    was doing: ``calls`` are the host's (start, end) of each timed call;
    a gap that reaches outside every call is "between calls", one inside
    a call is named by the device operation that ends it."""
    first_at: Dict[int, str] = {}
    for op in ops:
        first_at.setdefault(op.start_ns, op.name)
    totals: Dict[str, float] = {}
    prev = start_ns
    for b0, b1 in busy_intervals(ops) + [(end_ns, end_ns)]:
        if b0 > prev:
            if not any(c0 <= prev and b0 <= c1 for c0, c1 in calls):
                key = "between calls (host copy, loop, next call's start)"
            else:
                key = "inside a call, before " + short(
                    first_at.get(b0, "the window's end"))
            totals[key] = totals.get(key, 0.0) + (b0 - prev) / 1e9
        prev = max(prev, b1)
    return totals


def busy_seconds(ops: List[Op], start_ns: Optional[int] = None,
                 end_ns: Optional[int] = None) -> float:
    total = 0
    for b0, b1 in busy_intervals(ops):
        if start_ns is not None:
            b0 = max(b0, start_ns)
        if end_ns is not None:
            b1 = min(b1, end_ns)
        total += max(0, b1 - b0)
    return total / 1e9
