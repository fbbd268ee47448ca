"""On-demand device profiling for long-lived daemons (the torch form of
``predictionio_tpu/common/profiling.py``).

"Restart it with ``--profile``" is not a way to capture a device trace
from a replica that is slow RIGHT NOW. This module gives every daemon a
bounded capture endpoint:

    POST /debug/profile?ms=2000[&dir=...]   start a capture (202), or
                                            409 while one is running
    GET  /debug/profile                     list captures + active state

Where the reference calls ``jax.profiler.start_trace``/``stop_trace``, a
capture here runs ``torch.profiler.profile`` with the CPU activity and,
where the process can see a card, the CUDA one, and exports a Chrome
trace (``trace.json``; open it in Perfetto or ``chrome://tracing``).

- **One thread owns a capture.** The profiler is started and stopped on
  the same thread: a thread of the capture's own for the endpoint, the
  calling thread for :class:`trace`. CUDA activity (CUPTI) is recorded
  for the whole process, so kernels launched by other threads — the
  batcher's worker, which launches the serving kernels — land in the
  trace with their runtime launch; CPU operators are recorded on the
  owning thread only.
- **Hard max duration** — ``ms`` is clamped to ``PIO_PROFILE_MAX_MS``
  (default 10 000).
- **Single concurrent capture** — the profiler is process-global, so a
  second POST while one runs answers 409. ``pio train --profile DIR``
  shares the same guard via :func:`trace`.
- **Artifacts on disk, listed not streamed** — each capture lands in
  ``<base>/<capture-id>/`` (``PIO_PROFILE_DIR``, default
  ``<tmp>/pio-profiles``) with a ``capture.json`` metadata file;
  ``GET /debug/profile`` lists paths and sizes.
- **Confined writes** — the ``dir`` override is resolved against
  ``PIO_PROFILE_DIR`` and refused (400) if it escapes it — absolute
  paths, ``..`` hops and symlink detours included.
  ``PIO_PROFILE_ENABLE=0`` turns the POST surface off (403; the GET
  listing stays).

``pio profile <url> --ms 2000`` (tools/profile.py) drives the endpoint
against a live server and waits for the artifact listing.

A running capture slows every launch it records; the capture window's
latencies are not the server's.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import os
import tempfile
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger("predictionio_tpu_torch.profiling")

DEFAULT_MS = 2000
_HISTORY = 16
#: the Chrome trace each capture writes into its directory
TRACE_FILE = "trace.json"

_lock = threading.Lock()
_active: Optional[Dict[str, Any]] = None
_captures: List[Dict[str, Any]] = []


class CaptureBusy(Exception):
    """A capture is already running (the profiler is process-global)."""


def max_ms() -> int:
    raw = os.environ.get("PIO_PROFILE_MAX_MS", "")
    try:
        return max(1, int(raw)) if raw else 10_000
    except ValueError:
        return 10_000


def base_dir() -> str:
    return (os.environ.get("PIO_PROFILE_DIR")
            or os.path.join(tempfile.gettempdir(), "pio-profiles"))


def post_enabled() -> bool:
    """May HTTP clients start captures? ``PIO_PROFILE_ENABLE=0`` turns
    the POST surface off (403); GET listing and the in-process paths
    (:func:`start_capture`, :class:`trace`) are unaffected."""
    return os.environ.get("PIO_PROFILE_ENABLE", "1") != "0"


def resolve_http_dir(raw: Optional[str]) -> Optional[str]:
    """Confine an HTTP-supplied ``dir`` override to :func:`base_dir`.

    The debug surface is unauthenticated, so the query param must never
    become an arbitrary-path write primitive: the value is resolved
    (``realpath``, so ``..`` and symlink escapes collapse) and must stay
    under the operator-configured base. Returns the resolved directory,
    or None when no override was given; raises ValueError on escape."""
    if not raw:
        return None
    base = os.path.realpath(base_dir())
    resolved = os.path.realpath(os.path.join(base, raw))
    if resolved != base and not resolved.startswith(base + os.sep):
        raise ValueError(
            "dir must stay under the server's profile base directory "
            f"({base_dir()}); pass a relative subdirectory")
    return resolved


def _now_iso() -> str:
    return _dt.datetime.now(_dt.timezone.utc).isoformat(timespec="seconds")


def _artifact_listing(path: str) -> Tuple[List[str], int]:
    """(relative file paths, total bytes) under a capture directory."""
    files: List[str] = []
    total = 0
    for root, _dirs, names in os.walk(path):
        for name in names:
            full = os.path.join(root, name)
            try:
                total += os.path.getsize(full)
            except OSError:
                continue
            files.append(os.path.relpath(full, path))
    return sorted(files), total


def _write_metadata(entry: Dict[str, Any]) -> None:
    """capture.json next to the trace — the shared format for serving
    (/debug/profile) and training (pio train --profile)."""
    try:
        with open(os.path.join(entry["dir"], "capture.json"), "w",
                  encoding="utf-8") as f:
            json.dump(entry, f, indent=2, sort_keys=True)
    except OSError:
        logger.warning("could not write capture metadata under %s",
                       entry["dir"], exc_info=True)


def _profiler():
    """A torch.profiler session over the CPU and, where this process can
    see a card, the card (CUPTI records every thread's launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _reserve(label: str, requested_ms: Optional[int],
             capture_dir: Optional[str]) -> Dict[str, Any]:
    """Claim the single capture slot; the capture lands in
    ``capture_dir``, or in ``<base>/<capture id>`` when it is None."""
    global _active
    capture_id = f"{label}-{uuid.uuid4().hex[:8]}"
    entry = {
        "id": capture_id,
        "label": label,
        "startedAt": _now_iso(),
        "requestedMs": requested_ms,
        "state": "running",
        "dir": capture_dir or os.path.join(base_dir(), capture_id),
    }
    with _lock:
        if _active is not None:
            raise CaptureBusy(
                f"capture {_active['id']} is already running")
        _active = entry
    return entry


def _release() -> None:
    global _active
    with _lock:
        _active = None


def _start(entry: Dict[str, Any]):
    """Start the profiler on the calling thread; releases the slot and
    raises ValueError when it cannot start."""
    try:
        os.makedirs(entry["dir"], exist_ok=True)
        prof = _profiler()
        prof.start()
    except BaseException as e:
        _release()
        raise ValueError(f"could not start profiler trace: {e}") from e
    entry["_t0"] = time.perf_counter()
    return prof


def _finish(entry: Dict[str, Any], prof) -> Dict[str, Any]:
    """Stop ``prof`` (on the thread that started it), write the Chrome
    trace and capture.json, file the entry and free the slot. Finalized
    on a LOCAL copy: a concurrent GET reads the shared entry as
    "running" until the swap below, never a half-finished record."""
    global _active
    final = {k: v for k, v in entry.items() if not k.startswith("_")}
    try:
        import torch
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()   # let queued kernels land first
        prof.stop()
        prof.export_chrome_trace(os.path.join(final["dir"], TRACE_FILE))
        final["state"] = "done"
    except BaseException as e:   # must release the slot regardless
        final["state"] = "failed"
        final["error"] = f"{type(e).__name__}: {e}"
        logger.exception("profiler stop/export failed")
    final["durationMs"] = round(
        (time.perf_counter() - entry["_t0"]) * 1e3, 1)
    files, total = _artifact_listing(final["dir"])
    final["files"] = files
    final["bytes"] = total
    if final["state"] == "done" and not files:
        final["state"] = "empty"
    _write_metadata(final)
    with _lock:
        _active = None
        _captures.append(final)
        del _captures[:-_HISTORY]
    return final


def start_capture(ms: Optional[int] = None,
                  out_dir: Optional[str] = None,
                  label: str = "serve") -> Dict[str, Any]:
    """Start a bounded background capture; returns the running entry.
    The capture's own thread starts the profiler, sleeps
    ``min(ms, PIO_PROFILE_MAX_MS)``, stops it and files the artifact.
    Raises CaptureBusy / ValueError."""
    requested = DEFAULT_MS if ms is None else int(ms)
    if requested < 1:
        raise ValueError(f"ms must be >= 1, got {requested}")
    bounded = min(requested, max_ms())
    entry = _reserve(label, bounded, None)
    if out_dir:
        entry["dir"] = os.path.join(out_dir, entry["id"])
    started = threading.Event()
    failure: List[BaseException] = []

    def run() -> None:
        try:
            prof = _start(entry)
        except ValueError as e:
            failure.append(e)
            started.set()
            return
        started.set()
        time.sleep(bounded / 1e3)
        _finish(entry, prof)

    threading.Thread(target=run, name=f"pio-profile-{entry['id']}",
                     daemon=True).start()
    started.wait()
    if failure:
        raise failure[0]
    return {k: v for k, v in entry.items() if not k.startswith("_")}


class trace:
    """Context manager: a SYNCHRONOUS capture around a block (the
    ``pio train --profile DIR`` path), sharing the endpoint's
    single-capture guard and artifact format. ``capture_dir`` is used
    as-is (the operator named it), with capture.json written inside. The
    calling thread owns the profiler, so the block's CPU operators are
    in the trace beside its kernels."""

    def __init__(self, capture_dir: str, label: str = "train"):
        self.capture_dir = capture_dir
        self.label = label
        self._entry: Optional[Dict[str, Any]] = None
        self._prof = None

    def __enter__(self) -> "trace":
        entry = _reserve(self.label, None, self.capture_dir)
        self._prof = _start(entry)
        self._entry = entry
        return self

    def __exit__(self, *exc) -> None:
        if self._entry is not None:
            _finish(self._entry, self._prof)


def list_captures() -> Dict[str, Any]:
    """The ``GET /debug/profile`` payload: base dir, hard cap, the
    running capture (if any), and the recent history, newest first."""
    with _lock:
        active = ({k: v for k, v in _active.items()
                   if not k.startswith("_")}
                  if _active is not None else None)
        history = [dict(c) for c in reversed(_captures)]
    return {"dir": base_dir(), "maxMs": max_ms(),
            "active": active, "captures": history}


def get_capture(capture_id: str) -> Optional[Dict[str, Any]]:
    with _lock:
        if _active is not None and _active["id"] == capture_id:
            return {k: v for k, v in _active.items()
                    if not k.startswith("_")}
        for c in _captures:
            if c["id"] == capture_id:
                return dict(c)
    return None


def reset() -> None:
    """Forget capture history and force-release the slot (tests). If a
    capture is genuinely running this does NOT stop it — tests that
    started one must wait for it."""
    global _active
    with _lock:
        _active = None
        _captures.clear()


# ---------------------------------------------------------------------------
# route handler (telemetry.handle_route delegates /debug/profile here)
# ---------------------------------------------------------------------------

def handle_route(method: str, query: Optional[Dict[str, str]] = None):
    """(status, payload) for the /debug/profile endpoint on any daemon."""
    if method == "GET":
        return 200, list_captures()
    if method != "POST":
        return 405, {"message": "method not allowed"}
    if not post_enabled():
        return 403, {"message": "on-demand profiling is disabled "
                                "(PIO_PROFILE_ENABLE=0)"}
    q = query or {}
    raw_ms = q.get("ms", "")
    try:
        ms = int(raw_ms) if raw_ms else DEFAULT_MS
    except ValueError:
        return 400, {"message": f"ms must be an integer, got {raw_ms!r}"}
    try:
        out_dir = resolve_http_dir(q.get("dir"))
    except ValueError as e:
        return 400, {"message": str(e)}
    try:
        entry = start_capture(ms=ms, out_dir=out_dir)
    except CaptureBusy as e:
        return 409, {"message": str(e)}
    except ValueError as e:
        # bad ms, unwritable dir, or a profiler that cannot start: the
        # daemon stays healthy either way
        status = 400 if "ms must be" in str(e) else 503
        return status, {"message": str(e)}
    return 202, {"capture": entry,
                 "boundedMs": min(max(ms, 1), max_ms())}
