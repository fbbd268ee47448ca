"""`pio profile` — capture a device profile from a LIVE daemon (port of
``predictionio_tpu/tools/profile.py``).

Drives the bounded on-demand capture endpoint (common/profiling.py,
served by every daemon next to /metrics):

    $ pio profile http://localhost:8000 --ms 2000 -o hot-replica
    capture serve-1a2b3c4d started (2000 ms, artifacts under
      /var/pio/profiles/hot-replica/serve-1a2b3c4d)
    capture done: 1 file(s), 480 KiB in
      /var/pio/profiles/hot-replica/serve-1a2b3c4d
      trace.json

Flow: POST /debug/profile?ms=N[&dir=...] (202, or 409 while another
capture runs), then poll GET /debug/profile until the capture leaves
the running state. The artifact stays on the SERVER's filesystem —
`-o` names a SUBDIRECTORY of the server's profile base
(`PIO_PROFILE_DIR` / `pio deploy --profile-dir`); the server refuses
(400) anything that escapes it. The daemon lists paths and sizes, it
never streams the trace through its request path. Open ``trace.json``
in Perfetto or chrome://tracing, exactly like a `pio train --profile
DIR` artifact (same layout, same capture.json metadata).

Exit code: 0 when the capture produced a non-empty artifact, 1 on an
empty/failed capture or a refused start, 2 when the daemon is
unreachable.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, Optional, Tuple


def _request(url: str, method: str = "GET",
             timeout: float = 5.0) -> Tuple[Optional[int], Any]:
    """(status, parsed JSON | error string)."""
    try:
        req = urllib.request.Request(url, data=b"" if method == "POST"
                                     else None, method=method)
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read().decode("utf-8"))
        except Exception:
            return e.code, {}
    except Exception as e:
        return None, f"{type(e).__name__}: {e}"


def _fmt_bytes(n: int) -> str:
    return f"{n / 1024:.0f} KiB" if n >= 1024 else f"{n} B"


def run_profile(base_url: str, ms: int = 2000,
                out_dir: Optional[str] = None, timeout: float = 5.0,
                out=None) -> int:
    """Start a capture against ``base_url``, wait for it, print the
    artifact listing; exit code 0 non-empty / 1 failed / 2 unreachable."""
    def say(msg: str) -> None:
        print(msg, file=out)

    base = base_url.rstrip("/")
    params = {"ms": str(int(ms))}
    if out_dir:
        params["dir"] = out_dir
    status, payload = _request(
        f"{base}/debug/profile?{urllib.parse.urlencode(params)}",
        method="POST", timeout=timeout)
    if status is None:
        say(f"pio profile: {base} unreachable ({payload})")
        return 2
    if status == 409:
        say(f"pio profile: refused — {payload.get('message', 'busy')}")
        return 1
    if status != 202:
        detail = (payload.get("message", "?")
                  if isinstance(payload, dict) else payload)
        say(f"pio profile: POST /debug/profile -> {status} ({detail})")
        return 1
    capture = payload["capture"]
    bounded = payload.get("boundedMs", ms)
    say(f"capture {capture['id']} started ({bounded} ms, artifacts "
        f"under {capture['dir']})")
    if bounded < ms:
        say(f"  (requested {ms} ms clamped by the server's "
            "PIO_PROFILE_MAX_MS cap)")

    # poll until the capture leaves "running"; budget = capture length
    # plus grace for trace serialization
    deadline = time.perf_counter() + bounded / 1e3 + max(timeout, 10.0)
    done: Optional[Dict[str, Any]] = None
    while time.perf_counter() < deadline:
        time.sleep(min(0.25, bounded / 1e3))
        status, listing = _request(f"{base}/debug/profile",
                                   timeout=timeout)
        if status != 200 or not isinstance(listing, dict):
            continue
        for c in listing.get("captures", []):
            if c.get("id") == capture["id"]:
                done = c
                break
        if done is not None:
            break
    if done is None:
        say("pio profile: capture did not complete in time "
            "(still listed as active?)")
        return 1
    files = done.get("files") or []
    if done.get("state") != "done" or not files:
        err = done.get("error") or ("no artifact files — is the backend "
                                    "dispatching anything?")
        say(f"pio profile: capture {done.get('state', '?')} ({err})")
        return 1
    say(f"capture done: {len(files)} file(s), "
        f"{_fmt_bytes(int(done.get('bytes', 0)))} in {done['dir']}")
    for f in files:
        say(f"  {f}")
    say("open trace.json with Perfetto (ui.perfetto.dev) or "
        "chrome://tracing")
    return 0
