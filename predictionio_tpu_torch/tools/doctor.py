"""`pio doctor` — one-screen operator verdict for a running daemon (port
of ``predictionio_tpu/tools/doctor.py``; stdlib only, the same verdict
and text for the same scrapes; the recompile line counts the port's
kernel builds, which devicewatch exposes under the reference's names).

Scrapes a daemon's observability surface (`/healthz`, `/readyz`,
`/metrics`, `/traces.json?limit=8`, `/debug/device.json`,
`/debug/slow.json?limit=3`, `/debug/events.json?level=warn&limit=8`)
and renders every check on one screen with a green/warn/red state —
including the SLO burn-rate verdict (common/slo.py: RED when the fast
window is alight), the latency waterfall's slowest sampled request,
and the flight recorder's recent WARN/RED events with ages (the
alarm -> timeline link; drill down with `pio events` / `pio trace`):

    $ pio doctor http://localhost:8000
    pio doctor — http://localhost:8000 (QueryAPI)
      health      ok    liveness probe answered
      readiness   ok    ready
      queue       ok    depth 0, 0 rejected (503) so far
      serving     ok    p99 <= 2.5 ms over 1280 queries
      breakers    ok    no circuit breaker open
      degraded    ok    0 tainted batches
      recompiles  ok    0 post-warmup XLA recompiles
      aot         ok    5 programs prebuilt (5 compiled, 0 cached — 0%
                        hit — in 0.3 s), ready in 0.4 s
      sharding    ok    8 shard(s), all_gather merge, 2.1 MiB
                        factors/shard, min per-device HBM headroom 84%
      quant       ok    int8 factors + per-row scales: 3.7 MiB vs
                        13.2 MiB fp32 (0.28x), fused Pallas kernel,
                        last recall gate 0.9975
      hbm         --    no device memory stats (CPU / unsupported)
      traces      ok    512 spans buffered
    VERDICT: OK

Exit code: 0 all green, 1 when any check is RED (open circuit breaker,
post-warmup serving recompiles, failed health/readiness, HBM nearly
exhausted), 2 when the daemon is unreachable. Warnings don't fail the
exit code — they are the "look here next" tier.

All reads are cheap and targeted: the trace read uses the `?limit=`
filter instead of dumping the ring, and every scrape is a single GET.
"""

from __future__ import annotations

import json
import re
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

#: check states, in escalation order
OK, WARN, RED, NA = "ok", "WARN", "RED", "--"

#: HBM fill ratios for the headroom check
_HBM_WARN = 0.80
_HBM_RED = 0.95

#: SLO burn-rate thresholds (common/slo.py, SRE Workbook ch. 5):
#: fast-window burn at page level is RED, slow-window at ticket level
#: is WARN
_FAST_BURN_RED = 14.4
_SLOW_BURN_WARN = 6.0
#: fold-in event-to-servable freshness gate (the bench's
#: foldin_freshness_p99 bound): a router response cache fronting a
#: fold-in backend with a TTL above this can serve staler than the
#: speed layer promises (KNOWN_ISSUES #17)
_FOLDIN_FRESHNESS_GATE_MS = 2000.0

_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$')

#: OpenMetrics exemplar suffix (waterfall stage histograms carry the
#: most recent trace id per bucket): stripped before sample parsing so
#: an exemplar-bearing line still yields its (name, labels, value)
_EXEMPLAR_RE = re.compile(r'\s+#\s+\{.*$')


def _fmt_bytes(n: float) -> str:
    """MiB for real models, KiB below 1 MiB — a 1.5 KB toy model must
    not render as '0.0 MiB'."""
    return (f"{n / 2**20:.1f} MiB" if n >= 2**20
            else f"{n / 2**10:.1f} KiB")


def parse_metrics(text: str) -> Dict[str, List[Tuple[str, float]]]:
    """Prometheus text exposition -> {name: [(labelstr, value), ...]}.
    Lenient by design (a doctor must diagnose, not crash on, a daemon
    whose exposition grew a series it doesn't know)."""
    out: Dict[str, List[Tuple[str, float]]] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(_EXEMPLAR_RE.sub("", line))
        if not m:
            continue
        name, labels, value = m.groups()
        try:
            v = float(value.replace("+Inf", "inf").replace("-Inf", "-inf"))
        except ValueError:
            continue
        out.setdefault(name, []).append((labels or "", v))
    return out


def metric_sum(samples: Dict[str, List[Tuple[str, float]]],
               name: str) -> Optional[float]:
    if name not in samples:
        return None
    return sum(v for _labels, v in samples[name])


def metric_max(samples: Dict[str, List[Tuple[str, float]]],
               name: str) -> Optional[float]:
    if name not in samples:
        return None
    return max(v for _labels, v in samples[name])


def histogram_quantile(samples: Dict[str, List[Tuple[str, float]]],
                       name: str, q: float) -> Optional[float]:
    """Approximate quantile (bucket upper bound) of `<name>` aggregated
    over every label set. Cumulative bucket counts sum safely across
    label sets because each set is itself cumulative in `le`."""
    buckets = samples.get(name + "_bucket")
    if not buckets:
        return None
    agg: Dict[float, float] = {}
    for labels, v in buckets:
        m = re.search(r'le="([^"]+)"', labels)
        if not m:
            continue
        le = float(m.group(1).replace("+Inf", "inf"))
        agg[le] = agg.get(le, 0.0) + v
    pts = sorted(agg.items())
    if not pts or pts[-1][1] <= 0:
        return None
    target = q * pts[-1][1]
    for le, cum in pts:
        if cum >= target:
            return le
    return pts[-1][0]


# ---------------------------------------------------------------------------
# scraping
# ---------------------------------------------------------------------------

def _get(base_url: str, path: str, timeout: float):
    """(status, body_text) or (None, error_string)."""
    url = base_url.rstrip("/") + path
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode("utf-8", "replace")
    except urllib.error.HTTPError as e:
        try:
            return e.code, e.read().decode("utf-8", "replace")
        except Exception:
            return e.code, ""
    except Exception as e:
        return None, f"{type(e).__name__}: {e}"


def scrape(base_url: str, timeout: float = 5.0) -> Dict[str, Any]:
    """Every surface the verdict reads, fetched once. ``root`` (GET /)
    feeds the router line — a fleet front door's membership, barrier
    and generation state lives in its status payload."""
    out: Dict[str, Any] = {"url": base_url}
    for key, path in (("healthz", "/healthz"), ("readyz", "/readyz"),
                      ("root", "/"),
                      ("metrics", "/metrics"),
                      ("traces", "/traces.json?limit=8"),
                      ("device", "/debug/device.json"),
                      ("slow", "/debug/slow.json?limit=3"),
                      ("history", "/debug/history.json?limit=24"),
                      ("events", "/debug/events.json?level=warn&limit=8")):
        status, body = _get(base_url, path, timeout)
        out[key] = {"status": status, "body": body}
    root = _json_body(out["root"]) or {}
    if root.get("router") and (root.get("cache") or {}).get("enabled"):
        # cache-enabled router: fetch each backend's own root so the
        # verdict can see a fold-in worker behind the cache (the
        # KNOWN_ISSUES #17 TTL-vs-freshness operator trap)
        out["backendRoots"] = [
            {"status": s, "body": b}
            for s, b in (_get(bk.get("url", ""), "/", timeout)
                         for bk in root.get("backends") or []
                         if bk.get("url"))]
    return out


def _json_body(part: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    if part.get("status") is None:
        return None
    try:
        obj = json.loads(part["body"])
        return obj if isinstance(obj, dict) else None
    except (ValueError, TypeError):
        return None


# ---------------------------------------------------------------------------
# diagnosis
# ---------------------------------------------------------------------------

def diagnose(scraped: Dict[str, Any]) -> List[Tuple[str, str, str]]:
    """-> [(check, state, detail)], every section always present."""
    checks: List[Tuple[str, str, str]] = []

    # health -----------------------------------------------------------
    hz = scraped["healthz"]
    if hz["status"] is None:
        checks.append(("health", RED, f"unreachable ({hz['body']})"))
    elif hz["status"] == 200:
        checks.append(("health", OK, "liveness probe answered"))
    else:
        checks.append(("health", RED, f"/healthz -> {hz['status']}"))

    # readiness --------------------------------------------------------
    rz = scraped["readyz"]
    rz_body = _json_body(rz) or {}
    if rz["status"] == 200:
        checks.append(("readiness", OK,
                       rz_body.get("status", "ready")))
    elif rz["status"] in (404, None):
        checks.append(("readiness", NA, "no /readyz on this daemon"))
    else:
        checks.append(("readiness", RED,
                       f"/readyz -> {rz['status']} "
                       f"({rz_body.get('status', '?')})"))

    samples = parse_metrics(scraped["metrics"]["body"]
                            if scraped["metrics"]["status"] == 200 else "")

    # a {"telemetry": false} device payload means PIO_TELEMETRY is
    # simply unset — NOT that the daemon lost its device stats; the
    # device-dependent checks below print the opt-in hint instead of
    # the misleading "missing" line
    device = _json_body(scraped["device"]) or {}
    telemetry_off = device.get("telemetry") is False
    _OPT_IN = ("telemetry off — run with --telemetry (PIO_TELEMETRY=1) "
               "to record {}")

    # queue ------------------------------------------------------------
    depth = metric_max(samples, "pio_batcher_queue_depth")
    rejected = metric_sum(samples, "pio_batcher_rejected_total")
    if depth is None and rejected is None:
        checks.append(("queue", NA, "no batcher on this daemon"))
    else:
        state = WARN if (rejected or 0) > 0 else OK
        checks.append(("queue", state,
                       f"depth {int(depth or 0)}, "
                       f"{int(rejected or 0)} rejected (503) so far"))

    # serving latency --------------------------------------------------
    p99 = histogram_quantile(samples, "pio_serve_seconds", 0.99)
    count = metric_sum(samples, "pio_serve_seconds_count")
    if p99 is None:
        checks.append(("serving", NA,
                       _OPT_IN.format("serve latency") if telemetry_off
                       else "no pio_serve_seconds yet (no queries served "
                            "so far)"))
    else:
        ms = "inf" if p99 == float("inf") else f"{p99 * 1e3:g}"
        checks.append(("serving", OK,
                       f"p99 <= {ms} ms over {int(count or 0)} queries"))

    # SLO burn (common/slo.py; Google-SRE multiwindow burn rates) ------
    burns: Dict[Tuple[str, str], float] = {}
    for labels, v in samples.get("pio_slo_burn_rate", []):
        slo_m = re.search(r'slo="([^"]+)"', labels)
        win_m = re.search(r'window="([^"]+)"', labels)
        if slo_m and win_m:
            burns[(slo_m.group(1), win_m.group(1))] = v
    if not burns:
        checks.append(("slo", NA,
                       _OPT_IN.format("SLO burn rates") if telemetry_off
                       else "no pio_slo_burn_rate series (old daemon?)"))
    else:
        # the SRE-Workbook multiwindow page condition: BOTH the fast
        # and the long window over the page threshold (the long window
        # keeps a lifetime blip from paging, the short one makes the
        # alert reset fast once the burn stops)
        fast_hot = {s for (s, w), v in burns.items()
                    if w == "fast" and v >= _FAST_BURN_RED
                    and burns.get((s, "slow"), v) >= _FAST_BURN_RED}
        slow_hot = {s for (s, w), v in burns.items()
                    if w == "slow" and v >= _SLOW_BURN_WARN}
        budgets = {}
        for labels, v in samples.get("pio_slo_error_budget_remaining", []):
            m = re.search(r'slo="([^"]+)"', labels)
            if m:
                budgets[m.group(1)] = v
        budget_txt = ", ".join(
            f"{s} budget {v * 100:.1f}%"
            for s, v in sorted(budgets.items())) or "no budget series"
        if fast_hot:
            detail = "; ".join(
                f"{s} burning {burns[(s, 'fast')]:.1f}x over the fast "
                "window" for s in sorted(fast_hot))
            checks.append(("slo", RED,
                           f"error budget ALIGHT: {detail} "
                           f"(>= {_FAST_BURN_RED:g}x pages; {budget_txt})"))
        elif slow_hot:
            detail = "; ".join(
                f"{s} burning {burns[(s, 'slow')]:.1f}x over the slow "
                "window" for s in sorted(slow_hot))
            checks.append(("slo", WARN, f"{detail} (>= "
                           f"{_SLOW_BURN_WARN:g}x is ticket-worthy; "
                           f"{budget_txt})"))
        else:
            checks.append(("slo", OK, f"within budget ({budget_txt})"))

    # router fleet front door (workflow/router.py) ---------------------
    root = _json_body(scraped.get("root", {})) or {}
    if root.get("router"):
        backends = root.get("backends") or []
        in_rot = sum(1 for b in backends if b.get("inRotation"))
        per = "; ".join(
            f"{b.get('url', '?')} "
            f"{'IN' if b.get('inRotation') else 'OUT'}"
            f" gen {b.get('generation', '?')}"
            f" breaker {b.get('breaker', '?')}"
            for b in backends)
        added_p99 = histogram_quantile(
            samples, "pio_router_overhead_seconds", 0.99)
        detail = f"{in_rot}/{len(backends)} in rotation ({per})"
        if added_p99 is not None:
            ms = ("inf" if added_p99 == float("inf")
                  else f"{added_p99 * 1e3:g}")
            detail += f", added-latency p99 <= {ms} ms"
        shed = root.get("shedCount") or 0
        if shed:
            detail += f", {shed} shed (503)"
        parts = root.get("partitions")
        gap = False
        if isinstance(parts, dict):
            owners = parts.get("owners") or {}
            ranges = "; ".join(
                f"p{i}=[{min(o['lo'] for o in os_)},"
                f"{max(o['hi'] for o in os_)})x{len(os_)}"
                for i, os_ in sorted(owners.items(),
                                     key=lambda kv: int(kv[0])) if os_)
            if parts.get("complete"):
                detail += (f", partition map {parts.get('count')} wide "
                           f"gen {parts.get('generation')} "
                           f"({ranges or 'no ranges'})")
            else:
                gap = True
        cache = root.get("cache")
        cache_cold = False
        if isinstance(cache, dict) and cache.get("enabled"):
            looked = (cache.get("hits") or 0) + (cache.get("misses") or 0)
            ratio = cache.get("hitRatio") or 0.0
            detail += (f", cache {cache.get('entries', 0)} entries "
                       f"hit-ratio {ratio:.1%}")
            # enabled but ~0% under real traffic: the keys are probably
            # unique per request (timestamps in the body?) or the TTL
            # is shorter than the key re-visit interval
            cache_cold = looked >= 20 and ratio < 0.01
        if gap:
            owners = (parts or {}).get("owners") or {}
            covered = sorted(owners.keys(), key=int)
            checks.append(("router", RED,
                           "partition COVERAGE GAP — partition replicas "
                           "are advertised but no complete same-"
                           "generation map is in rotation (covered "
                           f"indices: {covered or 'none'}); partition "
                           "queries answer 503, never a partial merge"))
        elif in_rot == 0:
            checks.append(("router", RED,
                           "NO backend in rotation — every query sheds "
                           f"503 ({per})"))
        elif root.get("generationSkew"):
            checks.append(("router", WARN,
                           detail + " — GENERATION SKEW "
                           f"{root.get('generations')}: a reload "
                           "barrier aborted partway; re-run POST "
                           "/reload (KNOWN_ISSUES #15)"))
        elif root.get("tenantGenerationSkew"):
            checks.append(("router", WARN,
                           detail + " — PER-TENANT GENERATION SKEW "
                           f"{root.get('tenantGenerationSkew')}: these "
                           "tenants serve different model generations "
                           "across the fleet; re-run POST /reload"))
        elif any(b.get("breaker") == "open" for b in backends):
            checks.append(("router", WARN,
                           detail + " — a backend breaker is open"))
        elif cache_cold:
            checks.append(("router", WARN,
                           detail + " — response cache is enabled but "
                           "~0% of lookups hit under traffic: query "
                           "bodies are probably unique per request, or "
                           "the TTL is below the key re-visit interval"))
        else:
            checks.append(("router", OK, detail))

        # KNOWN_ISSUES #17 mechanized: a response cache fronting a
        # fold-in-enabled backend must keep its TTL at or below the
        # fold-in freshness gate, or cached answers can outlive the
        # event-to-answer bound the speed layer promises
        if isinstance(cache, dict) and cache.get("enabled"):
            foldin_backends = [
                i for i, part in enumerate(
                    scraped.get("backendRoots") or [])
                if (_json_body(part) or {}).get("foldin") is not None]
            ttl_ms = float(cache.get("ttlMs") or 0.0)
            if foldin_backends and ttl_ms > _FOLDIN_FRESHNESS_GATE_MS:
                checks.append((
                    "router-cache", WARN,
                    f"cache TTL {ttl_ms:g} ms fronts "
                    f"{len(foldin_backends)} fold-in-enabled backend(s) "
                    f"but exceeds the {_FOLDIN_FRESHNESS_GATE_MS:g} ms "
                    "fold-in freshness gate — cached answers can serve "
                    "staler than the speed layer promises; lower "
                    "PIO_ROUTER_CACHE_TTL_MS or turn the cache off "
                    "(KNOWN_ISSUES #17)"))
            elif foldin_backends:
                checks.append((
                    "router-cache", OK,
                    f"cache TTL {ttl_ms:g} ms within the "
                    f"{_FOLDIN_FRESHNESS_GATE_MS:g} ms fold-in "
                    "freshness gate"))

        # autopilot (workflow/autopilot.py), embedded routers only -----
        ap = root.get("autopilot")
        if isinstance(ap, dict):
            mode = ap.get("mode", "?")
            last = ap.get("lastAction")
            detail = f"mode {mode}"
            if ap.get("ladderDepth"):
                detail += (f", degradation ladder depth "
                           f"{ap['ladderDepth']} (shed widened)")
            if ap.get("holdoff"):
                detail += ", HOLDING OFF (skew or reload barrier)"
            if last:
                detail += (f", last action {last.get('action', '?')} "
                           f"({last.get('outcome', '?')}) "
                           f"{last.get('ageS', '?')}s ago: "
                           f"{last.get('trigger', '')}")
            else:
                detail += ", no actions yet"
            cooling = ap.get("cooling") or []
            if cooling:
                detail += f", cooling: {', '.join(cooling)}"
            pending = ap.get("pendingDryRun") or 0
            if mode == "dry-run" and pending:
                checks.append((
                    "autopilot", WARN,
                    detail + f" — {pending} would-have action(s) "
                    "journaled but NOT applied; the loop believes the "
                    "fleet needs intervention (drop --dry-run to let "
                    "it act, or intervene by hand)"))
            else:
                checks.append(("autopilot", OK, detail))

    # autotrain (workflow/autotrain.py), embedded deploys/routers ------
    at = root.get("autotrain")
    if isinstance(at, dict):
        mode = at.get("mode", "?")
        last = at.get("lastDecision")
        detail = f"mode {mode}, phase {at.get('phase', '?')}"
        if at.get("retrainInFlight"):
            detail += ", retrain IN FLIGHT"
        if at.get("holdoff"):
            detail += ", HOLDING OFF (skew or reload barrier)"
        if last:
            detail += (f", last decision {last.get('trigger', '?')} "
                       f"({last.get('outcome', '?')}) "
                       f"{last.get('ageS', '?')}s ago")
        else:
            detail += ", no decisions yet"
        cand = at.get("lastCandidate")
        if cand:
            detail += (f", last candidate "
                       f"{'ACCEPTED' if cand.get('ok') else 'REJECTED'}"
                       f" ({cand.get('candidateId', '?')})")
        sig = at.get("signals") or {}
        thr = at.get("thresholds") or {}
        if sig.get("cursorLag") is not None:
            detail += (f", cursor lag {sig['cursorLag']}/"
                       f"{thr.get('lagEvents', '?')}")
        if sig.get("volume") is not None:
            detail += (f", volume {sig['volume']}/"
                       f"{thr.get('volumeEvents', '?')}")
        pending = at.get("pendingDryRun") or 0
        if mode == "dry-run" and pending:
            checks.append((
                "autotrain", WARN,
                detail + f" — {pending} would-have decision(s) "
                "journaled but NOT applied; the loop believes the "
                "model needs a retrain (drop --dry-run to let it "
                "train, or run pio train by hand)"))
        else:
            checks.append(("autotrain", OK, detail))

    # multi-tenant registry (serving/registry.py) ----------------------
    tenants = root.get("tenants")
    if isinstance(tenants, dict) and tenants:
        over = root.get("oversubscribed") or []
        for name in sorted(tenants):
            t = tenants[name] or {}
            detail = (f"gen {t.get('generation', '?')}, queue depth "
                      f"{t.get('queueDepth', '?')}, model "
                      f"{_fmt_bytes(float(t.get('modelBytes') or 0))}")
            budget = t.get("budgetMb")
            if budget is not None:
                used_mb = float(t.get("modelBytes") or 0) / (1024 * 1024)
                detail += (f" of {budget:g} MiB budget "
                           f"(headroom {budget - used_mb:.1f} MiB)")
            if t.get("overBudget"):
                checks.append((f"tenant:{name}", WARN,
                               detail + " — OVER BUDGET (soft cap; "
                               "load-time array-bytes estimate — "
                               "KNOWN_ISSUES #16)"))
            else:
                checks.append((f"tenant:{name}", OK, detail))
        cap = root.get("hbmHardCapMb")
        total_mb = float(root.get("modelBytesTotal") or 0) / (1024 * 1024)
        if over:
            checks.append(("tenants", WARN,
                           f"OVERSUBSCRIBED: {len(over)} tenant(s) over "
                           f"their HBM budget ({', '.join(over)}); "
                           "shrink a model, raise the budget, or move "
                           "a tenant to another replica "
                           "(KNOWN_ISSUES #16)"))
        else:
            cap_txt = (f", hard cap {cap:g} MiB" if cap else "")
            checks.append(("tenants", OK,
                           f"{len(tenants)} tenant(s), "
                           f"{total_mb:.1f} MiB total{cap_txt}, all "
                           "within budget"))

    # circuit breakers -------------------------------------------------
    open_eps = [labels for labels, v in
                samples.get("pio_breaker_open", []) if v >= 1]
    if open_eps:
        checks.append(("breakers", RED,
                       f"{len(open_eps)} circuit breaker(s) OPEN: "
                       + "; ".join(open_eps)))
    elif "pio_breaker_open" in samples:
        checks.append(("breakers", OK,
                       f"{len(samples['pio_breaker_open'])} breaker(s), "
                       "none open"))
    else:
        checks.append(("breakers", OK, "no circuit breaker open"))

    # degraded serving -------------------------------------------------
    tainted = metric_sum(samples, "pio_degraded_batches_total") or 0
    checks.append(("degraded", WARN if tainted > 0 else OK,
                   f"{int(tainted)} tainted batches (failed side-channel "
                   "lookups)" if tainted else "0 tainted batches"))

    # post-warmup recompiles (the devicewatch alarm) -------------------
    recompiles = metric_sum(samples,
                            "pio_xla_post_warmup_recompiles_total") or 0
    watchdog = device.get("watchdog") or {}
    if recompiles > 0:
        sigs = ", ".join(
            f"{e.get('fn')}[{e.get('signature')}]"
            for e in (watchdog.get("recentPostWarmup") or [])[-3:])
        checks.append(("recompiles", RED,
                       f"{int(recompiles)} post-warmup XLA recompiles on "
                       f"the serving path{' — ' + sigs if sigs else ''} "
                       "(padding-bucket regression?)"))
    else:
        armed = watchdog.get("servingWarmupDone")
        note = "" if armed is None else (
            " (watchdog armed)" if armed else " (still in warmup)")
        checks.append(("recompiles", OK,
                       f"0 post-warmup XLA recompiles{note}"))

    # time-to-ready / AOT prebuild (serving/aot.py) --------------------
    ttr = metric_max(samples, "pio_time_to_ready_seconds")
    by_status: Dict[str, float] = {}
    for labels, v in samples.get("pio_aot_programs_total", []):
        m = re.search(r'status="([^"]+)"', labels)
        if m:
            by_status[m.group(1)] = by_status.get(m.group(1), 0.0) + v
    aot_debug = device.get("aot") or {}
    if ttr is None and not by_status and not aot_debug:
        checks.append(("aot", NA,
                       "no AOT prebuild recorded (PIO_AOT=0, telemetry "
                       "off, or not an engine server)"))
    else:
        built = int(by_status.get("compiled", 0)
                    + by_status.get("primed", 0))
        memoized = int(by_status.get("memoized", 0))
        failed = int(by_status.get("failed", 0))
        total = built + memoized + failed
        prebuild_s = metric_max(samples, "pio_aot_prebuild_seconds")
        hit = (memoized / total * 100) if total else 0.0
        detail = (f"{total} programs prebuilt "
                  f"({built} compiled, {memoized} cached — "
                  f"{hit:.0f}% hit")
        if prebuild_s is not None:
            detail += f" — in {prebuild_s:.1f} s"
        detail += ")"
        if ttr is not None:
            detail += f", ready in {ttr:.1f} s"
        if failed:
            checks.append(("aot", RED,
                           f"{failed} AOT program build(s) FAILED "
                           "(compiling lazily on the latency path); "
                           + detail))
        elif ttr is not None and ttr >= 10.0:
            checks.append(("aot", WARN,
                           detail + " — over the 10 s warm-replica "
                           "target (cold cache? missing artifact?)"))
        else:
            checks.append(("aot", OK, detail))

    # sharded serving (parallel/serve_dist.py) -------------------------
    shards = metric_max(samples, "pio_serve_shards")
    shard_info = device.get("sharding") or {}
    if not (shards or 0) and not shard_info:
        checks.append(("sharding", NA,
                       _OPT_IN.format("the serving shard layout")
                       if telemetry_off
                       else "replicated serving (factors on one device)"))
    else:
        n = int(shards or shard_info.get("shards", 0) or 0)
        merge = shard_info.get("merge", "?")
        # per-device headroom: the sharded layout's failure mode is ONE
        # shard running out, so the min across devices is the verdict
        per_dev: Dict[str, Dict[str, float]] = {}
        for name, field in (("pio_hbm_bytes_in_use", "use"),
                            ("pio_hbm_bytes_limit", "limit")):
            for labels, v in samples.get(name, []):
                m = re.search(r'device="([^"]+)"', labels)
                if m:
                    per_dev.setdefault(m.group(1), {})[field] = v
        headrooms = [1.0 - d["use"] / d["limit"]
                     for d in per_dev.values()
                     if d.get("limit") and "use" in d]
        detail = f"{n} shard(s), {merge} merge"
        psb = shard_info.get("perShardFactorBytes")
        if psb:
            detail += f", {psb / 2**20:.1f} MiB factors/shard"
        if headrooms:
            min_head = min(headrooms)
            detail += (f", min per-device HBM headroom "
                       f"{min_head * 100:.0f}%")
            state = WARN if min_head < 0.10 else OK
            if state is WARN:
                detail += (" — a shard within 10% of HBM; grow the "
                           "mesh or shrink the model")
        else:
            detail += ", no per-device memory stats (CPU / unsupported)"
            state = OK
        checks.append(("sharding", state, detail))

    # quantized serving (ops/quant.py) ---------------------------------
    quant_info = device.get("quant") or {}
    quant_mode = metric_max(samples, "pio_serve_quant_mode")
    if not quant_info and not (quant_mode or 0):
        checks.append(("quant", NA,
                       _OPT_IN.format("the quantized-serving state")
                       if telemetry_off
                       else "fp32 factors (quantized serving off)"))
    elif quant_info.get("fellBack"):
        checks.append(("quant", WARN,
                       "quantized serving REQUESTED but fell back to "
                       "fp32 (recall probe below the floor, or the int8 "
                       "layout failed — see the deploy log); serving "
                       "costs 4x the HBM the operator asked for"))
    else:
        i8 = quant_info.get("int8Bytes") or 0
        f32 = quant_info.get("fp32Bytes") or 0
        detail = "int8 factors + per-row scales"
        if i8 and f32:
            detail += (f": {_fmt_bytes(i8)} vs {_fmt_bytes(f32)} "
                       f"fp32 ({i8 / f32:.2f}x)")
        if quant_info.get("sharded"):
            detail += f", sharded over {quant_info.get('shards', '?')}"
        elif quant_info.get("fused"):
            detail += (", fused Pallas kernel"
                       + (" (interpret)" if quant_info.get("interpret")
                          else ""))
        recall = quant_info.get("recall")
        if recall is None:
            recall = metric_max(samples, "pio_serve_quant_recall")
        if recall is not None:
            detail += f", last recall gate {recall:.4f}"
        checks.append(("quant", OK, detail))

    # realtime fold-in (realtime/foldin.py) ----------------------------
    foldin_info = device.get("foldin") or {}
    foldin_lag = metric_max(samples, "pio_foldin_cursor_lag_events")
    if not foldin_info and foldin_lag is None:
        checks.append(("foldin", NA,
                       _OPT_IN.format("the fold-in worker state")
                       if telemetry_off
                       else "fold-in off (batch-only serving; enable "
                            "with pio deploy --foldin)"))
    else:
        lag = foldin_info.get("cursorLag")
        if lag is None:
            lag = int(foldin_lag or 0)
        last_ms = foldin_info.get("lastTickMs")
        fresh = foldin_info.get("freshness") or {}
        drift = foldin_info.get("drift") or {}
        detail = f"cursor lag {lag}"
        if last_ms is not None:
            detail += f", last tick {last_ms:g} ms"
        if fresh.get("p99S") is not None:
            detail += f", freshness p99 {fresh['p99S']:g} s"
        if drift.get("recall") is not None:
            detail += (f", drift probe recall {drift['recall']:.4f}"
                       + ("" if drift.get("ok") else " FAILED"))
        item_drift = foldin_info.get("itemDrift") or {}
        if item_drift.get("recall") is not None:
            detail += (f", item drift probe recall "
                       f"{item_drift['recall']:.4f}"
                       + ("" if item_drift.get("ok") else " FAILED"))
        import datetime as _dtmod2
        now_ts = _dtmod2.datetime.now(
            _dtmod2.timezone.utc).timestamp()
        tick_ms = float(foldin_info.get("tickMs") or 250.0)
        last_at = foldin_info.get("lastTickAt")
        stale_after = max(10 * tick_ms / 1e3, 30.0)
        stale = (last_at is not None
                 and now_ts - float(last_at) > stale_after)
        # WARN, never RED: the fold-in line is a freshness advisory —
        # the live-state checks above own paging (PR 12 convention)
        if stale:
            checks.append(("foldin", WARN,
                           detail + f" — STALE: no tick for "
                           f"{now_ts - float(last_at):.0f} s (worker "
                           "wedged? event store unreachable?)"))
        elif ((drift and not drift.get("ok", True))
                or (item_drift and not item_drift.get("ok", True))):
            checks.append(("foldin", WARN,
                           detail + " — published rows diverge from a "
                           "fresh half-step (KNOWN_ISSUES #13); a "
                           "retrain will resync"))
        else:
            checks.append(("foldin", OK, detail))

    # HBM headroom -----------------------------------------------------
    in_use = metric_sum(samples, "pio_hbm_bytes_in_use")
    limit = metric_sum(samples, "pio_hbm_bytes_limit")
    if in_use is None or not limit:
        # two very different "no data" cases: telemetry simply not
        # opted into, vs a platform that genuinely reports no memory
        # stats (CPU; KNOWN_ISSUES #8)
        checks.append(("hbm", NA,
                       _OPT_IN.format("device memory stats")
                       if telemetry_off
                       else "no device memory stats (CPU / unsupported — "
                            "KNOWN_ISSUES #8)"))
    else:
        frac = in_use / limit
        state = RED if frac >= _HBM_RED else (
            WARN if frac >= _HBM_WARN else OK)
        detail = (f"{in_use / 2**30:.2f} / {limit / 2**30:.2f} GiB "
                  f"in use ({frac * 100:.0f}%)")
        # the headroom shown already reflects the quantized footprint
        # (memory_stats measures what is actually resident); say how
        # much of it quantization is saving so the number reads right
        i8 = quant_info.get("int8Bytes") or 0
        f32 = quant_info.get("fp32Bytes") or 0
        if not quant_info.get("fellBack") and i8 and f32 > i8:
            detail += (f" — int8 factors save "
                       f"{(f32 - i8) / 2**20:.1f} MiB vs fp32")
        checks.append(("hbm", state, detail))

    # host memory (the O(chunk) out-of-core claim's gauge) -------------
    host = device.get("hostMemory") or {}
    rss = host.get("rssBytes")
    if rss is None:
        checks.append(("host", NA,
                       _OPT_IN.format("host memory stats")
                       if telemetry_off
                       else "no /proc host memory stats (non-Linux)"))
    else:
        peak = host.get("peakRssBytes")
        total = host.get("memTotalBytes")
        detail = f"rss {_fmt_bytes(rss)}"
        if peak is not None:
            detail += f" (peak {_fmt_bytes(peak)})"
        state = OK
        if total:
            frac = rss / total
            detail += f" of {_fmt_bytes(total)} ({frac * 100:.0f}%)"
            # WARN only: nearing physical memory is an advisory — the
            # OOM killer's verdict, when it comes, is terminal anyway
            if frac >= 0.90:
                state = WARN
                detail += " — within 10% of physical memory"
        checks.append(("host", state, detail))

    # traces -----------------------------------------------------------
    tr = _json_body(scraped["traces"])
    if tr is None:
        checks.append(("traces", NA, "no /traces.json"))
    else:
        checks.append(("traces", OK,
                       f"{tr.get('spanCount', 0)} spans buffered "
                       f"(originate={'on' if tr.get('originate') else 'off'})"))

    # latency waterfall / slow ring (common/waterfall.py) --------------
    slow = _json_body(scraped.get("slow", {}))
    if slow is None:
        checks.append(("waterfall", NA, "no /debug/slow.json"))
    elif not slow.get("enabled"):
        checks.append(("waterfall", NA,
                       "sampling off — set PIO_WATERFALL=1 for "
                       "per-request stage breakdowns"))
    else:
        reqs = slow.get("requests") or []
        if reqs:
            top = reqs[0]
            top_stage = max((top.get("stages") or {"?": 0}).items(),
                            key=lambda kv: kv[1])
            checks.append(("waterfall", OK,
                           f"slowest sampled request {top.get('totalMs')}"
                           f" ms (mostly {top_stage[0]}, "
                           f"{top_stage[1]:g} ms; trace "
                           f"{top.get('traceId')})"))
        else:
            checks.append(("waterfall", OK,
                           "sampling on, no requests recorded yet"))

    # trend (common/history.py metrics flight recorder) ----------------
    # WARN only, by design: the point-in-time checks above own RED —
    # this line says which way the last few minutes were MOVING
    # (sustained p99 climb, QPS collapse) from the daemon's own rings
    hist = _json_body(scraped.get("history", {}))
    if hist is None:
        checks.append(("trend", NA, "no /debug/history.json "
                       "(old daemon?)"))
    elif not hist.get("enabled"):
        checks.append(("trend", NA,
                       "history off (PIO_HISTORY=0) — no trend data"))
    else:
        trend_state, trend_detail = _trend(hist)
        checks.append(("trend", trend_state, trend_detail))

    # recent operational events (common/journal.py flight recorder) ----
    # the alarm -> timeline link: the last WARN/RED journal entries with
    # ages, so every RED check above has its "when did this start"
    # evidence one line away (drill down: pio events --targets <url>)
    ev = _json_body(scraped.get("events", {}))
    if ev is None:
        checks.append(("events", NA,
                       "no /debug/events.json (old daemon?)"))
    elif not ev.get("enabled", False):
        checks.append(("events", NA,
                       "journal off (PIO_JOURNAL=0) — no operational "
                       "timeline"))
    else:
        entries = ev.get("events") or []
        if not entries:
            checks.append(("events", OK,
                           "no WARN/RED journal events recorded"))
        else:
            import datetime as _dtmod
            now = _dtmod.datetime.now(
                _dtmod.timezone.utc).timestamp()
            recent = entries[-3:]
            detail = "; ".join(
                f"[{e.get('level', '?')}] {e.get('category', '?')}: "
                f"{e.get('message', '')} ({_age(e.get('ts'), now)} ago)"
                for e in recent)
            # a RED event in the last 10 minutes is the "look here
            # next" tier — WARN, never RED: the live-state checks above
            # own paging (the breaker may have closed since)
            hot = any(e.get("level") == "red"
                      and now - (e.get("ts") or 0) < 600
                      for e in entries)
            checks.append(("events", WARN if hot else OK,
                           f"last {len(recent)} WARN/RED: {detail}"))
    return checks


#: trend thresholds: last-third p99 this much over the first third is
#: a sustained climb; last-entry QPS under this fraction of the
#: earlier median is a collapse
_TREND_P99_CLIMB = 2.0
_TREND_QPS_COLLAPSE = 0.2
#: points per third before the trend line speaks at all
_TREND_MIN_POINTS = 2


def _trend(hist: Dict[str, Any]) -> Tuple[str, str]:
    """(state, detail) for the trend check, from a history.json body."""
    from predictionio_tpu_torch.common import history as _hist
    samples = hist.get("samples") or []
    tick_s = float(hist.get("tickS") or 5.0)
    qps = _hist.count_points(samples, "pio_serve_seconds", tick_s)
    if not qps:
        qps = _hist.rate_points(samples, "pio_http_requests_total",
                                tick_s)
    p99 = _hist.quantile_points(samples, "pio_serve_seconds", 0.99)
    if not p99:
        p99 = _hist.quantile_points(samples, "pio_http_request_seconds",
                                    0.99)
    span_s = ((samples[-1]["t"] - samples[0]["t"]) / 1e3
              if len(samples) >= 2 else 0.0)
    if len(qps) < 3 * _TREND_MIN_POINTS and len(p99) < 3 * _TREND_MIN_POINTS:
        return NA, (f"{len(samples)} history tick(s) — not enough for "
                    "a trend yet")
    warns = []
    if len(p99) >= 3 * _TREND_MIN_POINTS:
        third = len(p99) // 3
        first = sum(v for _t, v in p99[:third]) / third
        last = sum(v for _t, v in p99[-third:]) / third
        if first > 0 and last / first >= _TREND_P99_CLIMB:
            warns.append(f"serve p99 climbing: {first * 1e3:.1f} ms -> "
                         f"{last * 1e3:.1f} ms over ~{span_s:.0f} s")
    if len(qps) >= 3 * _TREND_MIN_POINTS:
        earlier = sorted(v for _t, v in qps[:-_TREND_MIN_POINTS])
        med = earlier[len(earlier) // 2]
        recent = sum(v for _t, v in qps[-_TREND_MIN_POINTS:]) \
            / _TREND_MIN_POINTS
        if med > 0 and recent <= med * _TREND_QPS_COLLAPSE:
            warns.append(f"QPS collapsed: ~{med:.1f}/s -> "
                         f"{recent:.1f}/s")
    if warns:
        return WARN, ("; ".join(warns)
                      + " — pio incident --targets <url> for the "
                      "timeline")
    return OK, (f"steady over ~{span_s:.0f} s "
                f"({len(samples)} tick(s))")


def _age(ts: Optional[float], now: float) -> str:
    if not ts:
        return "?"
    from predictionio_tpu_torch.common.traceview import age_str
    return age_str(float(ts), now=now)


def render(scraped: Dict[str, Any],
           checks: List[Tuple[str, str, str]]) -> str:
    service = ""
    hz = _json_body(scraped.get("healthz", {}))
    dv = _json_body(scraped.get("device", {})) or {}
    if hz is not None and dv.get("telemetry") is False:
        service = " (telemetry off — run the daemon with --telemetry " \
                  "for device checks)"
    lines = [f"pio doctor — {scraped['url']}{service}"]
    width = max(len(c) for c, _s, _d in checks)
    for check, state, detail in checks:
        lines.append(f"  {check.ljust(width)}  {state:<4}  {detail}")
    reds = sum(1 for _c, s, _d in checks if s == RED)
    warns = sum(1 for _c, s, _d in checks if s == WARN)
    if reds:
        lines.append(f"VERDICT: RED ({reds} failing check(s)"
                     + (f", {warns} warning(s)" if warns else "") + ")")
    elif warns:
        lines.append(f"VERDICT: OK with {warns} warning(s)")
    else:
        lines.append("VERDICT: OK")
    return "\n".join(lines)


def run_doctor(base_url: str, timeout: float = 5.0,
               out=None) -> int:
    """Scrape, diagnose, print; exit code 0 green / 1 red / 2 dead."""
    scraped = scrape(base_url, timeout=timeout)
    checks = diagnose(scraped)
    text = render(scraped, checks)
    print(text, file=out)
    if scraped["healthz"]["status"] is None:
        return 2
    return 1 if any(s == RED for _c, s, _d in checks) else 0


def run_doctor_fleet(targets: List[str], timeout: float = 5.0,
                     out=None) -> int:
    """`pio doctor --targets url,...`: one verdict per fleet member
    (router, replicas, storage — the router is just one more daemon
    here), separated by a blank line; the exit code is the WORST member
    (2 unreachable > 1 red > 0 green)."""
    worst = 0
    for k, url in enumerate(targets):
        if k:
            print("", file=out)
        worst = max(worst, run_doctor(url, timeout=timeout, out=out))
    return worst
