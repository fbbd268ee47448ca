"""Multi-tenant model registry and admission control (port of
``predictionio_tpu/serving/registry.py``).

One ``pio deploy --engines conf.json`` process hosts N engine instances:

- :class:`TenantSpec` / :func:`load_engines_conf`: the ``--engines``
  conf file: which engine instance each tenant serves, its access key,
  its memory budget, and its private batcher-queue knobs.
- :class:`ServableModel`: one tenant's generation-versioned servable
  unit (engine, prepared models, serving and its own MicroBatcher,
  whose every flush runs one B1 + one B2 on the card).
- :class:`ModelRegistry`: the name -> ServableModel map. Generations
  are per tenant (a reload of tenant A never bumps B). Budgets are
  enforced at install: a tenant over its own soft budget is flagged
  (``pio doctor`` WARNs); a process past the hard cap
  (``PIO_TENANT_HBM_HARD_CAP_MB``) refuses the load. The hard cap is
  checked twice: :meth:`ModelRegistry.reserve` against the bytes the
  layout is projected to place (:func:`projected_serving_bytes`),
  before any tensor of the tenant reaches the card, and
  :meth:`ModelRegistry.install` against what it really holds.
- :class:`AdmissionController`: per-access-key admission resolved
  against the AccessKeys DAO (401 unknown key) with per-key token
  buckets (429 + Retry-After past the rate limit). The key -> tenant
  resolution happens once at the front of the request, and every
  downstream surface (serve histogram, SLO, waterfall) inherits the
  ``tenant`` label.

Tenants share built kernels but not queue capacity: each tenant's 503s
come out of its own ``batch_max_queue``.

:func:`model_hbm_bytes` counts what a servable keeps on its device: the
torch tensors of its prepared models (int8 items, scales and user rows
on the quantized path, once per storage), and a model's host arrays only
when it keeps no tensor (a host-only model, or factors not yet laid
out), so a host copy and its device copy are never both counted.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from predictionio_tpu_torch.common import journal, telemetry
from predictionio_tpu_torch.ops import quant as serve_quant
from predictionio_tpu_torch.parallel import serve_dist

__all__ = [
    "TenantSpec", "ServableModel", "ModelRegistry",
    "AdmissionError", "AdmissionController",
    "load_engines_conf", "model_hbm_bytes", "projected_serving_bytes",
]

#: the tenant name a no-``--engines`` (legacy single-engine) deploy
#: serves under — internal bookkeeping only; the legacy wire shape
#: never mentions it
DEFAULT_TENANT = "default"


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _env_opt_float(name: str) -> Optional[float]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


# ---------------------------------------------------------------------------
# tenant specs (--engines conf.json)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's slice of a multi-engine deploy: which trained
    instance it serves, the access key that routes to it, and its
    private capacity/budget knobs. Unset batching knobs inherit the
    deploy-wide ServerConfig values."""
    name: str
    access_key: Optional[str] = None
    engine_id: str = "default"
    engine_version: str = "NOT_USED"
    engine_variant: str = "default"
    engine_instance_id: Optional[str] = None
    engine_dir: Optional[str] = None
    #: per-tenant batcher knobs (None = inherit ServerConfig)
    batching: Optional[str] = None
    batch_max_size: Optional[int] = None
    batch_max_delay_ms: Optional[float] = None
    batch_max_queue: Optional[int] = None
    #: soft HBM budget in MiB (None = PIO_TENANT_HBM_BUDGET_MB or
    #: unbudgeted); exceeding it flags the tenant for the doctor WARN
    hbm_budget_mb: Optional[float] = None
    #: per-key token-bucket overrides (None = PIO_TENANT_RATE /
    #: PIO_TENANT_BURST; 0 rate = unlimited)
    rate: Optional[float] = None
    burst: Optional[float] = None


_CONF_KEYS = {
    "name": "name",
    "accessKey": "access_key",
    "engineId": "engine_id",
    "engineVersion": "engine_version",
    "engineVariant": "engine_variant",
    "engineInstanceId": "engine_instance_id",
    "engineDir": "engine_dir",
    "batching": "batching",
    "batchMaxSize": "batch_max_size",
    "batchMaxDelayMs": "batch_max_delay_ms",
    "batchMaxQueue": "batch_max_queue",
    "hbmBudgetMb": "hbm_budget_mb",
    "rate": "rate",
    "burst": "burst",
}


def parse_tenant_specs(obj: Any) -> Tuple[TenantSpec, ...]:
    """Parse the decoded ``--engines`` conf: either a bare list of
    tenant objects or ``{"tenants": [...]}``. Names must be unique and
    non-empty; access keys, when given, must be unique too (a key
    routes to exactly one tenant)."""
    if isinstance(obj, dict):
        obj = obj.get("tenants")
    if not isinstance(obj, list) or not obj:
        raise ValueError(
            "--engines conf must be a non-empty list of tenant objects "
            'or {"tenants": [...]}')
    specs: List[TenantSpec] = []
    for i, entry in enumerate(obj):
        if not isinstance(entry, dict):
            raise ValueError(f"--engines tenant #{i} is not an object")
        unknown = sorted(set(entry) - set(_CONF_KEYS))
        if unknown:
            raise ValueError(
                f"--engines tenant #{i}: unknown key(s) {unknown}; "
                f"expected a subset of {sorted(_CONF_KEYS)}")
        kwargs = {_CONF_KEYS[k]: v for k, v in entry.items()}
        name = str(kwargs.get("name") or "").strip()
        if not name:
            raise ValueError(f"--engines tenant #{i} has no name")
        kwargs["name"] = name
        specs.append(TenantSpec(**kwargs))
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"--engines tenant names are not unique: {names}")
    keys = [s.access_key for s in specs if s.access_key]
    if len(set(keys)) != len(keys):
        raise ValueError("--engines access keys are not unique; a key "
                         "must route to exactly one tenant")
    return tuple(specs)


def load_engines_conf(path: str) -> Tuple[TenantSpec, ...]:
    """Read + parse a ``--engines`` conf file."""
    with open(path, "r", encoding="utf-8") as f:
        try:
            obj = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"--engines conf {path} is not valid JSON: {e}")
    return parse_tenant_specs(obj)


# ---------------------------------------------------------------------------
# HBM accounting
# ---------------------------------------------------------------------------

def _walk_values(model: Any) -> List[Any]:
    """A model's attribute values (``__dict__`` and dataclass fields)."""
    attrs = getattr(model, "__dict__", None)
    values = list(attrs.values()) if isinstance(attrs, dict) else []
    if dataclasses.is_dataclass(model) and not isinstance(model, type):
        values.extend(getattr(model, f.name, None)
                      for f in dataclasses.fields(model))
    return values


def _host_bytes(models: Iterable[Any]) -> int:
    """The reference's walk: each model's attributes, one container
    level deep, summing ``.nbytes`` of every distinct array found."""
    total = 0
    seen: set = set()

    def add(x: Any) -> None:
        nonlocal total
        n = getattr(x, "nbytes", None)
        if isinstance(n, (int, float)) and not isinstance(x, (str, bytes)):
            if id(x) not in seen:
                seen.add(id(x))
                total += int(n)

    for model in models:
        if model is None:
            continue
        add(model)
        for v in _walk_values(model):
            add(v)
            if isinstance(v, dict):
                for vv in v.values():
                    add(vv)
            elif isinstance(v, (list, tuple)):
                for vv in v:
                    add(vv)
    return total


def _tensor_bytes(model: Any) -> int:
    """Bytes of the distinct tensor storages a prepared model keeps,
    searched through its serving layouts (a ``quant`` or ``sharding``
    object, their lists and dicts) down to a few levels."""
    import torch

    storages: Dict[Tuple[str, int], int] = {}
    seen: set = set()

    def visit(x: Any, depth: int) -> None:
        if x is None or id(x) in seen or depth > 4:
            return
        seen.add(id(x))
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            key = (str(x.device), st.data_ptr() or id(st))
            storages[key] = max(storages.get(key, 0), int(st.nbytes()))
            return
        if isinstance(x, (str, bytes, int, float, bool)) \
                or hasattr(x, "nbytes"):
            return
        if isinstance(x, dict):
            for v in x.values():
                visit(v, depth + 1)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v, depth + 1)
        else:
            for v in _walk_values(x):
                visit(v, depth + 1)

    visit(model, 0)
    return sum(storages.values())


def model_hbm_bytes(models: Iterable[Any]) -> int:
    """Bytes behind a tenant's prepared models: for each model, the
    tensors it keeps (its device layout) or, when it keeps none, the
    reference's host-array estimate. On host-array models this is the
    reference's number exactly."""
    total = 0
    for model in models:
        if model is None:
            continue
        dev = _tensor_bytes(model)
        total += dev if dev else _host_bytes([model])
    return total


def projected_serving_bytes(models: Iterable[Any], *, int8: bool) -> int:
    """What ``prepare_serving`` will place for these (host) models,
    computed before it runs, under the calling thread's deploy scopes:
    for a factor model (``user_factors`` and ``item_factors``) the byte
    count of the layout the scopes select, from the module that builds
    it (``serve_dist.layout_bytes`` when shard-serving resolves on, else
    ``quant.layout_bytes``); for any other model the host estimate."""
    sharded = serve_dist.serving_enabled()
    total = 0
    for model in models:
        if model is None:
            continue
        U = getattr(model, "user_factors", None)
        V = getattr(model, "item_factors", None)
        if U is None or V is None or len(getattr(U, "shape", ())) != 2:
            total += model_hbm_bytes([model])
            continue
        dims = (int(U.shape[0]), int(V.shape[0]), int(U.shape[1]))
        layout = serve_dist if sharded else serve_quant
        total += layout.layout_bytes(*dims, int8=int8)
    return total


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServableModel:
    """One tenant's generation-versioned servable unit — everything
    the query path snapshots per request. ``generation`` is stamped by
    :meth:`ModelRegistry.install`."""
    name: str
    spec: TenantSpec
    instance: Any
    engine: Any
    engine_params: Any
    algorithms: List[Any]
    models: List[Any]
    serving: Any
    batcher: Any = None
    aot_state: Optional[Dict[str, Any]] = None
    shard_state: Optional[Dict[str, Any]] = None
    quant_state: Optional[Dict[str, Any]] = None
    model_bytes: int = 0
    generation: int = 0
    over_budget: bool = False

    @property
    def hbm_budget_mb(self) -> Optional[float]:
        if self.spec.hbm_budget_mb is not None:
            return float(self.spec.hbm_budget_mb)
        return _env_opt_float("PIO_TENANT_HBM_BUDGET_MB")

    def queue_depth(self) -> int:
        return self.batcher.depth() if self.batcher is not None else 0

    def state(self) -> Dict[str, Any]:
        """The per-tenant block `GET /` and `pio doctor` read."""
        budget = self.hbm_budget_mb
        out: Dict[str, Any] = {
            "generation": self.generation,
            "instanceId": self.instance.id,
            "algorithms": [type(a).__name__ for a in self.algorithms],
            "queueDepth": self.queue_depth(),
            "modelBytes": self.model_bytes,
            "batching": self.batcher is not None,
        }
        if budget is not None:
            out["budgetMb"] = budget
            out["overBudget"] = self.over_budget
        return out


class ModelRegistry:
    """Name → :class:`ServableModel`, with per-tenant generations and
    load-time HBM budget enforcement. ``install`` of an existing name
    is the hot-swap: the new servable takes generation+1 and the old
    batcher is the caller's to drain."""

    def __init__(self, hard_cap_mb: Optional[float] = None):
        self._lock = threading.Lock()
        self._servables: Dict[str, ServableModel] = {}
        self._hard_cap_mb = (hard_cap_mb if hard_cap_mb is not None
                             else _env_opt_float("PIO_TENANT_HBM_HARD_CAP_MB"))

    @property
    def hard_cap_mb(self) -> Optional[float]:
        return self._hard_cap_mb

    def _check_cap(self, name: str, nbytes: int, what: str) -> None:
        """Raise when ``nbytes`` for ``name`` would take the process past
        the hard cap. Call with the lock held."""
        others = sum(s.model_bytes for n, s in self._servables.items()
                     if n != name)
        total_mb = (others + nbytes) / (1024 * 1024)
        if self._hard_cap_mb is not None and total_mb > self._hard_cap_mb:
            raise ValueError(
                f"tenant '{name}' load refused: process model bytes "
                f"{total_mb:.1f} MiB ({what}) would exceed the hard HBM "
                f"cap {self._hard_cap_mb:g} MiB "
                "(PIO_TENANT_HBM_HARD_CAP_MB)")

    def reserve(self, name: str, projected_bytes: int) -> None:
        """Refuse (ValueError) a load whose projected bytes would cross
        the hard cap: called before the tenant's layout is placed, so a
        refused tenant never allocates on the card."""
        with self._lock:
            self._check_cap(name, int(projected_bytes), "projected")

    def install(self, servable: ServableModel) -> ServableModel:
        """Stamp the next generation and publish the servable. Raises
        ValueError (load refused, previous generation keeps serving)
        when the process total of placed bytes would cross the hard
        cap. Returns the
        PREVIOUS servable of that name (None on first install) so the
        caller can drain its batcher."""
        name = servable.name
        budget = servable.hbm_budget_mb
        servable.over_budget = bool(
            budget is not None
            and servable.model_bytes > budget * 1024 * 1024)
        with self._lock:
            prior = self._servables.get(name)
            self._check_cap(name, servable.model_bytes, "placed")
            servable.generation = (prior.generation + 1) if prior else 1
            self._servables[name] = servable
        if servable.over_budget:
            journal.emit(
                "tenant",
                (f"tenant '{name}' is over its HBM budget: "
                 f"{servable.model_bytes / (1024 * 1024):.1f} MiB loaded "
                 f"vs {budget:g} MiB budgeted (soft — serving continues; "
                 "pio doctor WARNs)"),
                level=journal.WARN, tenant=name,
                modelBytes=servable.model_bytes, budgetMb=budget)
        return prior

    def get(self, name: str) -> Optional[ServableModel]:
        with self._lock:
            return self._servables.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._servables)

    def servables(self) -> List[ServableModel]:
        with self._lock:
            return [self._servables[n] for n in sorted(self._servables)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._servables)

    def generations(self) -> Dict[str, int]:
        with self._lock:
            return {n: s.generation
                    for n, s in sorted(self._servables.items())}

    def total_model_bytes(self) -> int:
        with self._lock:
            return sum(s.model_bytes for s in self._servables.values())

    def oversubscribed(self) -> List[str]:
        """Tenants over their soft budget (the doctor WARN list)."""
        with self._lock:
            return sorted(n for n, s in self._servables.items()
                          if s.over_budget)

    # ------------------------------------------------------------ collector
    def collect(self) -> Iterable[str]:
        """Scrape-time per-tenant gauges (registered on the metrics
        registry by the query server). Nothing until telemetry is on —
        wire parity with single-tenant deploys."""
        if not telemetry.on():
            return []
        servables = self.servables()
        if not servables:
            return []
        lines: List[str] = [
            "# TYPE pio_tenant_generation gauge",
            "# TYPE pio_tenant_queue_depth gauge",
            "# TYPE pio_tenant_model_bytes gauge",
        ]
        budget_lines: List[str] = []
        for s in servables:
            lines.append(
                f'pio_tenant_generation{{tenant="{s.name}"}} {s.generation}')
            lines.append(
                f'pio_tenant_queue_depth{{tenant="{s.name}"}} '
                f'{s.queue_depth()}')
            lines.append(
                f'pio_tenant_model_bytes{{tenant="{s.name}"}} '
                f'{s.model_bytes}')
            budget = s.hbm_budget_mb
            if budget is not None:
                budget_lines.append(
                    f'pio_tenant_hbm_budget_bytes{{tenant="{s.name}"}} '
                    f'{int(budget * 1024 * 1024)}')
        if budget_lines:
            lines.append("# TYPE pio_tenant_hbm_budget_bytes gauge")
            lines.extend(budget_lines)
        return lines


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

class AdmissionError(Exception):
    """Admission verdict: carries the HTTP status (401 unknown key,
    429 rate-limited) and an optional Retry-After value in seconds."""

    def __init__(self, status: int, message: str,
                 retry_after_s: Optional[int] = None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.retry_after_s = retry_after_s


class _TokenBucket:
    """Classic token bucket; ``rate`` tokens/s, ``burst`` capacity.
    Not thread-safe on its own — the controller serializes access."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self.last = time.monotonic()

    def take(self, now: Optional[float] = None) -> Optional[int]:
        """Take one token. Returns None on success, otherwise a
        Retry-After value in whole seconds (>= 1)."""
        now = time.monotonic() if now is None else now
        self.tokens = min(self.burst,
                          self.tokens + (now - self.last) * self.rate)
        self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return None
        need = (1.0 - self.tokens) / self.rate if self.rate > 0 else 1.0
        return max(1, int(need + 0.999))


class AdmissionController:
    """Per-access-key admission for the multi-tenant query server.

    ``admit(key)`` resolves key → app (AccessKeys DAO) → tenant (the
    app-id map built at load from each tenant's configured access key)
    and charges the key's token bucket. Raises :class:`AdmissionError`
    401 for a missing/unknown/unmapped key, 429 + Retry-After when the
    bucket is dry. Successful resolutions are cached (keys are
    append-mostly); unknown keys are re-checked against the DAO every
    time so a key created after deploy starts working immediately."""

    def __init__(self, storage: Any, tenant_by_appid: Dict[int, str],
                 rate: Optional[float] = None,
                 burst: Optional[float] = None,
                 tenant_limits: Optional[
                     Dict[str, Tuple[Optional[float],
                                     Optional[float]]]] = None):
        self._storage = storage
        self._tenant_by_appid = dict(tenant_by_appid)
        self._rate = (rate if rate is not None
                      else _env_float("PIO_TENANT_RATE", 0.0))
        self._burst = (burst if burst is not None
                       else _env_float("PIO_TENANT_BURST", 0.0))
        self._tenant_limits = dict(tenant_limits or {})
        self._lock = threading.Lock()
        self._key_tenant: Dict[str, str] = {}
        self._buckets: Dict[str, _TokenBucket] = {}

    def _limits_for(self, tenant: str) -> Tuple[float, float]:
        rate, burst = self._tenant_limits.get(tenant, (None, None))
        rate = self._rate if rate is None else float(rate)
        burst = self._burst if burst is None else float(burst)
        if burst <= 0:
            # default burst: 2 s of rate (at least 1)
            burst = max(1.0, 2.0 * rate)
        return rate, burst

    def resolve(self, key: Optional[str]) -> str:
        """Key → tenant name, no rate accounting. 401s unmapped keys."""
        if not key:
            raise AdmissionError(401, "Missing accessKey.")
        with self._lock:
            cached = self._key_tenant.get(key)
        if cached is not None:
            return cached
        row = self._storage.get_meta_data_access_keys().get(key)
        tenant = (self._tenant_by_appid.get(row.appid)
                  if row is not None else None)
        if tenant is None:
            raise AdmissionError(401, "Invalid accessKey.")
        with self._lock:
            self._key_tenant[key] = tenant
        return tenant

    def admit(self, key: Optional[str]) -> str:
        """Resolve AND charge the key's token bucket. Returns the
        tenant name; raises :class:`AdmissionError` otherwise."""
        tenant = self.resolve(key)
        rate, burst = self._limits_for(tenant)
        if rate <= 0:      # unlimited (the default)
            return tenant
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is None:
                bucket = self._buckets[key] = _TokenBucket(rate, burst)
            retry = bucket.take()
        if retry is not None:
            raise AdmissionError(
                429,
                f"access key rate limit exceeded ({rate:g} req/s); "
                "retry later", retry_after_s=retry)
        return tenant
