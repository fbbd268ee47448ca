"""Streaming ALS fold-in: events become servable factors in seconds (port
of ``predictionio_tpu/realtime/foldin.py``).

A user who signed up a minute ago has events in the store and nothing in
the model until the next ``pio train``. This module is the speed layer
that closes the gap:

- **Tail.** A worker follows the event store through a persistent cursor
  (``read_columns_since`` on the eventlog and SQLite stores, the
  object-shaped ``read_events_since`` on the memory store). The cursor
  and the fold bookkeeping persist atomically per tick, in the JSON
  layout the JAX package writes, so a crashed worker of either package
  resumes without skipping or double-counting an acknowledged event.

- **Solve.** One user's factors against a FIXED item matrix is one
  regularized least-squares solve: the training half-step applied to one
  row. :func:`foldin_solve` is ``ops.als.gram_rhs`` + ``_reg_vec`` +
  ``solve_factors`` on a batch of dirty users padded onto the declared
  user buckets (``PIO_FOLDIN_USER_BUCKETS``, default 1 / 8 / 64), each
  with ``PIO_FOLDIN_MAX_EVENTS`` (256) slots. On the card the solve is
  kernel A (``csrc/solve_gj.cu``) at n = the bucket; on the CPU its
  plain version. Each dirty user is re-solved from their full (capped)
  history, so a folded row equals a fresh half-step on the same rows,
  which is what the drift probe checks.

- **Publish.** Updated rows land in the LIVE serving model with no
  dropped query: the device-fp32 layout takes a new tensor
  (:func:`scatter_user_rows`) swapped in by one reference assignment;
  the int8 layout re-quantizes exactly the touched rows
  (``QuantizedServing.apply_user_rows``) and swaps a new
  ``QuantizedServing`` in the same way; the row-sharded layout routes
  each row to its owning slot (``ShardedFactors.apply_user_rows``, int8
  or fp32) and the new ``ShardedFactors`` swaps in as one reference;
  host numpy factors (the standalone runner's unserved model) take
  in-place row writes. New
  users append into headroom rows padded at deploy
  (:func:`pad_capacity`, ``PIO_FOLDIN_HEADROOM``), so shapes never
  change; when the headroom runs out, the worker falls back to the
  server's ``/reload`` and re-folds its pending users into the fresh
  headroom.

- **Items too.** Unseen items fold against the fixed user matrix and
  publish into item headroom (``PIO_FOLDIN_ITEM_HEADROOM``). A trained
  item's row is never overwritten: the batch solve stays authoritative.

- **Instrument.** ``pio_foldin_freshness_seconds`` (event ack to
  servable row), the cursor-lag gauge, the tick time, user and item
  outcome counters, two drift probes, and a ``foldin`` journal
  category, on ``GET /`` and ``/debug/device.json``.

``PIO_FOLDIN=0`` (the default is off;
``pio deploy --foldin on`` or ``PIO_FOLDIN=1`` opts in) keeps every
endpoint byte-identical.

``FoldinWorker.tick()`` is public and synchronous: tests and tools drive
it by hand, with no thread started and no sleep.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.common import devicewatch, journal, telemetry
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.ops.solve import solve_factors

logger = logging.getLogger("predictionio_tpu_torch.foldin")

#: buy events carry no rating property; the recommendation template maps
#: them to 4.0, so fold-in must agree with train
_BUY_RATING = 4.0

#: freshness histogram buckets (seconds, event ack -> servable factor)
_FRESHNESS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0,
                      30.0, 60.0, 300.0)


def _wall_now() -> float:
    # wall clock: ack timestamps are wall clock, and so is "lastTickAt"
    return _dt.datetime.now(_dt.timezone.utc).timestamp()


# ---------------------------------------------------------------------------
# mode resolution + knobs
# ---------------------------------------------------------------------------

def enabled(mode: str = "off") -> bool:
    """Is fold-in on for this deploy? ``PIO_FOLDIN`` overrides the
    ServerConfig mode (0 = off everywhere, 1 = on even for
    ``foldin="off"``)."""
    env = os.environ.get("PIO_FOLDIN", "")
    if env == "0":
        return False
    if env == "1":
        return True
    m = (mode or "off").lower()
    if m not in ("on", "off"):
        raise ValueError(f"foldin mode must be on/off, got {mode!r}")
    return m == "on"


def default_tick_ms() -> float:
    """Tick cadence when the caller pins none (``PIO_FOLDIN_TICK_MS``,
    default 250 ms)."""
    raw = os.environ.get("PIO_FOLDIN_TICK_MS", "")
    try:
        return max(float(raw), 1.0) if raw else 250.0
    except ValueError:
        return 250.0


def user_buckets() -> Tuple[int, ...]:
    """Dirty-row batch buckets (``PIO_FOLDIN_USER_BUCKETS``, default
    ``1,8,64``): each tick's solve pads onto the smallest bucket that
    fits, so kernel A runs at a few known shapes."""
    raw = os.environ.get("PIO_FOLDIN_USER_BUCKETS", "1,8,64")
    out = []
    for tok in raw.split(","):
        try:
            b = int(tok.strip())
        except ValueError:
            continue
        if b >= 1:
            out.append(b)
    return tuple(sorted(set(out))) or (1, 8, 64)


def max_events_per_user() -> int:
    """Per-row history cap (``PIO_FOLDIN_MAX_EVENTS``, default 256): the
    solve reads a row's most recent N rating events, and N is the
    per-row slot width of the padded solve batch."""
    raw = os.environ.get("PIO_FOLDIN_MAX_EVENTS", "")
    try:
        return max(int(raw), 1) if raw else 256
    except ValueError:
        return 256


def default_headroom() -> int:
    """User-row capacity padded at deploy (``PIO_FOLDIN_HEADROOM``,
    default 1024)."""
    raw = os.environ.get("PIO_FOLDIN_HEADROOM", "")
    try:
        return max(int(raw), 0) if raw else 1024
    except ValueError:
        return 1024


def default_item_headroom() -> int:
    """Item-row capacity padded at deploy (``PIO_FOLDIN_ITEM_HEADROOM``,
    default 1024)."""
    raw = os.environ.get("PIO_FOLDIN_ITEM_HEADROOM", "")
    try:
        return max(int(raw), 0) if raw else 1024
    except ValueError:
        return 1024


def drift_every() -> int:
    """Ticks between drift probes (``PIO_FOLDIN_DRIFT_EVERY``, default
    64; 0 disables the probe)."""
    raw = os.environ.get("PIO_FOLDIN_DRIFT_EVERY", "")
    try:
        return max(int(raw), 0) if raw else 64
    except ValueError:
        return 64


def drift_recall_floor() -> float:
    """recall@k below which a drift probe fails
    (``PIO_FOLDIN_DRIFT_RECALL_MIN``, default 0.99)."""
    try:
        return float(os.environ.get("PIO_FOLDIN_DRIFT_RECALL_MIN", "0.99"))
    except ValueError:
        return 0.99


def cursor_dir() -> str:
    """Where cursor files live (``PIO_FOLDIN_CURSOR_DIR``, else
    ``$PIO_FS_BASEDIR/foldin``)."""
    d = os.environ.get("PIO_FOLDIN_CURSOR_DIR", "")
    if d:
        return d
    basedir = os.path.expanduser(
        os.environ.get("PIO_FS_BASEDIR", "~/.pio_store"))
    return os.path.join(basedir, "foldin")


@dataclasses.dataclass
class FoldinConfig:
    """One worker's wiring: the app to tail, how the recommendation
    template maps events to ratings (its DataSource's mapping, so a fold
    sees exactly the rows a retrain would), and the tick cadence."""
    app_name: str
    channel_id: Optional[int] = None
    tick_ms: float = 250.0
    headroom: int = 1024
    item_headroom: int = 1024
    event_names: Tuple[str, ...] = ("rate", "buy")
    entity_type: str = "user"
    target_entity_type: str = "item"
    rating_property: str = "rating"
    buy_rating: float = _BUY_RATING
    lambda_: float = 0.01
    reg_scaling: str = "count"
    #: cursor-file namespace: the deploy's worker and the standalone
    #: `pio foldin` runner must not share a cursor
    namespace: str = "deploy"


def config_for(engine_params: Any, tick_ms: float = 0.0,
               headroom: Optional[int] = None,
               item_headroom: Optional[int] = None
               ) -> Optional[FoldinConfig]:
    """The worker config of a deployed engine: the app name from the
    datasource params, lambda from the first algorithm that has one, the
    tick from the caller (0 = ``PIO_FOLDIN_TICK_MS`` or 250 ms). None
    when the engine names no app."""
    dsp = getattr(engine_params, "data_source_params", None)
    app_name = getattr(dsp, "appName", None)
    if not app_name:
        return None
    lam = 0.01
    for _name, ap in getattr(engine_params, "algorithm_params_list", ()):
        got = getattr(ap, "lambda_", None)
        if got is not None:
            lam = float(got)
            break
    return FoldinConfig(
        app_name=str(app_name),
        tick_ms=float(tick_ms) if tick_ms else default_tick_ms(),
        headroom=default_headroom() if headroom is None else int(headroom),
        item_headroom=(default_item_headroom() if item_headroom is None
                       else int(item_headroom)),
        lambda_=lam)


# ---------------------------------------------------------------------------
# the solve: the training half-step applied to the tick's rows
# ---------------------------------------------------------------------------

def foldin_solve(
    item_rows: torch.Tensor,   # (nnz_pad, r) fp32 gathered other-side rows
    self_idx: torch.Tensor,    # (nnz_pad,) NONDECREASING batch-local row
    rating: torch.Tensor,      # (nnz_pad,) fp32 (0 in padding slots)
    counts: torch.Tensor,      # (n_self,) ratings per batch row
    lambda_: float,
    *,
    n_self: int,
    chunk: int,
    reg_scaling: str = "count",
) -> torch.Tensor:
    """One tick's fold-in: the explicit-ALS half-step on a padded batch,
    the training arithmetic exactly (``gram_rhs`` with presence weights,
    ALS-WR ``lambda * count`` regularization with one rating's floor for
    an empty pad row, ``solve_factors``: kernel A on the card).

    ``item_rows`` arrive pre-gathered (the worker gathers from its host
    fp32 copy), so the shapes depend only on the bucket and the history
    cap, never on the model. ``self_idx`` must be nondecreasing, padding
    slots at ``n_self``. Returns (n_self, r) on the inputs' device."""
    nnz = item_rows.shape[0]
    other_idx = torch.arange(nnz, device=item_rows.device)
    present = (self_idx < n_self).to(torch.float32)
    A, b = als.gram_rhs(item_rows, self_idx, other_idx, present, rating,
                        n_self, chunk)
    reg = als._reg_vec(counts, n_self, lambda_, reg_scaling)
    return solve_factors(A.contiguous(), b.contiguous(), reg)


def scatter_user_rows(U: torch.Tensor, ixs: torch.Tensor,
                      rows: torch.Tensor) -> torch.Tensor:
    """Fold-in publication for the device-fp32 layout: a NEW tensor with
    ``rows`` at ``ixs`` (in bounds of the padded capacity; duplicate
    indices carry identical rows). The caller publishes it with one
    reference swap, as the reference's ``.at[].set`` does."""
    return U.index_copy(0, ixs.to(device=U.device, dtype=torch.int64),
                        rows.to(device=U.device, dtype=U.dtype))


def solve_programs(rank: int, device: device_mod.DeviceLike = None,
                   reg_scaling: str = "count") -> List[Any]:
    """One warm-up program per user bucket (``serving/aot.py``): an
    all-padding batch of exactly the tick's shapes (zero Gram, the
    regularization floor: it solves to zero rows), so the first tick
    after ``/readyz`` builds and loads nothing and kernel A has run at
    every bucket."""
    from predictionio_tpu_torch.serving.aot import Program

    dev = device_mod.resolve(device)
    me = max_events_per_user()
    out: List[Any] = []
    for b in user_buckets():
        nnz_pad = b * me

        def run(b=b, nnz_pad=nnz_pad):
            return foldin_solve(
                torch.zeros((nnz_pad, rank), dtype=torch.float32,
                            device=dev),
                torch.full((nnz_pad,), b, dtype=torch.int64, device=dev),
                torch.zeros((nnz_pad,), dtype=torch.float32, device=dev),
                torch.zeros((b,), dtype=torch.int32, device=dev), 0.01,
                n_self=b, chunk=nnz_pad, reg_scaling=reg_scaling).cpu()

        out.append(Program("foldin_solve", run))
    return out


# ---------------------------------------------------------------------------
# capacity headroom (before prepare_serving, so every layout holds it)
# ---------------------------------------------------------------------------

def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def pad_capacity(models: Sequence[Any], headroom: int,
                 algorithms: Sequence[Any] = (),
                 item_headroom: Optional[int] = None
                 ) -> Optional[Dict[str, Any]]:
    """Append ``headroom`` zero rows to the first ALS-shaped model's user
    matrix and ``item_headroom`` to its item matrix: the capacity new
    users and items fold into without a shape change. Returns the record
    the worker binds against: the model index, host fp32 copies of both
    padded matrices (the solves' gather sources; the SAME objects the
    model now holds, so a quantized layout's host mirror stays in step),
    and the trained row counts. None when no model is ALS-shaped. Zero
    pad rows score 0, are never reached before a fold registers them
    (serving drops hits past the item vocab) and quantize to zeros with
    scale 1."""
    if item_headroom is None:
        item_headroom = default_item_headroom()
    for i, model in enumerate(models):
        U = getattr(model, "user_factors", None)
        V = getattr(model, "item_factors", None)
        if U is None or V is None \
                or getattr(model, "user_vocab", None) is None \
                or getattr(model, "item_vocab", None) is None:
            continue
        if len(np.shape(U)) != 2:
            continue
        U_host, V_host = _host_f32(U), _host_f32(V)
        trained = int(U_host.shape[0])
        padded = np.zeros((trained + max(int(headroom), 0),
                           U_host.shape[1]), dtype=np.float32)
        padded[:trained] = U_host
        model.user_factors = padded
        trained_items = int(V_host.shape[0])
        v_padded = np.zeros((trained_items + max(int(item_headroom), 0),
                             V_host.shape[1]), dtype=np.float32)
        v_padded[:trained_items] = V_host
        model.item_factors = v_padded
        lam = None
        if i < len(algorithms):
            lam = getattr(getattr(algorithms[i], "ap", None),
                          "lambda_", None)
        return {
            "index": i,
            "item_factors": v_padded,
            "user_factors": padded,
            "trained_users": trained,
            "trained_items": trained_items,
            "headroom": max(int(headroom), 0),
            "item_headroom": max(int(item_headroom), 0),
            "reg_scaling": "count",
            "lambda_": float(lam) if lam is not None else None,
        }
    return None


# ---------------------------------------------------------------------------
# event-store tails
# ---------------------------------------------------------------------------

class _ColumnarTail:
    """Cursor tail over ``read_columns_since`` (eventlog, SQLite)."""

    kind = "columnar"

    def __init__(self, events: Any, app_id: int, cfg: FoldinConfig):
        self._events = events
        self._app_id = app_id
        self._cfg = cfg

    def head(self):
        return self._events.head_cursor(self._app_id, self._cfg.channel_id)

    def lag(self, cursor) -> int:
        return int(self._events.cursor_lag(
            self._app_id, self._cfg.channel_id, cursor))

    def read(self, cursor):
        cfg = self._cfg
        new_cursor, cols = self._events.read_columns_since(
            self._app_id, cfg.channel_id, cursor,
            event_names=list(cfg.event_names),
            entity_type=cfg.entity_type,
            target_entity_type=cfg.target_entity_type,
            rating_property=cfg.rating_property)
        pool = cols["pool"]
        out = []
        for ent, tgt, evc, rat, cms in zip(
                cols["entity_code"].tolist(),
                cols["target_code"].tolist(),
                cols["event_code"].tolist(),
                cols["rating"].tolist(),
                cols["creation_ms"].tolist()):
            if ent < 0 or tgt < 0 or evc < 0:
                continue
            out.append((pool[ent], pool[tgt], pool[evc], rat, cms / 1e3))
        return new_cursor, out


class _ObjectTail:
    """Cursor tail over the object-shaped ``read_events_since`` (the
    memory store)."""

    kind = "object"

    def __init__(self, events: Any, app_id: int, cfg: FoldinConfig):
        self._events = events
        self._app_id = app_id
        self._cfg = cfg

    def head(self):
        return self._events.head_cursor(self._app_id, self._cfg.channel_id)

    def lag(self, cursor) -> int:
        return int(self._events.cursor_lag(
            self._app_id, self._cfg.channel_id, cursor))

    def read(self, cursor):
        cfg = self._cfg
        new_cursor, evs = self._events.read_events_since(
            self._app_id, cfg.channel_id, cursor)
        out = []
        names = set(cfg.event_names)
        for e in evs:
            if e.event not in names or e.entity_type != cfg.entity_type:
                continue
            if (e.target_entity_type != cfg.target_entity_type
                    or e.target_entity_id is None):
                continue
            v = e.properties.get_opt(cfg.rating_property) \
                if e.properties else None
            try:
                rat = float(v) if v is not None else float("nan")
            except (TypeError, ValueError):
                rat = float("nan")
            out.append((e.entity_id, e.target_entity_id, e.event, rat,
                        e.creation_time.timestamp()))
        return new_cursor, out


def tail_for(events: Any, app_id: int,
             cfg: FoldinConfig) -> Optional[Any]:
    """The incremental tail for this store, or None when it has neither
    surface (the worker then refuses to start, with a journal WARN)."""
    if hasattr(events, "read_columns_since"):
        return _ColumnarTail(events, app_id, cfg)
    if hasattr(events, "read_events_since"):
        return _ObjectTail(events, app_id, cfg)
    return None


# ---------------------------------------------------------------------------
# cursor persistence (crash-safe resume)
# ---------------------------------------------------------------------------

class CursorStore:
    """Atomic (tmp + rename) JSON persistence of the worker's cursor and
    its fold bookkeeping, in the JAX package's layout (either package
    resumes the other's file). The save follows a tick's folds, so a
    crash between read and save replays the window, and a replay is
    idempotent because every fold re-solves from the full history.
    ``folded`` rows persist too: a restarted deploy loads the TRAINED
    model, so everything folded since must fold again."""

    def __init__(self, app_id: int, channel_id: Optional[int],
                 namespace: str, directory: Optional[str] = None):
        d = directory or cursor_dir()
        os.makedirs(d, exist_ok=True)
        chan = f"_{channel_id}" if channel_id else ""
        self.path = os.path.join(d, f"app_{app_id}{chan}.{namespace}.json")

    def load(self) -> Optional[Dict[str, Any]]:
        try:
            with open(self.path, encoding="utf-8") as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (ValueError, OSError):
            logger.warning("foldin: unreadable cursor file %s; starting "
                           "from the live head", self.path)
            return None

    def save(self, cursor: Any, folded: Sequence[str],
             pending: Sequence[str],
             folded_items: Sequence[str] = (),
             pending_items: Sequence[str] = ()) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"cursor": cursor, "folded": sorted(folded),
                       "pending": sorted(pending),
                       "folded_items": sorted(folded_items),
                       "pending_items": sorted(pending_items)}, f)
        os.replace(tmp, self.path)


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

class FoldinWorker:
    """Tail -> solve -> publish, once per tick.

    One worker per deploy; :meth:`bind` points it at each new model
    generation (the initial deploy and every ``/reload``) and queues every
    folded row for re-fold into the fresh headroom, so each generation's
    answers come from one model and a new generation converges within a
    tick. :meth:`tick` is synchronous and public; :meth:`start` runs it on
    a daemon thread every ``tick_ms``. Solves run on ``device`` (the
    deploy's; the card unless the caller asks for the CPU)."""

    def __init__(self, storage: Any, config: FoldinConfig,
                 cursor_directory: Optional[str] = None,
                 device: device_mod.DeviceLike = None):
        self.config = config
        self.device = device_mod.resolve(device)
        self._events = storage.get_events()
        app = storage.get_meta_data_apps().get_by_name(config.app_name)
        if app is None:
            raise ValueError(f"foldin: app {config.app_name!r} not found")
        self.app_id = int(app.id)
        self._tail = tail_for(self._events, self.app_id, config)
        self._store = CursorStore(self.app_id, config.channel_id,
                                  config.namespace, cursor_directory)
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._reload_pending = False

        # model binding (set by bind())
        self._model: Any = None
        self._item_factors: Optional[np.ndarray] = None
        self._user_factors: Optional[np.ndarray] = None
        self._capacity = 0
        self._item_capacity = 0
        self.generation = 0
        self._reload_cb: Optional[Callable[[], None]] = None

        # bookkeeping
        self._cursor: Any = None
        self._folded: Dict[str, bool] = {}
        self._pending: Dict[str, bool] = {}
        self._item_folded: Dict[str, bool] = {}
        self._item_pending: Dict[str, bool] = {}
        self._ticks = 0
        self._events_seen = 0
        self._unknown_items = 0
        self._unknown_users = 0
        self._last_tick_s = 0.0
        self._last_tick_at = 0.0
        self._last_error = ""
        self._lag: Optional[int] = None
        self._freshness: deque = deque(maxlen=1024)
        self._recent: deque = deque(maxlen=64)   # drift-probe candidates
        self._recent_items: deque = deque(maxlen=64)
        self._drift: Optional[Dict[str, Any]] = None
        self._item_drift: Optional[Dict[str, Any]] = None

        saved = self._store.load()
        if saved is not None:
            self._cursor = saved.get("cursor")
            for u in saved.get("folded", []) + saved.get("pending", []):
                self._pending[u] = True
            for it in (saved.get("folded_items", [])
                       + saved.get("pending_items", [])):
                self._item_pending[it] = True

        reg = telemetry.registry()
        self._m_fresh = reg.histogram(
            "pio_foldin_freshness_seconds",
            "Event ack to servable factor: how stale a fold-in answer "
            "can be (realtime/foldin.py)",
            buckets=_FRESHNESS_BUCKETS).labels()
        self._m_lag = reg.gauge(
            "pio_foldin_cursor_lag_events",
            "Events between the fold-in cursor and the event-log head "
            "after the latest tick").labels()
        self._m_tick = reg.gauge(
            "pio_foldin_last_tick_seconds",
            "Wall-clock of the most recent fold-in tick (read + solve "
            "+ publish; ends in the result host transfer)").labels()
        self._m_users = reg.counter(
            "pio_foldin_users_total",
            "Fold-in user outcomes: folded (row updated), appended "
            "(new user into headroom), pending (deferred to the next "
            "tick/reload)", labelnames=("result",))
        self._m_ticks = reg.counter(
            "pio_foldin_ticks_total",
            "Fold-in ticks by outcome (ok/empty/error)",
            labelnames=("status",))
        self._m_drift = reg.gauge(
            "pio_foldin_drift_recall",
            "Most recent drift-probe recall@10: published fold-in rows "
            "vs a fresh half-step on the same events").labels()
        self._m_items = reg.counter(
            "pio_foldin_items_total",
            "Fold-in item outcomes: folded (row updated), appended "
            "(new item into item headroom), pending (deferred to the "
            "next tick/reload)", labelnames=("result",))
        self._m_item_drift = reg.gauge(
            "pio_foldin_item_drift_recall",
            "Most recent item drift-probe recall@10: published folded "
            "item rows vs a fresh transposed half-step on the same "
            "events").labels()

    # ------------------------------------------------------------- binding
    @property
    def supported(self) -> bool:
        return self._tail is not None

    def headroom_hint(self) -> int:
        """Headroom the NEXT load should pad: at least the configured
        value, and twice the users known to need re-folding (so the
        reload fallback cannot exhaust again at once)."""
        with self._lock:
            known = len(self._pending) + len(self._folded)
        return max(self.config.headroom, 2 * known)

    def item_headroom_hint(self) -> int:
        """The item side of :meth:`headroom_hint`."""
        with self._lock:
            known = len(self._item_pending) + len(self._item_folded)
        return max(self.config.item_headroom, 2 * known)

    def bind(self, model: Any, generation: int, prep: Dict[str, Any],
             reload_cb: Optional[Callable[[], None]] = None) -> None:
        """Point the worker at a freshly prepared model (the initial
        deploy or a ``/reload``). Every row folded into the PREVIOUS
        generation is queued for re-fold: the new generation starts from
        the trained factors."""
        with self._lock:
            for u in self._folded:
                self._pending[u] = True
            self._folded = {}
            for it in self._item_folded:
                self._item_pending[it] = True
            self._item_folded = {}
            self._model = model
            self._item_factors = np.asarray(prep["item_factors"],
                                            dtype=np.float32)
            uf = prep.get("user_factors")
            self._user_factors = (np.asarray(uf, dtype=np.float32)
                                  if uf is not None else None)
            self.generation = int(generation)
            self._reload_cb = reload_cb
            self._reload_pending = False
            self._capacity = self._resolve_capacity(model)
            self._item_capacity = int(self._item_factors.shape[0])
            if self._cursor is None:
                # first bind ever (no saved state): the training read
                # consumed everything before the head
                self._cursor = self._tail.head() if self._tail else None
        journal.emit(
            "foldin",
            (f"fold-in worker bound to generation {generation} "
             f"({len(self._pending)} user(s) and "
             f"{len(self._item_pending)} item(s) queued for re-fold, "
             f"capacity {self._capacity}u/{self._item_capacity}i)"),
            level=journal.INFO,
            generation=int(generation), capacity=int(self._capacity),
            itemCapacity=int(self._item_capacity),
            pending=len(self._pending),
            pendingItems=len(self._item_pending))
        self._note_state()

    def rebase(self, cursor: Any = None) -> None:
        """Reset the speed layer onto a NEW batch base: drop every folded
        and pending row and move the cursor to ``cursor`` (a retrain's
        training cursor) or the live head. The new model was trained
        through those events, so replaying them would apply them twice.
        Runs before :meth:`bind` re-points the worker."""
        with self._lock:
            dropped = (len(self._folded) + len(self._pending)
                       + len(self._item_folded) + len(self._item_pending))
            self._folded = {}
            self._pending = {}
            self._item_folded = {}
            self._item_pending = {}
            self._recent.clear()
            self._recent_items.clear()
            self._drift = None
            self._item_drift = None
            self._reload_pending = False
            self._cursor = cursor if cursor is not None else (
                self._tail.head() if self._tail else None)
            self._persist()
        journal.emit(
            "foldin",
            (f"fold-in rebased onto a new batch base ({dropped} "
             "folded/pending entr(ies) absorbed by the retrain; cursor "
             f"{'from training' if cursor is not None else 'at head'})"),
            level=journal.INFO, dropped=int(dropped),
            fromTraining=cursor is not None)
        self._note_state()

    @staticmethod
    def _resolve_capacity(model: Any) -> int:
        sharding = getattr(model, "sharding", None)
        if sharding is not None:
            return int(sharding.n_users)
        quant = getattr(model, "quant", None)
        if quant is not None:
            return int(quant.u_q.shape[0])
        return int(model.user_factors.shape[0])

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="pio-foldin", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=timeout)
        self._thread = None

    def _run(self) -> None:
        tick_s = max(self.config.tick_ms, 1.0) / 1e3
        while not self._stop.wait(tick_s):
            try:
                self.tick()
            except Exception as e:  # the loop must survive anything
                msg = f"{type(e).__name__}: {e}"
                self._m_ticks.labels(status="error").inc()
                if msg != self._last_error:
                    # journal once per distinct failure, not per tick
                    self._last_error = msg
                    logger.exception("foldin tick failed")
                    journal.emit("foldin", f"fold-in tick failed: {msg}",
                                 level=journal.WARN, error=msg)

    # ---------------------------------------------------------------- tick
    def tick(self) -> Dict[str, Any]:
        """One tail -> solve -> publish pass; returns a summary. Safe to
        call concurrently with serving, not with itself. The reload
        fallback runs after the worker's lock is released: the load it
        triggers re-binds this worker."""
        with self._lock:
            out = self._tick_locked()
            cb = None
            if self._reload_pending and self._reload_cb is not None:
                cb, self._reload_cb = self._reload_cb, None
                pending, capacity = len(self._pending), self._capacity
        if cb is not None:
            # headroom exhausted: fall back to the server's /reload,
            # which re-pads with our hints and re-binds us; the pending
            # rows re-fold on the next tick
            journal.emit(
                "foldin",
                "fold-in headroom exhausted; falling back to the "
                "/reload hot-swap with re-grown capacity",
                level=journal.WARN, pending=pending, capacity=capacity)
            cb()
            out["reloaded"] = True
        return out

    def _tick_locked(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        if self._tail is None or self._model is None:
            return {"folded": 0, "skipped": "unbound"}
        new_cursor, rows = self._tail.read(self._cursor)
        self._events_seen += len(rows)
        # freshness runs from each row's OLDEST unserved event
        acks: Dict[str, float] = {}
        dirty: Dict[str, bool] = {}
        item_acks: Dict[str, float] = {}
        dirty_items: Dict[str, bool] = {}
        item_vocab = self._model.item_vocab
        for uid, iid, _ev, _rat, ack_ts in rows:
            dirty[uid] = True
            acks[uid] = min(acks.get(uid, ack_ts), ack_ts)
            # an item is dirty only when training never saw it or it was
            # folded before: a trained row comes from the full batch
            # solve and is never overwritten by a half-step
            if item_vocab.get(iid) is None or iid in self._item_folded:
                dirty_items[iid] = True
                item_acks[iid] = min(item_acks.get(iid, ack_ts), ack_ts)
        for uid in self._pending:
            dirty.setdefault(uid, True)
        for iid in self._item_pending:
            dirty_items.setdefault(iid, True)
        if not dirty and not dirty_items:
            self._cursor = new_cursor
            self._persist()
            self._finish_tick(t0)
            self._m_ticks.labels(status="empty").inc()
            return {"folded": 0, "appended": 0, "events": len(rows)}

        # items fold FIRST, so a user solve of the same tick gathers the
        # freshly folded item rows (and resolves the new item's index)
        i_folded, i_appended, i_deferred = self._fold_items(
            list(dirty_items), item_acks)
        folded, appended, deferred = self._fold_users(list(dirty), acks)
        self._cursor = new_cursor
        self._persist()
        self._finish_tick(t0)
        self._ticks += 1
        self._m_ticks.labels(status="ok").inc()
        if drift_every() and self._ticks % drift_every() == 0:
            self._drift_probe()
            self._item_drift_probe()
        return {"folded": folded, "appended": appended,
                "deferred": deferred, "events": len(rows),
                "itemsFolded": i_folded, "itemsAppended": i_appended,
                "itemsDeferred": i_deferred}

    def _finish_tick(self, t0: float) -> None:
        dt = time.perf_counter() - t0
        self._last_tick_s = dt
        self._last_tick_at = _wall_now()
        self._m_tick.set(dt)
        try:
            lag = self._tail.lag(self._cursor)
        except Exception:
            lag = -1
        self._m_lag.set(float(max(lag, 0)))
        self._lag = lag
        self._note_state()

    # ------------------------------------------------------------- folding
    def _rating_value(self, e) -> Optional[float]:
        if e.event == "buy":
            return self.config.buy_rating
        v = e.properties.get_opt(self.config.rating_property) \
            if e.properties else None
        try:
            return float(v)
        except (TypeError, ValueError):
            return None

    def _gather_ratings(self, uid: str, item_vocab: Any
                        ) -> Tuple[List[Tuple[int, float]], int]:
        """The user's full (capped) rating history, item-vocab encoded:
        the rows a retrain's DataSource would give this user (buy -> 4.0,
        the most recent ``PIO_FOLDIN_MAX_EVENTS`` on overflow)."""
        cfg = self.config
        evs = list(self._events.find(
            self.app_id, channel_id=cfg.channel_id,
            entity_type=cfg.entity_type, entity_id=uid,
            event_names=list(cfg.event_names),
            target_entity_type=cfg.target_entity_type))
        evs.sort(key=lambda e: e.event_time)
        cap = max_events_per_user()
        if len(evs) > cap:
            evs = evs[-cap:]
        out: List[Tuple[int, float]] = []
        unknown = 0
        for e in evs:
            if e.target_entity_id is None:
                continue
            ix = item_vocab.get(e.target_entity_id)
            if ix is None:
                unknown += 1
                continue
            rv = self._rating_value(e)
            if rv is not None:
                out.append((int(ix), rv))
        return out, unknown

    def _gather_item_ratings(self, iid: str, user_vocab: Any
                             ) -> Tuple[List[Tuple[int, float]], int]:
        """The item's full (capped) rating history, user-vocab encoded:
        the transposed :meth:`_gather_ratings`. Events of users the model
        does not know yet are counted and skipped; once those users fold
        in, the item re-solves with them."""
        cfg = self.config
        evs = list(self._events.find(
            self.app_id, channel_id=cfg.channel_id,
            entity_type=cfg.entity_type,
            event_names=list(cfg.event_names),
            target_entity_type=cfg.target_entity_type,
            target_entity_id=iid))
        evs.sort(key=lambda e: e.event_time)
        cap = max_events_per_user()
        if len(evs) > cap:
            evs = evs[-cap:]
        out: List[Tuple[int, float]] = []
        unknown = 0
        for e in evs:
            ix = user_vocab.get(e.entity_id)
            if ix is None:
                unknown += 1
                continue
            rv = self._rating_value(e)
            if rv is not None:
                out.append((int(ix), rv))
        return out, unknown

    def _fold_users(self, uids: List[str],
                    acks: Dict[str, float]) -> Tuple[int, int, int]:
        model = self._model
        user_vocab = model.user_vocab
        work = []
        for uid in uids:
            ratings, unknown = self._gather_ratings(uid, model.item_vocab)
            self._unknown_items += unknown
            if not ratings:
                # nothing usable yet (unknown items only): drop it from
                # pending, there is nothing to fold
                self._pending.pop(uid, None)
                continue
            work.append((uid, user_vocab.get(uid), ratings))
        return self._fold(
            work, self._capacity, user_vocab, self._pending, self._folded,
            self._m_users, self._recent, acks, solve=self._solve,
            publish=lambda ixs, rows: self._publish(model, ixs, rows))

    def _fold_items(self, iids: List[str],
                    acks: Dict[str, float]) -> Tuple[int, int, int]:
        """The transposed half of :meth:`_fold_users`: each dirty item
        solved against the FIXED user matrix and published into the live
        item layout; a new item appends into the item headroom and grows
        the item vocab (row first, vocab second)."""
        if not iids:
            return 0, 0, 0
        model = self._model
        work = []
        for iid in iids:
            ratings, unknown = self._gather_item_ratings(iid,
                                                         model.user_vocab)
            self._unknown_users += unknown
            if not ratings:
                self._item_pending.pop(iid, None)
                continue
            work.append((iid, model.item_vocab.get(iid), ratings))
        return self._fold(
            work, self._item_capacity, model.item_vocab, self._item_pending,
            self._item_folded, self._m_items, self._recent_items, acks,
            solve=lambda lists: self._solve(lists,
                                            factors=self._user_factors),
            publish=lambda ixs, rows: self._publish_items(model, ixs, rows))

    def _fold(self, work, capacity: int, vocab, pending: Dict[str, bool],
              folded_set: Dict[str, bool], m_outcome, recent: deque,
              acks: Dict[str, float], *, solve, publish
              ) -> Tuple[int, int, int]:
        """Solve and publish ``work`` ((key, known index or None,
        ratings)) in batches of the largest bucket: known rows in place,
        new rows appended into the headroom while it lasts, the rest
        deferred (pending, with the reload fallback armed)."""
        max_batch = user_buckets()[-1]
        folded = appended = deferred = 0
        for at in range(0, len(work), max_batch):
            entries = []
            next_free = len(vocab)
            for key, known_ix, ratings in work[at:at + max_batch]:
                if known_ix is not None:
                    entries.append((key, int(known_ix), ratings, False))
                elif next_free < capacity:
                    entries.append((key, next_free, ratings, True))
                    next_free += 1
                else:
                    pending[key] = True
                    m_outcome.labels(result="pending").inc()
                    self._reload_pending = True
                    deferred += 1
            if not entries:
                continue
            rows = solve([ratings for _k, _ix, ratings, _new in entries])
            publish(np.asarray([ix for _k, ix, _r, _n in entries],
                               np.int64), rows)
            now = _wall_now()
            for key, ix, _ratings, is_new in entries:
                if is_new:
                    # row first, vocab second: a query resolves the new
                    # key only once its factors are live
                    vocab.add(key, int(ix))
                    appended += 1
                    m_outcome.labels(result="appended").inc()
                else:
                    folded += 1
                    m_outcome.labels(result="folded").inc()
                pending.pop(key, None)
                folded_set[key] = True
                recent.append(key)
                if key in acks:
                    fresh = max(now - acks[key], 0.0)
                    self._freshness.append(fresh)
                    self._m_fresh.observe(fresh)
        return folded, appended, deferred

    def _solve(self, rating_lists: List[List[Tuple[int, float]]],
               factors: Optional[np.ndarray] = None) -> np.ndarray:
        """The batch half-step for this tick's users, or with ``factors``
        the user matrix, the TRANSPOSED half-step for its items (the
        other side's rows arrive pre-gathered, so both sides run the same
        solve). Padded onto the smallest bucket; returns host (n, r)
        fp32 rows."""
        src = self._item_factors if factors is None else factors
        n = len(rating_lists)
        buckets = user_buckets()
        bucket = next((b for b in buckets if b >= n), buckets[-1])
        nnz_pad = bucket * max_events_per_user()
        lens = [len(r) for r in rating_lists]
        total = sum(lens)
        other = np.fromiter((ix for r in rating_lists for ix, _v in r),
                            np.int64, total)
        item_rows = np.zeros((nnz_pad, src.shape[1]), np.float32)
        item_rows[:total] = src[other]
        self_idx = np.full((nnz_pad,), bucket, np.int64)
        self_idx[:total] = np.repeat(np.arange(n, dtype=np.int64), lens)
        rating = np.zeros((nnz_pad,), np.float32)
        rating[:total] = np.fromiter(
            (v for r in rating_lists for _ix, v in r), np.float32, total)
        counts = np.zeros((bucket,), np.int32)
        counts[:n] = lens
        dev = self.device
        with devicewatch.attribution("foldin_solve", phase="foldin"):
            out = foldin_solve(
                torch.from_numpy(item_rows).to(dev),
                torch.from_numpy(self_idx).to(dev),
                torch.from_numpy(rating).to(dev),
                torch.from_numpy(counts).to(dev),
                float(self.config.lambda_), n_self=bucket, chunk=nnz_pad,
                reg_scaling=self.config.reg_scaling)
            # the host copy ends the device work of the tick
            return out[:n].cpu().numpy()

    # ------------------------------------------------------------- publish
    def _publish(self, model: Any, ixs: np.ndarray,
                 rows: np.ndarray) -> None:
        """Atomic row publication into the live serving layout. Each
        branch ends in ONE reference swap (or in-place row writes for
        host numpy), so a concurrent query sees the old rows or the new
        ones, never a torn mix, and none is dropped."""
        rows = np.asarray(rows, np.float32)
        mirror = self._user_factors
        if mirror is not None and mirror.shape[0] > int(ixs.max()):
            # the host fp32 mirror: the ITEM solves' gather source (for
            # the quantized and host layouts it IS model.user_factors)
            mirror[ixs] = rows
        sharding = getattr(model, "sharding", None)
        if sharding is not None:
            with devicewatch.attribution("foldin_publish", phase="foldin"):
                new = sharding.apply_user_rows(ixs, rows)
            model.sharding = new       # the swap queries dispatch on
            return
        quant = getattr(model, "quant", None)
        if quant is not None:
            with devicewatch.attribution("foldin_publish", phase="foldin"):
                new_q = quant.apply_user_rows(ixs, rows)
            uf = model.user_factors
            if isinstance(uf, np.ndarray) and uf.shape[0] > int(ixs.max()):
                uf[ixs] = rows         # the host fp32 copy (eval paths)
            model.quant = new_q        # the swap queries dispatch on
            return
        uf = model.user_factors
        if isinstance(uf, np.ndarray):
            uf[ixs] = rows
            return
        with devicewatch.attribution("foldin_publish", phase="foldin"):
            model.user_factors = scatter_user_rows(
                uf, torch.from_numpy(ixs), torch.from_numpy(rows))

    def _publish_items(self, model: Any, ixs: np.ndarray,
                       rows: np.ndarray) -> None:
        """The item side of :meth:`_publish`: the int8 layout
        re-quantizes exactly the touched item columns, device fp32
        scatters into a new tensor, host numpy writes in place; the
        worker's host item mirror (the USER solves' gather source) always
        updates."""
        rows = np.asarray(rows, np.float32)
        mirror = self._item_factors
        if mirror is not None and mirror.shape[0] > int(ixs.max()):
            mirror[ixs] = rows
        sharding = getattr(model, "sharding", None)
        if sharding is not None:
            with devicewatch.attribution("foldin_publish", phase="foldin"):
                new = sharding.apply_item_rows(ixs, rows)
            model.sharding = new
            return
        quant = getattr(model, "quant", None)
        if quant is not None:
            with devicewatch.attribution("foldin_publish", phase="foldin"):
                new_q = quant.apply_item_rows(ixs, rows)
            model.quant = new_q
            return
        vf = model.item_factors
        if isinstance(vf, np.ndarray):
            return                     # the mirror write above was it
        with devicewatch.attribution("foldin_publish", phase="foldin"):
            model.item_factors = scatter_user_rows(
                vf, torch.from_numpy(ixs), torch.from_numpy(rows))

    @staticmethod
    def _published_row(model: Any, ix: int) -> np.ndarray:
        """The user row a query ranks with, dequantized where int8."""
        sharding = getattr(model, "sharding", None)
        if sharding is not None:
            return sharding.user_row(ix)
        quant = getattr(model, "quant", None)
        if quant is not None:
            q = quant.u_q[ix].cpu().numpy()
            s = np.float32(quant.u_scale[ix].item())
            return q.astype(np.float32) * s
        uf = model.user_factors
        if isinstance(uf, np.ndarray):
            return uf[ix].copy()
        return uf[ix].cpu().numpy()

    @staticmethod
    def _published_item_row(model: Any, ix: int) -> np.ndarray:
        """The item row a query ranks with (the int8 layout serves the
        items TRANSPOSED)."""
        sharding = getattr(model, "sharding", None)
        if sharding is not None:
            return sharding.item_row(ix)
        quant = getattr(model, "quant", None)
        if quant is not None:
            q = quant.vt_q[:, ix].cpu().numpy()
            s = np.float32(quant.v_scale[ix].item())
            return q.astype(np.float32) * s
        vf = model.item_factors
        if isinstance(vf, np.ndarray):
            return vf[ix].copy()
        return vf[ix].cpu().numpy()

    # --------------------------------------------------------- drift probe
    def _probe(self, keys: deque, vocab, gather, other: np.ndarray,
               published, solve, sample: int, k: int) -> List[float]:
        """Recall@k of each sampled published row against a fresh
        half-step on the same events, ranked over ``other`` (on a catalog
        no larger than k, its top half)."""
        recalls: List[float] = []
        for key in list(dict.fromkeys(reversed(keys)))[:sample]:
            ix = vocab.get(key)
            if ix is None:
                continue
            ratings, _unknown = gather(key)
            if not ratings:
                continue
            fresh = solve([ratings])[0]
            pub = published(int(ix))
            kk = min(k, other.shape[0])
            if kk >= other.shape[0]:
                kk = max(other.shape[0] // 2, 1)
            top_f = np.argsort(-(other @ fresh), kind="stable")[:kk]
            top_p = np.argsort(-(other @ pub), kind="stable")[:kk]
            recalls.append(np.intersect1d(top_f, top_p).size / max(kk, 1))
        return recalls

    def _drift_probe(self, sample: int = 4, k: int = 10) -> None:
        """Published user rows against a fresh half-step on the same
        rows, compared as rankings over the item matrix (recall@k). A
        failed probe WARNs the journal."""
        model = self._model
        if self._item_factors is None:
            return
        recalls = self._probe(
            self._recent, model.user_vocab,
            lambda uid: self._gather_ratings(uid, model.item_vocab),
            self._item_factors,
            lambda ix: self._published_row(model, ix), self._solve,
            sample, k)
        if recalls:
            self._drift = self._verdict(recalls, self._m_drift, k, "")

    def _item_drift_probe(self, sample: int = 4, k: int = 10) -> None:
        """The transposed :meth:`_drift_probe`: published folded ITEM
        rows against a fresh transposed half-step, ranked over the user
        matrix."""
        model = self._model
        U = self._user_factors
        if U is None:
            return
        recalls = self._probe(
            self._recent_items, model.item_vocab,
            lambda iid: self._gather_item_ratings(iid, model.user_vocab),
            U, lambda ix: self._published_item_row(model, ix),
            lambda lists: self._solve(lists, factors=U), sample, k)
        if recalls:
            self._item_drift = self._verdict(recalls, self._m_item_drift,
                                             k, "ITEM ")

    def _verdict(self, recalls: List[float], gauge, k: int,
                 side: str) -> Dict[str, Any]:
        recall = float(np.mean(recalls))
        ok = recall >= drift_recall_floor()
        gauge.set(recall)
        if not ok:
            journal.emit(
                "foldin",
                (f"fold-in {side}drift probe FAILED: recall@{k} "
                 f"{recall:.4f} < {drift_recall_floor():.2f} floor "
                 "(published rows diverge from a fresh half-step)"),
                level=journal.WARN, recall=round(recall, 4),
                floor=drift_recall_floor(), sampled=len(recalls))
        verdict = {"recall": round(recall, 4), "ok": ok,
                   "sampled": len(recalls), "checkedAt": _wall_now()}
        self._note_state()
        return verdict

    # --------------------------------------------------------------- state
    def _persist(self) -> None:
        try:
            self._store.save(self._cursor, list(self._folded),
                             list(self._pending),
                             folded_items=list(self._item_folded),
                             pending_items=list(self._item_pending))
        except OSError:
            logger.warning("foldin: cursor persist failed at %s",
                           self._store.path, exc_info=True)

    def _freshness_pct(self, q: float) -> Optional[float]:
        if not self._freshness:
            return None
        return float(np.percentile(np.asarray(self._freshness), q))

    def state(self) -> Dict[str, Any]:
        """The fold-in block of ``GET /`` and ``/debug/device.json``."""
        with self._lock:
            model = self._model
            cap, icap = self._capacity, self._item_capacity
            used = len(model.user_vocab) if model is not None else 0
            iused = len(model.item_vocab) if model is not None else 0
            out: Dict[str, Any] = {
                "enabled": True,
                "backend": self._tail.kind if self._tail else None,
                "generation": self.generation,
                "tickMs": self.config.tick_ms,
                "ticks": self._ticks,
                "cursorLag": self._lag,
                "lastTickMs": round(self._last_tick_s * 1e3, 3),
                "lastTickAt": self._last_tick_at or None,
                "usersFolded": len(self._folded),
                "usersPending": len(self._pending),
                "itemsFolded": len(self._item_folded),
                "itemsPending": len(self._item_pending),
                "eventsSeen": self._events_seen,
                "unknownItems": self._unknown_items,
                "unknownUsers": self._unknown_users,
                "capacity": {"rows": cap, "used": used,
                             "headroomLeft": max(cap - used, 0)},
                "itemCapacity": {"rows": icap, "used": iused,
                                 "headroomLeft": max(icap - iused, 0)},
            }
            p50 = self._freshness_pct(50)
            p99 = self._freshness_pct(99)
            if p99 is not None:
                out["freshness"] = {"p50S": round(p50, 4),
                                    "p99S": round(p99, 4),
                                    "observed": len(self._freshness)}
            if self._drift is not None:
                out["drift"] = dict(self._drift)
            if self._item_drift is not None:
                out["itemDrift"] = dict(self._item_drift)
            return out

    def _note_state(self) -> None:
        try:
            devicewatch.note_foldin(self.state())
        except Exception:  # the debug surface must never fail a tick
            logger.debug("foldin: state note failed", exc_info=True)


# ---------------------------------------------------------------------------
# standalone runner (`pio foldin`)
# ---------------------------------------------------------------------------

def run_standalone(engine_dir: str = ".", variant: str = "engine.json",
                   engine_instance_id: Optional[str] = None,
                   tick_ms: float = 0.0, max_ticks: Optional[int] = None,
                   storage: Any = None, out=None) -> int:
    """Load the latest COMPLETED instance's model into THIS process, run
    the fold-in pipeline against the live event stream and report
    freshness, lag and drift: fold-in checked on a host without a serving
    fleet. Publication goes into the local model copy only; the cursor
    has its own ``standalone`` namespace, so a deploy's worker on the
    same store is never starved. Exit 0 on a clean run, 1 when the store
    has no incremental tail."""
    import builtins
    echo = out or builtins.print
    from predictionio_tpu_torch.data.storage import get_storage
    from predictionio_tpu_torch.workflow import model_io
    from predictionio_tpu_torch.workflow.create_server import (
        ServerConfig, engine_params_from_instance, resolve_engine_instance,
    )
    from predictionio_tpu_torch.workflow.workflow_utils import get_engine

    storage = storage or get_storage()
    instance = resolve_engine_instance(storage, ServerConfig(
        engine_instance_id=engine_instance_id,
        engine_dir=os.path.abspath(engine_dir)))
    engine = get_engine(instance.engine_factory,
                        base_dir=os.path.abspath(engine_dir))
    engine_params = engine_params_from_instance(engine, instance)
    blob = storage.get_model_data_models().get(instance.id)
    if blob is None:
        raise ValueError(f"No model data for EngineInstance {instance.id}")
    models = model_io.deserialize_models(blob.models)
    _, _, algorithms, _serving = engine._instantiate(engine_params)
    cfg = config_for(engine_params, tick_ms=tick_ms)
    if cfg is None:
        raise ValueError("engine is not fold-in-shaped (no datasource "
                         "appName)")
    cfg.namespace = "standalone"
    prep = pad_capacity(models, default_headroom(), algorithms)
    if prep is None:
        raise ValueError("no ALS-shaped model to fold into")
    if prep.get("lambda_") is not None:
        cfg.lambda_ = prep["lambda_"]
    worker = FoldinWorker(storage, cfg)
    if not worker.supported:
        echo("[ERROR] this event-store backend exposes no incremental "
             "tail")
        return 1
    worker.bind(models[prep["index"]], generation=1, prep=prep)
    echo(f"[INFO] fold-in soak on app {cfg.app_name!r} (instance "
         f"{instance.id}, tick {cfg.tick_ms:g} ms, capacity "
         f"{worker.state()['capacity']['rows']}); Ctrl-C to stop")
    tick_s = max(cfg.tick_ms, 1.0) / 1e3
    ticks = 0
    try:
        while max_ticks is None or ticks < max_ticks:
            summary = worker.tick()
            ticks += 1
            if summary.get("folded") or summary.get("appended") \
                    or ticks % max(int(2.0 / tick_s), 1) == 0:
                st = worker.state()
                fr = st.get("freshness") or {}
                echo(f"[INFO] tick {ticks}: folded="
                     f"{summary.get('folded', 0)} "
                     f"appended={summary.get('appended', 0)} "
                     f"lag={st.get('cursorLag')} "
                     f"freshness_p99_s={fr.get('p99S')}")
            if max_ticks is None or ticks < max_ticks:
                time.sleep(tick_s)
    except KeyboardInterrupt:
        pass
    st = worker.state()
    echo(f"[INFO] fold-in soak done: {st['usersFolded']} user(s) folded, "
         f"lag {st.get('cursorLag')}, drift "
         f"{(st.get('drift') or {}).get('recall')}")
    return 0
