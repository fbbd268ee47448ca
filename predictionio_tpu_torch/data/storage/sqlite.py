"""SQLite storage backend — the file-backed default (port of
``predictionio_tpu/data/storage/sqlite.py``: events, apps, engine
instances and model blobs; the fold-in cursor and tail reads wait for the
fold-in slice).

The schema is the reference's, table for table, so a store that the JAX
package's ``pio app new``/``pio import``/``pio train`` filled reads here,
and the other way round.

One database file holds events + the metadata ledger + model blobs. Events
are rows with indexed filter columns plus the full JSON document; reads
reconstruct Event values (including nested properties) at millisecond time
precision — the canonical Event precision (joda DateTime parity).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import os
import re
import sqlite3
import threading
import uuid
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (
    App, EngineInstance, Model, NONE_FILTER,
)

_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


def _ck(channel_id):
    """The default (None) channel is stored as -1 so it can participate in
    the (id, app_id, channel_id) primary key."""
    return -1 if channel_id is None else channel_id


def _to_epoch_ms(t: _dt.datetime) -> int:
    if t.tzinfo is None:
        t = t.replace(tzinfo=_dt.timezone.utc)
    return int((t - _EPOCH).total_seconds() * 1000)


def _dt_to_iso(t: _dt.datetime) -> str:
    if t.tzinfo is None:
        t = t.replace(tzinfo=_dt.timezone.utc)
    return t.astimezone(_dt.timezone.utc).isoformat()


def _iso_to_dt(s: str) -> _dt.datetime:
    return _dt.datetime.fromisoformat(s)


class StorageClient:
    """Opens (or creates) the SQLite database file.

    Config keys: PATH (db file path; default <basedir>/pio.sqlite).
    """

    def __init__(self, config):
        self.config = config
        path = config.properties.get("PATH")
        if not path:
            path = os.path.join(config.properties.get("BASEDIR", "."), "pio.sqlite")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self.client = sqlite3.connect(path, check_same_thread=False)
        self.client.execute("PRAGMA journal_mode=WAL")
        self.lock = threading.RLock()


class _Sqlite:
    def __init__(self, client: StorageClient, config, namespace: str = ""):
        self._c = client.client
        self._lock = client.lock
        self._ns = namespace
        self._create_tables()

    def _create_tables(self):
        raise NotImplementedError

    def _exec(self, sql, params=()):
        with self._lock:
            cur = self._c.execute(sql, params)
            self._c.commit()
            return cur

    def _query(self, sql, params=()):
        with self._lock:
            return self._c.execute(sql, params).fetchall()


class SqliteEvents(_Sqlite, base.Events):
    def _create_tables(self):
        self._exec(
            """CREATE TABLE IF NOT EXISTS events (
                 id TEXT NOT NULL,
                 app_id INTEGER NOT NULL,
                 channel_id INTEGER NOT NULL DEFAULT -1,
                 event TEXT NOT NULL,
                 entity_type TEXT NOT NULL,
                 entity_id TEXT NOT NULL,
                 target_entity_type TEXT,
                 target_entity_id TEXT,
                 event_time_ms INTEGER NOT NULL,
                 doc TEXT NOT NULL,
                 PRIMARY KEY (id, app_id, channel_id))"""
        )
        self._exec(
            "CREATE INDEX IF NOT EXISTS idx_events_lookup ON events "
            "(app_id, channel_id, event_time_ms)"
        )
        self._exec(
            "CREATE INDEX IF NOT EXISTS idx_events_entity ON events "
            "(app_id, channel_id, entity_type, entity_id)"
        )

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        return True  # single-table schema created in ctor

    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        event_id = event.event_id or uuid.uuid4().hex
        stored = event.with_event_id(event_id)
        self._exec(
            "INSERT OR REPLACE INTO events VALUES (?,?,?,?,?,?,?,?,?,?)",
            (
                event_id, app_id, _ck(channel_id), stored.event,
                stored.entity_type, stored.entity_id,
                stored.target_entity_type, stored.target_entity_id,
                _to_epoch_ms(stored.event_time), stored.to_json(),
            ),
        )
        return event_id

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        rows, ids = [], []
        for event in events:
            event_id = event.event_id or uuid.uuid4().hex
            stored = event.with_event_id(event_id)
            ids.append(event_id)
            rows.append((
                event_id, app_id, _ck(channel_id), stored.event,
                stored.entity_type, stored.entity_id,
                stored.target_entity_type, stored.target_entity_id,
                _to_epoch_ms(stored.event_time), stored.to_json(),
            ))
        with self._lock:
            self._c.executemany(
                "INSERT OR REPLACE INTO events VALUES (?,?,?,?,?,?,?,?,?,?)", rows)
            self._c.commit()
        return ids

    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        limit: Optional[int] = None,
        reversed_: bool = False,
    ) -> Iterator[Event]:
        sql = ["SELECT doc FROM events WHERE app_id=? AND channel_id=?"]
        params: list = [app_id, _ck(channel_id)]
        if start_time is not None:
            sql.append("AND event_time_ms >= ?")
            params.append(_to_epoch_ms(start_time))
        if until_time is not None:
            sql.append("AND event_time_ms < ?")
            params.append(_to_epoch_ms(until_time))
        if entity_type is not None:
            sql.append("AND entity_type = ?")
            params.append(entity_type)
        if entity_id is not None:
            sql.append("AND entity_id = ?")
            params.append(entity_id)
        if event_names is not None:
            if not event_names:
                return iter(())  # empty filter list matches no events
            sql.append(
                "AND event IN (%s)" % ",".join("?" * len(event_names)))
            params.extend(event_names)
        for col, filt in (("target_entity_type", target_entity_type),
                          ("target_entity_id", target_entity_id)):
            if filt == NONE_FILTER:
                sql.append(f"AND {col} IS NULL")
            elif filt is not None:
                sql.append(f"AND {col} = ?")
                params.append(filt)
        sql.append("ORDER BY event_time_ms " + ("DESC" if reversed_ else "ASC"))
        if limit is not None and limit >= 0:
            sql.append("LIMIT ?")
            params.append(limit)
        rows = self._query(" ".join(sql), tuple(params))
        return (Event.from_json(r[0], validate=False) for r in rows)

    def read_columns(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        event_names: Optional[Sequence[str]] = None,
        entity_type: Optional[str] = None,
        target_entity_type: Optional[str] = None,
        rating_property: str = "rating",
    ) -> Dict[str, object]:
        """Columnar bulk read: one C-level SQL scan of the indexed filter
        columns + `json_extract` of the rating property, encoded against a
        synthesized string pool, so `pio train` against the sqlite backend
        takes store.find_columnar's vectorized path instead of
        materializing an Event object per row. The pool is the sorted
        distinct strings of this result set (dense-vocab assignment
        downstream treats ids as opaque). String-typed ratings ("4.5")
        coerce like the object path's float(); absent/NaN-able values
        become NaN."""
        sel = ("SELECT entity_id, target_entity_id, event, event_time_ms, "
               "{rating} FROM events WHERE app_id=? AND channel_id=?")
        where: List[str] = []
        params: list = [app_id, _ck(channel_id)]
        if event_names is not None:
            if not event_names:
                rows: list = []
                where = None
            else:
                where.append(
                    "AND event IN (%s)" % ",".join("?" * len(event_names)))
                params.extend(event_names)
        if where is not None:
            if entity_type is not None:
                where.append("AND entity_type = ?")
                params.append(entity_type)
            if target_entity_type is not None:
                where.append("AND target_entity_type = ?")
                params.append(target_entity_type)
            tail = " ".join([""] + where) if where else ""
            # json_extract path parameterization only survives simple
            # property names; anything else falls back to doc parsing
            simple = re.fullmatch(r"[A-Za-z0-9_\-]+", rating_property)
            rows = None
            if simple:
                try:
                    rows = self._query(
                        sel.format(rating="json_extract(doc, ?)") + tail,
                        tuple([f"$.properties.{rating_property}"]
                              + params))
                except sqlite3.OperationalError:
                    rows = None      # sqlite built without JSON1
            if rows is None:
                raw = self._query(sel.format(rating="doc") + tail,
                                  tuple(params))
                rows = []
                for ent, tgt, evt, tms, doc in raw:
                    try:
                        v = (json.loads(doc).get("properties") or {}).get(
                            rating_property)
                    except ValueError:
                        v = None
                    rows.append((ent, tgt, evt, tms, v))

        n = len(rows)
        rat = np.full(n, np.nan, np.float32)
        tms = np.empty(n, np.int64)
        strings = set()
        for j, (ent, tgt, evt, t, v) in enumerate(rows):
            tms[j] = t
            strings.add(ent)
            strings.add(evt)
            if tgt is not None:
                strings.add(tgt)
            if v is not None:
                try:
                    rat[j] = float(v)
                except (TypeError, ValueError):
                    pass
        pool = sorted(strings)
        code = {s: c for c, s in enumerate(pool)}
        return {
            "pool": pool,
            "entity_code": np.fromiter(
                (code[r[0]] for r in rows), np.int32, n),
            "target_code": np.fromiter(
                (code[r[1]] if r[1] is not None else -1 for r in rows),
                np.int32, n),
            "event_code": np.fromiter(
                (code[r[2]] for r in rows), np.int32, n),
            "rating": rat,
            "time_ms": tms,
        }


class SqliteApps(_Sqlite, base.Apps):
    def _create_tables(self):
        self._exec(
            "CREATE TABLE IF NOT EXISTS apps "
            "(id INTEGER PRIMARY KEY, name TEXT UNIQUE, description TEXT)")

    def insert(self, app: App) -> Optional[int]:
        with self._lock:
            try:
                if app.id == 0:
                    cur = self._c.execute(
                        "INSERT INTO apps (name, description) VALUES (?,?)",
                        (app.name, app.description))
                else:
                    cur = self._c.execute(
                        "INSERT INTO apps VALUES (?,?,?)",
                        (app.id, app.name, app.description))
                self._c.commit()
                return cur.lastrowid if app.id == 0 else app.id
            except sqlite3.IntegrityError:
                return None

    def get(self, app_id: int) -> Optional[App]:
        rows = self._query("SELECT id,name,description FROM apps WHERE id=?",
                           (app_id,))
        return App(*rows[0]) if rows else None

    def get_by_name(self, name: str) -> Optional[App]:
        rows = self._query("SELECT id,name,description FROM apps WHERE name=?",
                           (name,))
        return App(*rows[0]) if rows else None


def _ei_to_row(i: EngineInstance):
    return (
        i.id, i.status, _dt_to_iso(i.start_time), _dt_to_iso(i.end_time),
        i.engine_id, i.engine_version, i.engine_variant, i.engine_factory,
        i.batch, json.dumps(i.env), json.dumps(i.runtime_conf),
        i.data_source_params, i.preparator_params, i.algorithms_params,
        i.serving_params,
    )


def _row_to_ei(r) -> EngineInstance:
    return EngineInstance(
        id=r[0], status=r[1], start_time=_iso_to_dt(r[2]),
        end_time=_iso_to_dt(r[3]), engine_id=r[4], engine_version=r[5],
        engine_variant=r[6], engine_factory=r[7], batch=r[8],
        env=json.loads(r[9]), runtime_conf=json.loads(r[10]),
        data_source_params=r[11], preparator_params=r[12],
        algorithms_params=r[13], serving_params=r[14],
    )


class SqliteEngineInstances(_Sqlite, base.EngineInstances):
    def _create_tables(self):
        self._exec(
            """CREATE TABLE IF NOT EXISTS engine_instances (
                 id TEXT PRIMARY KEY, status TEXT, start_time TEXT,
                 end_time TEXT, engine_id TEXT, engine_version TEXT,
                 engine_variant TEXT, engine_factory TEXT, batch TEXT,
                 env TEXT, runtime_conf TEXT, data_source_params TEXT,
                 preparator_params TEXT, algorithms_params TEXT,
                 serving_params TEXT)""")

    def insert(self, i: EngineInstance) -> str:
        instance_id = i.id or uuid.uuid4().hex
        i = dataclasses.replace(i, id=instance_id)
        self._exec(
            "INSERT OR REPLACE INTO engine_instances VALUES "
            "(?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)", _ei_to_row(i))
        return instance_id

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        rows = self._query("SELECT * FROM engine_instances WHERE id=?",
                           (instance_id,))
        return _row_to_ei(rows[0]) if rows else None

    def get_all(self) -> List[EngineInstance]:
        return [_row_to_ei(r) for r in self._query("SELECT * FROM engine_instances")]

    def get_completed(self, engine_id, engine_version, engine_variant):
        rows = self._query(
            "SELECT * FROM engine_instances WHERE status='COMPLETED' AND "
            "engine_id=? AND engine_version=? AND engine_variant=? "
            "ORDER BY start_time DESC",
            (engine_id, engine_version, engine_variant))
        return [_row_to_ei(r) for r in rows]

    def get_latest_completed(self, engine_id, engine_version, engine_variant):
        rows = self.get_completed(engine_id, engine_version, engine_variant)
        return rows[0] if rows else None

    def update(self, i: EngineInstance) -> None:
        self._exec(
            "INSERT OR REPLACE INTO engine_instances VALUES "
            "(?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)", _ei_to_row(i))

    def delete(self, instance_id: str) -> None:
        self._exec("DELETE FROM engine_instances WHERE id=?", (instance_id,))


class SqliteModels(_Sqlite, base.Models):
    def _create_tables(self):
        self._exec("CREATE TABLE IF NOT EXISTS models "
                   "(id TEXT PRIMARY KEY, models BLOB)")

    def insert(self, m: Model) -> None:
        self._exec("INSERT OR REPLACE INTO models VALUES (?,?)",
                   (m.id, m.models))

    def get(self, model_id: str) -> Optional[Model]:
        rows = self._query("SELECT id, models FROM models WHERE id=?",
                           (model_id,))
        return Model(rows[0][0], bytes(rows[0][1])) if rows else None

    def delete(self, model_id: str) -> None:
        self._exec("DELETE FROM models WHERE id=?", (model_id,))
